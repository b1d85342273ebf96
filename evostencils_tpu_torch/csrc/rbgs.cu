// Standalone smoother sweeps of a constant 5-point operator for Hopper
// (sm_90a), float32.
//
// es_fused_rbgs_sweep replaces the TPU kernel
//   evostencils_tpu/ops/pallas/rbgs.py fused_rbgs_sweep (_fused_rb_kernel):
//   one damped red-black Gauss-Seidel sweep, the red half-sweep and then
//   the black one, in one pass over u and b.
// es_sweep replaces
//   evostencils_tpu/ops/pallas/rbgs.py jacobi_sweep / rbgs_sweep
//   (_sweep_kernel): one pass that updates every point from the old u
//   (parity -1, a damped Jacobi sweep) or only the points of one colour
//   (parity 0 red, 1 black; rbgs_sweep runs parity 0 and then 1).
//
// Both compute, at each updated point, the TPU kernels' update
//   u + (omega * dinv) * (b - A u)
// summing A u in the order of the kernel they replace: the fused sweep as
// c*u + (((c_up*up + c_dn*dn) + c_lf*lf) + c_rt*rt) (transfer.py:621-626),
// the single pass as (((c*u + c_up*up) + c_dn*dn) + c_lf*lf) + c_rt*rt
// (rbgs.py:77).  Red is an even sum of interior indices (interior index i
// is node i+1 on both axes, which leaves the parity unchanged).  Points
// outside the grid are 0 and never updated.  The relaxation factor is read
// from the device vector by index, so no launch waits on the host.
//
// What bounds them: device-memory bytes.  A sweep must read u and b once
// and write u once (12 bytes a point); it does about a dozen flops a point.
//
// es_sweep (sweep_kernel<ONE>) writes a buffer it does not read, so that
// parity -1 sees only the old u; a pass of one colour is exact in the same
// way, because every neighbour of a point has the other colour.  Each
// thread owns a strip of STRIP rows of one column: it loads u on the strip
// and one row beyond each end, so each value crosses device memory once a
// strip plus the two end rows, and b on the rows it updates, all before
// its arithmetic (3 * STRIP / 2 + 2 loads in flight a thread); up and down
// roll through registers; left and right come from the lanes beside it by
// warp shuffles, with one load a row at each warp edge.  omega * dinv is
// formed once a thread.  In a single-colour pass (ONE) a strip holds both
// colours and lanes beside each other differ in column parity, so every
// lane updates every other row of its strip (rows d, d + 2, ..., d its
// first of the colour), copies the others to out, and sends its copied
// row to its neighbours, which is their updated one: no lane idles, and b
// is read only where a point updates.  Strips of 4 rows in blocks of 128 x
// 2 threads, 40 registers, six blocks an SM (1023^2 makes 1,024 blocks,
// about 1.3 waves of 132 SMs); on the H100 this was the fastest of the
// strips of 2, 4, 6, 8 and 16 rows and the five blocks tried, or within
// 0.0003 ms of it at every level (PERF.md section 6).
// es_sweep_info reports it from the card, and
// tests/test_torch_rbgs_tiles.py emulates the schedule in float64.
//
// es_fused_rbgs_sweep (fused_rbgs_kernel) needs the red values of the ring
// around its tile before its black half-sweep, so a block owns a tile and
// stages u and b over a window two cells wider on every side (halo 2),
// zero outside the grid, by 4-byte cp.async (csrc/cp_async.cuh; rows of
// 4095 floats are only 4-byte aligned), all of a thread's copies in flight
// before one wait.  The red half-sweep updates the window cells at a
// distance >= 1 from the window edge and the black one those at >= 2:
// their neighbours all lie in the window, so no read is predicated, and
// the cells still right after each pass are exactly those; the tile
// (distance >= 2) is then stored.  Each window row is stored split by
// column parity: its even columns, then, 16 banks on, its odd ones, so
// that a colour's cells of a row are contiguous.  In a half-sweep lane x
// updates slot x of the colour's half of each of its rows: every lane
// busy, no divide or modulo, and every warp's reads of the half, of its
// left and right neighbours (the other half, shifted by at most one slot)
// and of the rows above and below are 32 consecutive floats, free of bank
// conflicts.  Tiles start at even interior indices, so a window cell's
// colour is the parity of its window indices.  The window is 24 x 64
// cells, 15,360 bytes of u and b, in blocks of 256 threads, 8 an SM
// (every thread slot of the SM).  Of the windows of 8, 16, 24 and 32 rows
// on an H100 it was within 0.00015 ms of the fastest at 1023^2, 511^2 and
// 255^2 and 0.0014 behind 32 rows at 4095^2; 16 rows (the complex sweep's
// window) lost 0.0065 there, 32 rows 0.0003 at 255^2.
// es_fused_rbgs_sweep_info reports its tile and occupancy from the card,
// and tests/test_torch_rbgs_tiles.py emulates the schedule in float64.

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

struct Sweep {
  // 5-point stencil: center and the neighbours up (-1,0), down (+1,0),
  // left (0,-1) and right (0,+1); dinv = 1/c
  float c, a_up, a_dn, a_lf, a_rt, dinv;
  int om;        // index into the relaxation-factor vector
  int parity;    // -1 every point, 0 red, 1 black (es_sweep only)
  int n, m;
};

// es_sweep's schedule (see the design note at the top): blocks of
// SWEEP_BX x SWEEP_BY threads; thread (x, y) owns column
// blockIdx.x * SWEEP_BX + x and the STRIP rows from
// (blockIdx.y * SWEEP_BY + y) * STRIP on; at least 1024 threads resident
// on an SM (64 registers a thread).
constexpr int STRIP = 4;
constexpr int SWEEP_BX = 128, SWEEP_BY = 2;
constexpr int SWEEP_MIN_BLOCKS = 1024 / (SWEEP_BX * SWEEP_BY);
static_assert(STRIP % 2 == 0 && SWEEP_BX % 32 == 0,
              "strips hold colour pairs, and a warp lies in one strip row");

constexpr unsigned FULL = 0xffffffffu;

// The neighbours left and right of this lane's value `v` on one row: from
// the lanes beside it, and at the warp's edges from `edge`, the value the
// edge lane loaded (lane 0 its left, lane 31 its right neighbour).
__device__ __forceinline__ void beside(float v, float edge, int lane,
                                       float& lf, float& rt) {
  lf = __shfl_up_sync(FULL, v, 1);
  rt = __shfl_down_sync(FULL, v, 1);
  if (lane == 0) lf = edge;
  if (lane == 31) rt = edge;
}

// ONE: a single-colour pass (p.parity 0 or 1), else every point (-1).
template <bool ONE>
__global__ void __launch_bounds__(SWEEP_BX * SWEEP_BY, SWEEP_MIN_BLOCKS)
sweep_kernel(const float* __restrict__ u, const float* __restrict__ b,
             const float* __restrict__ omegas, float* __restrict__ out,
             Sweep p) {
  constexpr int R = STRIP, Q = ONE ? R / 2 : R;   // rows updated
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * SWEEP_BX + threadIdx.x;
  const int i0 = (blockIdx.y * SWEEP_BY + threadIdx.y) * R;
  if (i0 >= p.n) return;   // the whole warp: it shares i0
  const bool col = j < p.m;
  const long g0 = static_cast<long>(i0) * p.m + j;
  // the updated rows: every row, or the strip's rows of colour p.parity,
  // d, d + 2, ... (the other colour's rows are copied)
  const int d = ONE ? (p.parity + i0 + j) & 1 : 0;
  constexpr int STEP = ONE ? 2 : 1;
  // the warp-edge lanes' neighbour column; the others load none
  const int je = lane == 0 ? j - 1 : j + 1;
  const bool edge = (lane == 0 || lane == 31) && je >= 0 && je < p.m;

  // every load before the arithmetic: u on the strip and one row beyond
  // each end, b and the edge neighbour on the updated rows
  float c[R + 2], bb[Q], e[Q];
#pragma unroll
  for (int k = 0; k < R + 2; ++k) {
    const int i = i0 - 1 + k;
    c[k] = col && i >= 0 && i < p.n ? u[g0 + static_cast<long>(k - 1) * p.m]
                                    : 0.f;
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int k = STEP * q + d, i = i0 + k;
    const bool row = i < p.n;
    bb[q] = col && row ? b[g0 + static_cast<long>(k) * p.m] : 0.f;
    e[q] = edge && row ? u[static_cast<long>(i) * p.m + je] : 0.f;
  }
  const float om_dinv = omegas[p.om] * p.dinv;

  float res[R];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    // row k = STEP q + d of the strip is c[k + 1]; in a single-colour pass
    // the lane sends its other row of the pair, which is the row of this
    // lane's colour in the lanes beside it (their column parity differs)
    const int k0 = STEP * q;
    const float v = ONE && d ? c[k0 + 2] : c[k0 + 1];
    const float up = ONE && d ? c[k0 + 1] : c[k0];
    const float dn = ONE && d ? c[k0 + 3] : c[k0 + 2];
    const float send = !ONE ? v : d ? c[k0 + 1] : c[k0 + 2];
    float lf, rt;
    beside(send, e[q], lane, lf, rt);
    const float au = p.c * v + p.a_up * up + p.a_dn * dn + p.a_lf * lf +
                     p.a_rt * rt;
    const float nv = v + om_dinv * (bb[q] - au);
    if (ONE) {
      res[k0] = d ? c[k0 + 1] : nv;
      res[k0 + 1] = d ? nv : c[k0 + 2];
    } else {
      res[k0] = nv;
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (col && i0 + k < p.n) out[g0 + static_cast<long>(k) * p.m] = res[k];
}

// ---------------------------------------------------------------------------
// The red-black sweep: fused_rbgs_kernel (es_fused_rbgs_sweep; see the
// design note at the top).
// ---------------------------------------------------------------------------

// The sweep's window: WR x 2 SL cells, blocks of SL x NY threads, at least
// BLOCKS resident on an SM (__launch_bounds__), the halo H and the tile.
// NY is even, so the rows of one thread share a parity.  Row wr of u's
// window holds its even columns at wr * RS + wc / 2 and its odd ones at
// wr * RS + ODD + wc / 2; ODD is SL + 16, so the odd half starts 16 banks
// after the even one.  b's window follows u's, B floats on.
struct FusedShape {
  static constexpr int H = 2;
  static constexpr int WR = 24, SL = 32, NY = 8;
  static constexpr int BLOCKS = 8;
  static constexpr int WC = 2 * SL;
  static constexpr int THREADS = SL * NY;
  static constexpr int TR = WR - 2 * H, TC = WC - 2 * H;
  static constexpr int KR = WR / NY;   // rows of a thread
  static constexpr int ODD = SL + 16, RS = ODD + SL;
  static constexpr int B = WR * RS;
  static constexpr int SMEM = 2 * B * static_cast<int>(sizeof(float));
  static_assert(NY % 2 == 0 && WR % NY == 0 && TR > 0 && TR % 2 == 0,
                "even tiles, and the rows of a thread share a parity");
  static_assert(SMEM <= 48 * 1024, "no dynamic shared memory opt-in");
};

template <typename L>
__device__ __forceinline__ int fused_at(int wr, int wc) {
  return wr * L::RS + (wc & 1) * L::ODD + (wc >> 1);
}

// u and b over the window whose top-left interior index is (r0, c0), zero
// outside the grid: lane x copies columns x and x + SLOTS of its rows, all
// by cp.async, then one wait and a barrier.
template <typename L>
__device__ __forceinline__ void stage_fused(const float* __restrict__ u,
                                            const float* __restrict__ b,
                                            float* su, const Sweep& p,
                                            int r0, int c0) {
#pragma unroll
  for (int k = 0; k < L::KR; ++k) {
    const int wr = threadIdx.y + k * L::NY, gr = r0 + wr;
    const bool row_in = gr >= 0 && gr < p.n;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int wc = threadIdx.x + j * L::SL, gc = c0 + wc;
      const bool in = row_in && gc >= 0 && gc < p.m;
      const long g = in ? static_cast<long>(gr) * p.m + gc : 0;
      float* dst = su + fused_at<L>(wr, wc);
      copy_async(dst, u + g, in);
      copy_async(dst + L::B, b + g, in);
    }
  }
  copy_wait_all();
  __syncthreads();
}

// Half-sweep PASS (1: red, 2: black) on the window cells in the grid at a
// distance >= PASS from the window's edge, in place (the four neighbours
// of a cell have the other colour), with the TPU kernel's sum
// c*v + (((c_up*up + c_dn*dn) + c_lf*lf) + c_rt*rt).  The colour's cells of
// this thread's rows all lie in half h; lane x takes slot x.
template <typename L, int PASS>
__device__ __forceinline__ void fused_pass(float* su, const Sweep& p,
                                           float om_dinv, int r0, int c0) {
  constexpr int colour = PASS - 1;
  const int s = threadIdx.x, ty = threadIdx.y;
  const int h = (colour + ty) & 1, wc = 2 * s + h, gc = c0 + wc;
  if (wc < PASS || wc > L::WC - 1 - PASS || gc < 0 || gc >= p.m) return;
  float* cell = su + h * L::ODD + s;
  // the right neighbour, in the other half; the left one precedes it
  const float* right = su + (1 - h) * L::ODD + s + h;
#pragma unroll
  for (int k = 0; k < L::KR; ++k) {
    const int wr = ty + k * L::NY, gr = r0 + wr;
    if (wr < PASS || wr > L::WR - 1 - PASS || gr < 0 || gr >= p.n) continue;
    float* w = cell + wr * L::RS;
    const float* rt = right + wr * L::RS;
    const float v = w[0];
    const float off = p.a_up * w[-L::RS] + p.a_dn * w[L::RS] +
                      p.a_lf * rt[-1] + p.a_rt * rt[0];
    w[0] = v + om_dinv * (w[L::B] - (p.c * v + off));
  }
}

// The tile of u's window to out: lane x stores columns H + x and
// H + x + SLOTS of its rows.
template <typename L>
__device__ __forceinline__ void store_fused(const float* su,
                                            float* __restrict__ out,
                                            const Sweep& p, int r0, int c0) {
#pragma unroll
  for (int k = 0; k < (L::TR + L::NY - 1) / L::NY; ++k) {
    const int wr = L::H + threadIdx.y + k * L::NY, gr = r0 + wr;
    if (wr >= L::H + L::TR || gr >= p.n) break;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int wc = L::H + threadIdx.x + j * L::SL, gc = c0 + wc;
      if (wc < L::H + L::TC && gc < p.m)
        out[static_cast<long>(gr) * p.m + gc] = su[fused_at<L>(wr, wc)];
    }
  }
}

__global__ void __launch_bounds__(FusedShape::THREADS, FusedShape::BLOCKS)
fused_rbgs_kernel(const float* __restrict__ u, const float* __restrict__ b,
                  const float* __restrict__ omegas, float* __restrict__ out,
                  Sweep p) {
  using L = FusedShape;
  __shared__ float su[2 * L::B];
  const int r0 = blockIdx.y * L::TR - L::H, c0 = blockIdx.x * L::TC - L::H;
  const float om_dinv = omegas[p.om] * p.dinv;
  stage_fused<L>(u, b, su, p, r0, c0);
  fused_pass<L, 1>(su, p, om_dinv, r0, c0);
  __syncthreads();
  fused_pass<L, 2>(su, p, om_dinv, r0, c0);
  __syncthreads();
  store_fused<L>(su, out, p, r0, c0);
}

Sweep make_sweep(const double* vals, int om, int parity, int n, int m) {
  Sweep p;
  p.c = static_cast<float>(vals[0]);
  p.a_up = static_cast<float>(vals[1]);
  p.a_dn = static_cast<float>(vals[2]);
  p.a_lf = static_cast<float>(vals[3]);
  p.a_rt = static_cast<float>(vals[4]);
  p.dinv = static_cast<float>(1.0 / vals[0]);
  p.om = om;
  p.parity = parity;
  p.n = n;
  p.m = m;
  return p;
}

// The single-pass sweep's instantiation: one colour or every point.
using SweepKernel = void (*)(const float*, const float*, const float*, float*,
                             Sweep);
SweepKernel sweep_of(bool one_colour) {
  return one_colour ? sweep_kernel<true> : sweep_kernel<false>;
}

}  // namespace

// vals: 5 stencil values (center, (-1,0), (+1,0), (0,-1), (0,+1)).
// om: index of the relaxation factor in omegas.  Returns the launch's
// cudaError_t.
extern "C" int es_sweep(const float* u, const float* b, const float* omegas,
                        int om, int parity, const double* vals, float* out,
                        int n, int m, void* stream) {
  if (n < 1 || m < 1 || parity < -1 || parity > 1 || vals[0] == 0.0)
    return cudaErrorInvalidValue;
  const Sweep p = make_sweep(vals, om, parity, n, m);
  const int rows = STRIP * SWEEP_BY;
  const dim3 grid((m + SWEEP_BX - 1) / SWEEP_BX, (n + rows - 1) / rows);
  sweep_of(parity >= 0)<<<grid, dim3(SWEEP_BX, SWEEP_BY), 0,
                          static_cast<cudaStream_t>(stream)>>>(u, b, omegas,
                                                               out, p);
  return cudaGetLastError();
}

// As es_sweep, without the parity.
extern "C" int es_fused_rbgs_sweep(const float* u, const float* b,
                                   const float* omegas, int om,
                                   const double* vals, float* out, int n,
                                   int m, void* stream) {
  using L = FusedShape;
  if (n < 1 || m < 1 || vals[0] == 0.0) return cudaErrorInvalidValue;
  const Sweep p = make_sweep(vals, om, 0, n, m);
  const dim3 grid((m + L::TC - 1) / L::TC, (n + L::TR - 1) / L::TR);
  fused_rbgs_kernel<<<grid, dim3(L::SL, L::NY), 0,
                      static_cast<cudaStream_t>(stream)>>>(u, b, omegas, out,
                                                           p);
  return cudaGetLastError();
}

// What es_fused_rbgs_sweep's kernel is on this card: info[0], [1] its
// tile's rows and columns, [2] its halo, [3] threads per block, [4]
// resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// [5] registers per thread, [6] local memory per thread in bytes (spills
// land there), [7] shared memory per block in bytes.
extern "C" int es_fused_rbgs_sweep_info(int* info) {
  using L = FusedShape;
  const void* kernel = reinterpret_cast<const void*>(fused_rbgs_kernel);
  int blocks = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, L::THREADS, 0);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  info[0] = L::TR;
  info[1] = L::TC;
  info[2] = L::H;
  info[3] = L::THREADS;
  info[4] = blocks;
  info[5] = attr.numRegs;
  info[6] = static_cast<int>(attr.localSizeBytes);
  info[7] = static_cast<int>(attr.sharedSizeBytes);
  return cudaSuccess;
}

// What es_sweep's kernel (one_colour: parity 0 or 1, else -1) is on this
// card: info[0] the rows of a thread's strip, [1], [2] the block's
// columns and strips (SWEEP_BX, SWEEP_BY), [3] threads per block, [4]
// resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// [5] registers per thread, [6] local memory per thread in bytes (spills
// land there), [7] shared memory per block in bytes.
extern "C" int es_sweep_info(int one_colour, int* info) {
  const void* kernel = reinterpret_cast<const void*>(sweep_of(one_colour));
  int blocks = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, SWEEP_BX * SWEEP_BY, 0);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  info[0] = STRIP;
  info[1] = SWEEP_BX;
  info[2] = SWEEP_BY;
  info[3] = SWEEP_BX * SWEEP_BY;
  info[4] = blocks;
  info[5] = attr.numRegs;
  info[6] = static_cast<int>(attr.localSizeBytes);
  info[7] = static_cast<int>(attr.sharedSizeBytes);
  return cudaSuccess;
}
