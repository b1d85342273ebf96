// Smoother sweeps of a constant complex 5-point operator for Hopper
// (sm_90a), complex64.
//
// es_fused_rbgs_sweep_cx replaces the TPU kernel
//   evostencils_tpu/ops/pallas/rbgs_cx.py fused_rbgs_sweep_cx
//   (_cx_sweep_call with two half-sweeps, body _fused_cx_kernel): one
//   damped red-black Gauss-Seidel sweep, the red half-sweep and then the
//   black one, in one pass over u and b.
// es_sweep_cx replaces
//   evostencils_tpu/ops/pallas/rbgs_cx.py jacobi_sweep_cx (the same body
//   with one half-sweep): one damped Jacobi sweep, every point from the
//   old u.
//
// Both compute, at each updated point, the TPU body's update
// (rbgs_cx.py:93-104):
//   Au = sum_k c_k s_k over center, up (-1,0), down (+1,0), left (0,-1),
//        right (0,+1), each product expanded as (cr ur - ci ui, cr ui + ci ur)
//        and summed in that order;
//   r = b - Au;  u += omega * (dr rr - di ri, dr ri + di rr)
// with d = 1/center computed in double on the host and passed as two
// floats, and omega read from the real relaxation-factor vector by index,
// so no launch waits on the host.  Red is an even sum of interior indices
// (node parity is the same in 2D).  Points outside the grid are 0 and never
// updated.
//
// Data layout: the TPU stacks the real and imaginary planes into a
// (2, n, m) float32 array and splits the result back (rbgs_cx.py:124-126,
// :150), two extra passes over u and b that exist only because the TPU has
// no complex vector type.  Here u, b and the output are torch's
// interleaved complex64 tensors read in place: each point is one float2.
//
// What bounds them: device-memory bytes.  A sweep must read u and b once
// and write u once, 24 bytes a point; it does about 50 float32 operations
// a point, about 2 operations a byte, far below the card's 20 (67 TFLOP/s
// over 3.35 TB/s).
//
// es_sweep_cx reads u through the cache, one thread a point, and writes a
// buffer it never reads, so that every point sees the old u.
//
// es_fused_rbgs_sweep_cx (fused_rbgs_cx_kernel) needs the red values of
// the ring around its tile before its black half-sweep, so a block owns a
// tile and stages u and b over a window two cells wider on every side
// (halo 2), zero outside the grid, by 8-byte cp.async (one float2 a copy:
// a 2047-wide row is 16,376 bytes, 8-byte but not 16-byte aligned), all of
// a thread's copies in flight before one wait.  The red half-sweep updates
// the window cells at a distance >= 1 from the window edge and the black
// one those at >= 2: their neighbours all lie in the window, so no read is
// predicated, and the cells still right after each pass are exactly those;
// the tile (distance >= 2) is then stored.  Each window row is stored
// split by column parity: its even columns, then, 16 banks on, its odd
// ones, so that a colour's cells of a row are contiguous.  In a half-sweep
// lane x updates slot x of the colour's half of each of its rows: every
// lane busy, and a warp's float2 reads of the half and of its left and
// right neighbours (the other half, shifted by at most one slot) are 32
// consecutive float2, two conflict-free wavefronts; the staging writes of
// one half-warp fall 8 slots in each half, 16 banks apart.  The window is
// 16 x 64 cells, 18,432 bytes of u and b, in blocks of 256 threads, 8 an
// SM (every thread slot of the SM).  On the H100 it was the fastest of the
// 64 x 64, 32 x 64 and 16 x 64 windows at every level from 2047^2 to
// 255^2, by 5-9% over 32 x 64 (the overlap of its windows, 1.42 times its
// tile, comes from L2; PERF.md section 6).  es_fused_rbgs_sweep_cx_info
// reports its tile and occupancy from the card.
// tests/test_torch_cx_tiles.py emulates this schedule in complex128.
// Tiles start at even interior indices, so a window cell's colour is the
// parity of its window indices.

#include <cuda_runtime.h>

namespace {

constexpr int SWEEP_BX = 32, SWEEP_BY = 8;

struct SweepCx {
  // the stencil: center, up, down, left, right, real and imaginary parts
  float cr[5], ci[5];
  float dr, di;  // d = 1 / center
  int om;        // index into the relaxation-factor vector
  int n, m;
};

// omega * d * (b - sum_k c_k s_k), s = (center, up, down, left, right)
__device__ __forceinline__ float2 correction(const SweepCx& p, float omega,
                                             const float2 (&s)[5],
                                             float2 b) {
  float aur = 0.f, aui = 0.f;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    aur += p.cr[k] * s[k].x - p.ci[k] * s[k].y;
    aui += p.cr[k] * s[k].y + p.ci[k] * s[k].x;
  }
  const float rr = b.x - aur, ri = b.y - aui;
  return make_float2(omega * (p.dr * rr - p.di * ri),
                     omega * (p.dr * ri + p.di * rr));
}

__global__ void __launch_bounds__(SWEEP_BX * SWEEP_BY)
sweep_cx_kernel(const float2* __restrict__ u, const float2* __restrict__ b,
                const float* __restrict__ omegas, float2* __restrict__ out,
                SweepCx p) {
  const int j = blockIdx.x * SWEEP_BX + threadIdx.x;
  const int i = blockIdx.y * SWEEP_BY + threadIdx.y;
  if (i >= p.n || j >= p.m) return;
  const long g = static_cast<long>(i) * p.m + j;
  const float2 zero = make_float2(0.f, 0.f);
  const float2 s[5] = {u[g], i > 0 ? u[g - p.m] : zero,
                       i < p.n - 1 ? u[g + p.m] : zero,
                       j > 0 ? u[g - 1] : zero,
                       j < p.m - 1 ? u[g + 1] : zero};
  const float2 d = correction(p, omegas[p.om], s, b[g]);
  out[g] = make_float2(s[0].x + d.x, s[0].y + d.y);
}

// ---------------------------------------------------------------------------
// The red-black sweep: fused_rbgs_cx_kernel (es_fused_rbgs_sweep_cx; see
// the design note at the top).
// ---------------------------------------------------------------------------

// The sweep's window: WR x 2 SL cells, blocks of SL x NY threads, at
// least BLOCKS resident on an SM (__launch_bounds__), the halo H and the
// tile.  NY is even, so the rows of one thread share a parity.  Row wr of
// u's window holds its even columns at wr * RS + wc / 2 and its odd ones
// at wr * RS + ODD + wc / 2 (float2 units); ODD is SL + 8, so the odd
// half starts 16 banks after the even one.  b's window follows u's, B
// float2 on.
struct CxShape {
  static constexpr int H = 2;
  static constexpr int WR = 16, SL = 32, NY = 8;
  static constexpr int WC = 2 * SL;
  static constexpr int THREADS = SL * NY;
  static constexpr int BLOCKS = 8;
  static constexpr int TR = WR - 2 * H, TC = WC - 2 * H;
  static constexpr int KR = WR / NY;   // rows of a thread
  static constexpr int ODD = SL + 8, RS = ODD + SL;
  static constexpr int B = WR * RS;
  static constexpr int SMEM = 2 * B * static_cast<int>(sizeof(float2));
  static_assert(NY % 2 == 0 && WR % NY == 0 && TR > 0 && TR % 2 == 0,
                "even tiles, and the rows of a thread share a parity");
  static_assert(SMEM <= 48 * 1024, "no dynamic shared memory opt-in");
};

template <typename L>
__device__ __forceinline__ int cx_at(int wr, int wc) {
  return wr * L::RS + (wc & 1) * L::ODD + (wc >> 1);
}

// 8 bytes from src to shared dst without waiting; zeros when !in (src is
// then not read).
__device__ __forceinline__ void copy8_async(float2* dst, const float2* src,
                                            bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 8 : 0)
               : "memory");
}

// u and b over the window whose top-left interior index is (r0, c0), zero
// outside the grid: lane x copies columns x and x + SLOTS of its rows, all
// by cp.async, then one wait and a barrier.
template <typename L>
__device__ __forceinline__ void stage_cx(const float2* __restrict__ u,
                                         const float2* __restrict__ b,
                                         float2* su, const SweepCx& p,
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
      float2* dst = su + cx_at<L>(wr, wc);
      copy8_async(dst, u + g, in);
      copy8_async(dst + L::B, b + g, in);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// Half-sweep PASS (1: red, 2: black) on the window cells in the grid at a
// distance >= PASS from the window's edge, in place (the four neighbours
// of a cell have the other colour).  The colour's cells of this thread's
// rows all lie in half h; lane x takes slot x.
template <typename L, int PASS>
__device__ __forceinline__ void cx_pass(float2* su, const SweepCx& p,
                                        float omega, int r0, int c0) {
  constexpr int colour = PASS - 1;
  const int s = threadIdx.x, ty = threadIdx.y;
  const int h = (colour + ty) & 1, wc = 2 * s + h, gc = c0 + wc;
  if (wc < PASS || wc > L::WC - 1 - PASS || gc < 0 || gc >= p.m) return;
  float2* cell = su + h * L::ODD + s;
  // the right neighbour, in the other half; the left one precedes it
  const float2* right = su + (1 - h) * L::ODD + s + h;
#pragma unroll
  for (int k = 0; k < L::KR; ++k) {
    const int wr = ty + k * L::NY, gr = r0 + wr;
    if (wr < PASS || wr > L::WR - 1 - PASS || gr < 0 || gr >= p.n) continue;
    float2* w = cell + wr * L::RS;
    const float2* rt = right + wr * L::RS;
    const float2 st[5] = {w[0], w[-L::RS], w[L::RS], rt[-1], rt[0]};
    const float2 d = correction(p, omega, st, w[L::B]);
    w[0] = make_float2(st[0].x + d.x, st[0].y + d.y);
  }
}

// The tile of u's window to out: lane x stores columns H + x and
// H + x + SLOTS of its rows.
template <typename L>
__device__ __forceinline__ void store_tile_cx(const float2* su,
                                              float2* __restrict__ out,
                                              const SweepCx& p, int r0,
                                              int c0) {
#pragma unroll
  for (int k = 0; k < (L::TR + L::NY - 1) / L::NY; ++k) {
    const int wr = L::H + threadIdx.y + k * L::NY, gr = r0 + wr;
    if (wr >= L::H + L::TR || gr >= p.n) break;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int wc = L::H + threadIdx.x + j * L::SL, gc = c0 + wc;
      if (wc < L::H + L::TC && gc < p.m)
        out[static_cast<long>(gr) * p.m + gc] = su[cx_at<L>(wr, wc)];
    }
  }
}

__global__ void __launch_bounds__(CxShape::THREADS, CxShape::BLOCKS)
fused_rbgs_cx_kernel(const float2* __restrict__ u,
                     const float2* __restrict__ b,
                     const float* __restrict__ omegas,
                     float2* __restrict__ out, SweepCx p) {
  using L = CxShape;
  __shared__ float2 su[2 * L::B];
  const int r0 = blockIdx.y * L::TR - L::H, c0 = blockIdx.x * L::TC - L::H;
  const float omega = omegas[p.om];
  stage_cx<L>(u, b, su, p, r0, c0);
  cx_pass<L, 1>(su, p, omega, r0, c0);
  __syncthreads();
  cx_pass<L, 2>(su, p, omega, r0, c0);
  __syncthreads();
  store_tile_cx<L>(su, out, p, r0, c0);
}

SweepCx make_sweep(const double* vals, int om, int n, int m) {
  SweepCx p;
  for (int k = 0; k < 5; ++k) {
    p.cr[k] = static_cast<float>(vals[2 * k]);
    p.ci[k] = static_cast<float>(vals[2 * k + 1]);
  }
  p.dr = static_cast<float>(vals[10]);
  p.di = static_cast<float>(vals[11]);
  p.om = om;
  p.n = n;
  p.m = m;
  return p;
}

bool invalid(const double* vals, int n, int m) {
  return n < 1 || m < 1 || (vals[0] == 0.0 && vals[1] == 0.0);
}

}  // namespace

// u, b, out: n x m complex64 (interleaved re, im).  vals: 12 doubles, the
// (re, im) parts of the 5 stencil values (center, (-1,0), (+1,0), (0,-1),
// (0,+1)) and of 1/center.  om: index of the relaxation factor in the
// float32 vector omegas.  Returns the launch's cudaError_t.
extern "C" int es_sweep_cx(const float2* u, const float2* b,
                           const float* omegas, int om, const double* vals,
                           float2* out, int n, int m, void* stream) {
  if (invalid(vals, n, m)) return cudaErrorInvalidValue;
  const SweepCx p = make_sweep(vals, om, n, m);
  const dim3 grid((m + SWEEP_BX - 1) / SWEEP_BX,
                  (n + SWEEP_BY - 1) / SWEEP_BY);
  sweep_cx_kernel<<<grid, dim3(SWEEP_BX, SWEEP_BY), 0,
                    static_cast<cudaStream_t>(stream)>>>(u, b, omegas, out,
                                                         p);
  return cudaGetLastError();
}

// As es_sweep_cx.
extern "C" int es_fused_rbgs_sweep_cx(const float2* u, const float2* b,
                                      const float* omegas, int om,
                                      const double* vals, float2* out, int n,
                                      int m, void* stream) {
  using L = CxShape;
  if (invalid(vals, n, m)) return cudaErrorInvalidValue;
  const SweepCx p = make_sweep(vals, om, n, m);
  const dim3 grid((m + L::TC - 1) / L::TC, (n + L::TR - 1) / L::TR);
  fused_rbgs_cx_kernel<<<grid, dim3(L::SL, L::NY), 0,
                         static_cast<cudaStream_t>(stream)>>>(u, b, omegas,
                                                              out, p);
  return cudaGetLastError();
}

// What es_fused_rbgs_sweep_cx's kernel is on this card: info[0], [1] its
// tile's rows and columns, [2] its halo, [3] threads per block, [4]
// resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// [5] registers per thread, [6] local memory per thread in bytes (spills
// land there), [7] shared memory per block in bytes.
extern "C" int es_fused_rbgs_sweep_cx_info(int* info) {
  using L = CxShape;
  const void* kernel = reinterpret_cast<const void*>(fused_rbgs_cx_kernel);
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
