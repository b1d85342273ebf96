// Standalone smoother sweeps of a constant 7-point 3D operator for Hopper
// (sm_90a), float32.
//
// es_sweep3d replaces two TPU kernels that compute the same function:
//   evostencils_tpu/ops/pallas/rbgs3d.py fused_rbgs_sweep_3d and
//   jacobi_sweep_3d (_sweep_call_3d, _fused_rb3d_kernel), the
//   plane-blocked kernel that the JAX gate sends 127^3 and 63^3 to, and
//   evostencils_tpu/ops/pallas/leg3d.py fused_rbgs_sweep_3d2 and
//   jacobi_sweep_3d2 (_rb2ax_kernel), the two-axis-blocked kernel that
//   takes 255^3 and up, where whole planes overflow the TPU's VMEM budget.
//   Hopper has no such budget, so one kernel serves both; the wrappers
//   count its launches under the four names.
// One call is one launch: either a damped red-black Gauss-Seidel sweep
// (red, then black with the new red values) or a damped Jacobi sweep, with
// the TPU kernels' update at each updated point
//   u + omega * (dinv * b - u - off),
//   off = ((((dxm*xm + dxp*xp) + dym*ym) + dyp*yp) + dzm*zm) + dzp*zp,
// where d_k = c_k * dinv is folded on the host in double (rbgs3d.py:113-138,
// leg3d.py:156-165).  Red is an ODD sum of interior indices (interior index
// i is node i+1 on all three axes, rbgs3d.py:106-107).  Points outside the
// grid are 0 and never updated.  The relaxation factor is read from the
// device vector by index, so no launch waits on the host.
//
// What bounds it: device-memory bytes.  A sweep must read u and b once and
// write u once, 12 bytes a point: at 255^3 that is 198,976,500 bytes,
// 0.0594 ms at 3.35 TB/s.  It does about 16 flops a point.
//
// Red-black design: the plane pipeline of the 3D up-leg
// (csrc/wavefront3d.cu, helpers in csrc/pipeline3d.cuh) with one sweep and
// no correction.  Each block owns a 32 x 32 tile of the (axis-1, axis-2)
// plane and walks a chunk of axis 0: at step s plane s arrives, red runs
// on plane s-1 (the cells at distance >= 1 from the window edge) and black
// on plane s-3 (distance >= 2), and the owners store plane s-3, final in
// both cells, from their registers.  The two stages read and write
// disjoint cells, so a step takes one barrier.  Planes s+1 and s+2 of u
// and b are in flight (cp.async, zero-filled outside the grid) while step
// s computes.  Each thread owns a red and a black cell of a window split
// by parity, and keeps their axis-0 columns of u in registers: no lane
// idles on the other colour, and no cell pays a divide.  Window-edge cells
// see zeros in place of their out-of-window neighbours; the error moves
// inward one cell a half-sweep, so a halo of 2 leaves the tile exact (the
// window has a third cell after the tile, so that its rows are odd), and
// a chunk loads 2 planes past each end and treats the planes beyond as
// zero.  Shared memory: 6 u and 6 b planes of 37 x 37, 65,760 bytes;
// 685 threads, 2 blocks an SM.  es_sweep3d_info reports the schedule with
// the card's occupancy; ops/kernels/rbgs3d.py states its constants, and
// tests/test_torch_wavefront_tiles.py emulates it in float64.
//
// Jacobi design: one thread a point, as es_sweep in csrc/rbgs.cu: the
// neighbours come through L1/L2, and the output goes to a buffer the
// kernel does not read, so every point sees the old u.

#include <cuda_runtime.h>

#include "pipeline3d.cuh"

namespace {

constexpr int RB_T = 32;                      // in-plane tile edge (axes 1, 2)
constexpr int RB_LO = 2, RB_HI = 3;           // window cells before / after
constexpr int RB_WARM = 2;                    // planes loaded past each end
constexpr int RB_W = RB_T + RB_LO + RB_HI;    // window edge (odd)
constexpr int RB_HALF = (RB_W * RB_W + 1) / 2;  // even cells; the odd follow
constexpr int RB_PS = 2 * RB_HALF;            // plane stride
constexpr int RB_RING = 2 * LAG + AHEAD;      // u, b planes s-3 .. s+AHEAD
constexpr int RB_COL = 2 * LAG + 2;           // column registers (the loop)
// chunks of 2 planes at 63^3, where the 4 tiles would leave SMs idle
constexpr int RB_MIN_CHUNK = 2;               // fewest planes a chunk holds
constexpr int RB_THREADS = RB_HALF, RB_BLOCKS_PER_SM = 2;
constexpr int RB_SMEM = 2 * RB_RING * RB_PS * sizeof(float);
constexpr int JAC_BX = 32, JAC_BY = 8;

static_assert(RB_W % 2 == 1, "odd window rows");
static_assert(RB_T % 2 == 0 && RB_LO % 2 == 0 && RB_WARM % 2 == 0,
              "windows and chunks start at even indices and steps");

struct Sweep3 {
  // 1/c and the neighbour coefficients -x, +x, -y, +y, -z, +z scaled by it
  // (x = axis 0, y = axis 1, z = axis 2)
  float dinv, dxm, dxp, dym, dyp, dzm, dzp;
  int om;        // index into the relaxation-factor vector
  int n0, n1, n2;
  int chunk;     // axis-0 planes per block (red-black; even)
};

__global__ void __launch_bounds__(RB_THREADS, RB_BLOCKS_PER_SM)
rb_sweep3d_kernel(const float* __restrict__ u, const float* __restrict__ b,
                  const float* __restrict__ omegas, float* __restrict__ out,
                  Sweep3 p) {
  extern __shared__ float smem[];
  float* su = smem;                          // RB_RING u planes
  float* sb = su + RB_RING * RB_PS;          // RB_RING b planes
  const int t = threadIdx.x;
  const int y0 = blockIdx.y * RB_T - RB_LO, x0 = blockIdx.x * RB_T - RB_LO;
  const int z0 = blockIdx.z * p.chunk;
  const int z1 = min(z0 + p.chunk, p.n0);    // planes [z0, z1) are stored
  const int L0 = z0 - RB_WARM, last = z1 - 1 + 2 * LAG - 1;
  // planes [pa, pb] are loaded and updated; the others read as zero
  const int pa = max(L0, 0), pb = min(z1 - 1 + RB_WARM, p.n0 - 1);
  const long plane = static_cast<long>(p.n1) * p.n2;
  const float om = omegas[p.om];
  const Cell ce = make_cell<RB_W, RB_LO, RB_T, true>(2 * t, y0, x0, 0, 0, p);
  const Cell co =
      make_cell<RB_W, RB_LO, RB_T, true>(2 * t + 1, y0, x0, 0, 0, p);
  // u's axis-0 column of each cell; at the first step of a pair (B = 0)
  // col[4 - k] holds plane s-k, at the second (B = 1) col[5 - k]
  float cole[RB_COL], colo[RB_COL];
#pragma unroll
  for (int j = 0; j < RB_COL; ++j) cole[j] = colo[j] = 0.f;
  // planes L0 .. L0 + AHEAD - 1 in flight before the first step
#pragma unroll
  for (int a = 0; a < AHEAD; ++a)
    fetch_plane<RB_HALF>(ce, co, u, b, su + a * RB_PS, sb + a * RB_PS,
                         L0 + a, pa, pb, plane);
  copy_wait<AHEAD - 1>();
  __syncthreads();

  int slot = 0;                              // ring slot of plane s
  // step s; SE: s is even; col[B + 4 - k] holds plane s-k
  auto step = [&](auto se_, auto b_, int s) {
    constexpr bool SE = decltype(se_)::value;
    constexpr int B = decltype(b_)::value;
    {
      const int o = slot_back<RB_RING>(slot, -AHEAD) * RB_PS;
      fetch_plane<RB_HALF>(ce, co, u, b, su + o, sb + o, s + AHEAD, pa, pb,
                           plane);
    }
    const int o0 = slot * RB_PS, o1 = slot_back<RB_RING>(slot, 1) * RB_PS,
              o3 = slot_back<RB_RING>(slot, 3) * RB_PS;
    auto active = [&](int pl) { return pl >= pa && pl <= pb; };
    // plane s has arrived
    cole[B + 4] = su[o0 + t];
    if (co.own()) colo[B + 4] = su[o0 + RB_HALF + t];
    // X takes the red stage (plane s-1; red cells have P + w odd), Y the
    // black one (s-3)
    const Cell& X = pick<SE>(ce, co);
    const Cell& Y = pick<SE>(co, ce);
    auto& cx = pick<SE>(cole, colo);
    auto& cy = pick<SE>(colo, cole);
    const int ix = SE ? t : RB_HALF + t;
    const bool x1 = X.grid() && active(s - 1) && X.dist() >= 1;
    const bool y3 = Y.grid() && active(s - 3) && Y.dist() >= 2;
    if (x1) {
      const Around n = around<SE, RB_W, RB_HALF>(su + o1, sb + o1, t);
      cx[B + 3] = relax(cx[B + 2], cx[B + 3], cx[B + 4], n, om, p);
      su[o1 + ix] = cx[B + 3];               // black on s-1 reads it
    }
    // no later stage reads plane s-3's black cells: registers only
    if (y3)
      cy[B + 1] = relax(cy[B + 0], cy[B + 1], cy[B + 2],
                        around<!SE, RB_W, RB_HALF>(su + o3, sb + o3, t), om,
                        p);
    // plane s-3 is final in both cells
    if (s - 3 >= z0 && s - 3 < z1) {
      float* o = out + (s - 3) * plane;
      if (ce.tile()) o[ce.g] = cole[B + 1];
      if (co.tile()) o[co.g] = colo[B + 1];
    }
    // plane s+1 is in; plane s+AHEAD may still be in flight
    copy_wait<AHEAD - 1>();
    __syncthreads();
    slot = next_slot<RB_RING>(slot);
  };
  // L0 is even: steps come in pairs (even, odd)
  for (int s = L0;; s += 2) {
    step(Bool<true>{}, Int<0>{}, s);
    if (s + 1 > last) break;
    step(Bool<false>{}, Int<1>{}, s + 1);
    if (s + 2 > last) break;
    shift2(cole);
    shift2(colo);
  }
  copy_wait<0>();
}

__global__ void __launch_bounds__(JAC_BX * JAC_BY)
jacobi_sweep3d_kernel(const float* __restrict__ u,
                      const float* __restrict__ b,
                      const float* __restrict__ omegas,
                      float* __restrict__ out, Sweep3 p) {
  const int k = blockIdx.x * JAC_BX + threadIdx.x;
  const int j = blockIdx.y * JAC_BY + threadIdx.y;
  const int i = blockIdx.z;
  if (j >= p.n1 || k >= p.n2) return;
  const long s0 = static_cast<long>(p.n1) * p.n2;
  const long g = i * s0 + static_cast<long>(j) * p.n2 + k;
  const float v = u[g];
  const float xm = i > 0 ? u[g - s0] : 0.f;
  const float xp = i < p.n0 - 1 ? u[g + s0] : 0.f;
  const float ym = j > 0 ? u[g - p.n2] : 0.f;
  const float yp = j < p.n1 - 1 ? u[g + p.n2] : 0.f;
  const float zm = k > 0 ? u[g - 1] : 0.f;
  const float zp = k < p.n2 - 1 ? u[g + 1] : 0.f;
  float off = p.dxm * xm;
  off += p.dxp * xp;
  off += p.dym * ym;
  off += p.dyp * yp;
  off += p.dzm * zm;
  off += p.dzp * zp;
  out[g] = v + omegas[p.om] * (p.dinv * b[g] - v - off);
}

Sweep3 make_sweep(const double* vals, int om, int n0, int n1, int n2) {
  Sweep3 p;
  const double dinv = 1.0 / vals[0];
  p.dinv = static_cast<float>(dinv);
  p.dxm = static_cast<float>(vals[1] * dinv);
  p.dxp = static_cast<float>(vals[2] * dinv);
  p.dym = static_cast<float>(vals[3] * dinv);
  p.dyp = static_cast<float>(vals[4] * dinv);
  p.dzm = static_cast<float>(vals[5] * dinv);
  p.dzp = static_cast<float>(vals[6] * dinv);
  p.om = om;
  p.n0 = n0;
  p.n1 = n1;
  p.n2 = n2;
  p.chunk = n0;
  return p;
}

}  // namespace

// vals: 7 stencil values (center, -x, +x, -y, +y, -z, +z).  om: index of
// the relaxation factor in omegas.  red_black: 1 for a red-black sweep, 0
// for a Jacobi sweep.  Writes out (n0, n1, n2); returns the launch's
// cudaError_t.
extern "C" int es_sweep3d(const float* u, const float* b, const float* omegas,
                          int om, int red_black, const double* vals,
                          float* out, int n0, int n1, int n2, void* stream) {
  if (n0 < 1 || n1 < 1 || n2 < 1 || n0 > 65535 || vals[0] == 0.0 ||
      (red_black != 0 && red_black != 1))
    return cudaErrorInvalidValue;
  Sweep3 p = make_sweep(vals, om, n0, n1, n2);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (red_black) {
    static bool opted[MAX_DEVICES];
    cudaError_t err = opt_in_smem(rb_sweep3d_kernel, RB_SMEM, opted);
    if (err != cudaSuccess) return err;
    const dim3 grid = pipeline_blocks(n0, n1, n2, RB_T, RB_BLOCKS_PER_SM,
                                      RB_MIN_CHUNK, &p.chunk, &err);
    if (err != cudaSuccess) return err;
    rb_sweep3d_kernel<<<grid, RB_THREADS, RB_SMEM, s>>>(u, b, omegas, out,
                                                          p);
  } else {
    const dim3 grid((n2 + JAC_BX - 1) / JAC_BX, (n1 + JAC_BY - 1) / JAC_BY,
                    n0);
    jacobi_sweep3d_kernel<<<grid, dim3(JAC_BX, JAC_BY), 0, s>>>(u, b, omegas,
                                                               out, p);
  }
  return cudaGetLastError();
}

// What the card makes of es_sweep3d's red-black kernel: the 11 values of
// pipeline_info (csrc/pipeline3d.cuh).
extern "C" int es_sweep3d_info(int* info) {
  return pipeline_info(reinterpret_cast<const void*>(rb_sweep3d_kernel),
                       RB_T, RB_LO, RB_HI, RB_WARM, RB_MIN_CHUNK, RB_THREADS,
                       RB_SMEM, info);
}
