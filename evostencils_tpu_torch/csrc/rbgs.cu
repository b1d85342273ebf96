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
// es_sweep reads u through the cache: one thread a point, neighbours
// reused from L1/L2, and the output goes to a buffer it does not read, so
// that parity -1 sees only the old u.  A half-sweep of one colour is exact
// in the same way, because every neighbour of a point has the other colour.
//
// es_fused_rbgs_sweep needs the red values of the ring around its tile
// before its black half-sweep.  Each block loads a (T+4) x (T+4) window of
// u and b with a 2-cell halo into shared memory, updates red on the tile
// and a 1-cell ring around it (whose neighbours lie in the window), syncs,
// updates black on the tile, and writes the tile.  With T = 64 that reads
// 68^2 / 64^2 = 1.13 times the tile's bytes of u and b (L2 absorbs part of
// the overlap) and uses 2 * 68 * 68 * 4 = 36,992 bytes of shared memory, so
// no opt-in above 48 KB is needed.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;
constexpr int WIN = TILE + 4;            // 2-cell halo on each side
constexpr int THREADS = 256;
constexpr int FUSED_SMEM = 2 * WIN * WIN * sizeof(float);
constexpr int SWEEP_BX = 32, SWEEP_BY = 8;

struct Sweep {
  // 5-point stencil: center and the neighbours up (-1,0), down (+1,0),
  // left (0,-1) and right (0,+1); dinv = 1/c
  float c, a_up, a_dn, a_lf, a_rt, dinv;
  int om;        // index into the relaxation-factor vector
  int parity;    // -1 every point, 0 red, 1 black (es_sweep only)
  int n, m;
};

__global__ void __launch_bounds__(SWEEP_BX * SWEEP_BY)
sweep_kernel(const float* __restrict__ u, const float* __restrict__ b,
             const float* __restrict__ omegas, float* __restrict__ out,
             Sweep p) {
  const int j = blockIdx.x * SWEEP_BX + threadIdx.x;
  const int i = blockIdx.y * SWEEP_BY + threadIdx.y;
  if (i >= p.n || j >= p.m) return;
  const long g = static_cast<long>(i) * p.m + j;
  const float v = u[g];
  if (p.parity >= 0 && ((i + j) & 1) != p.parity) {
    out[g] = v;
    return;
  }
  const float up = i > 0 ? u[g - p.m] : 0.f;
  const float dn = i < p.n - 1 ? u[g + p.m] : 0.f;
  const float lf = j > 0 ? u[g - 1] : 0.f;
  const float rt = j < p.m - 1 ? u[g + 1] : 0.f;
  const float au = p.c * v + p.a_up * up + p.a_dn * dn + p.a_lf * lf +
                   p.a_rt * rt;
  out[g] = v + (omegas[p.om] * p.dinv) * (b[g] - au);
}

// One half-sweep of colour `parity` on the window cells whose row and
// column indices both lie in [lo, WIN - 1 - lo].
__device__ void half_sweep(float* su, const float* sb, const Sweep& p,
                           float om_dinv, int r0, int c0, int parity,
                           int lo) {
  const int span = WIN - 2 * lo;
  for (int idx = threadIdx.x; idx < span * span; idx += blockDim.x) {
    const int wr = lo + idx / span, wc = lo + idx % span;
    const int gr = r0 + wr, gc = c0 + wc;
    if (gr < 0 || gr >= p.n || gc < 0 || gc >= p.m ||
        ((gr + gc) & 1) != parity)
      continue;
    const int w = wr * WIN + wc;
    const float off = p.a_up * su[w - WIN] + p.a_dn * su[w + WIN] +
                      p.a_lf * su[w - 1] + p.a_rt * su[w + 1];
    const float v = su[w];
    su[w] = v + om_dinv * (sb[w] - (p.c * v + off));
  }
}

__global__ void __launch_bounds__(THREADS)
fused_rbgs_kernel(const float* __restrict__ u, const float* __restrict__ b,
                  const float* __restrict__ omegas, float* __restrict__ out,
                  Sweep p) {
  extern __shared__ float smem[];
  float* su = smem;
  float* sb = smem + WIN * WIN;
  const int r0 = blockIdx.y * TILE - 2, c0 = blockIdx.x * TILE - 2;
  for (int idx = threadIdx.x; idx < WIN * WIN; idx += blockDim.x) {
    const int gr = r0 + idx / WIN, gc = c0 + idx % WIN;
    const bool in = gr >= 0 && gr < p.n && gc >= 0 && gc < p.m;
    const long g = static_cast<long>(gr) * p.m + gc;
    su[idx] = in ? u[g] : 0.f;
    sb[idx] = in ? b[g] : 0.f;
  }
  __syncthreads();
  const float om_dinv = omegas[p.om] * p.dinv;
  half_sweep(su, sb, p, om_dinv, r0, c0, 0, 1);   // red: tile + 1-cell ring
  __syncthreads();
  half_sweep(su, sb, p, om_dinv, r0, c0, 1, 2);   // black: the tile
  __syncthreads();
  for (int idx = threadIdx.x; idx < TILE * TILE; idx += blockDim.x) {
    const int gr = r0 + 2 + idx / TILE, gc = c0 + 2 + idx % TILE;
    if (gr < p.n && gc < p.m)
      out[static_cast<long>(gr) * p.m + gc] =
          su[(2 + idx / TILE) * WIN + 2 + idx % TILE];
  }
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
  const dim3 grid((m + SWEEP_BX - 1) / SWEEP_BX, (n + SWEEP_BY - 1) / SWEEP_BY);
  sweep_kernel<<<grid, dim3(SWEEP_BX, SWEEP_BY), 0,
                 static_cast<cudaStream_t>(stream)>>>(u, b, omegas, out, p);
  return cudaGetLastError();
}

extern "C" int es_fused_rbgs_sweep(const float* u, const float* b,
                                   const float* omegas, int om,
                                   const double* vals, float* out, int n,
                                   int m, void* stream) {
  if (n < 1 || m < 1 || vals[0] == 0.0) return cudaErrorInvalidValue;
  const Sweep p = make_sweep(vals, om, 0, n, m);
  const dim3 grid((m + TILE - 1) / TILE, (n + TILE - 1) / TILE);
  fused_rbgs_kernel<<<grid, THREADS, FUSED_SMEM,
                      static_cast<cudaStream_t>(stream)>>>(u, b, omegas, out,
                                                           p);
  return cudaGetLastError();
}
