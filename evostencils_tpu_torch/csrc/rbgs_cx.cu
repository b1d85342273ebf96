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
// es_fused_rbgs_sweep_cx needs the red values of the ring around its tile
// before its black half-sweep.  Each block loads a (T+4) x (T+4) window of
// u with a 2-cell halo into shared memory, updates red on the tile and a
// 1-cell ring around it (whose neighbours lie in the window), syncs,
// updates black on the tile, and writes the tile; b is read from device
// memory at the points each half-sweep updates, so it needs no window.
// With T = 64 the float2 window takes 68 * 68 * 8 = 36,992 bytes of shared
// memory, below the 48 KB default, so no opt-in is needed (a window of b
// as well would take 73,984 bytes).  The window reads 68^2 / 64^2 = 1.13
// times the tile's bytes of u (L2 absorbs part of the overlap).

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;
constexpr int WIN = TILE + 4;            // 2-cell halo on each side
constexpr int THREADS = 256;
constexpr int FUSED_SMEM = WIN * WIN * sizeof(float2);
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

// One half-sweep of colour `parity` on the window cells whose row and
// column indices both lie in [lo, WIN - 1 - lo].
__device__ void half_sweep(float2* su, const float2* __restrict__ b,
                           const SweepCx& p, float omega, int r0, int c0,
                           int parity, int lo) {
  const int span = WIN - 2 * lo;
  for (int idx = threadIdx.x; idx < span * span; idx += blockDim.x) {
    const int wr = lo + idx / span, wc = lo + idx % span;
    const int gr = r0 + wr, gc = c0 + wc;
    if (gr < 0 || gr >= p.n || gc < 0 || gc >= p.m ||
        ((gr + gc) & 1) != parity)
      continue;
    const int w = wr * WIN + wc;
    const float2 s[5] = {su[w], su[w - WIN], su[w + WIN], su[w - 1],
                         su[w + 1]};
    const float2 d =
        correction(p, omega, s, b[static_cast<long>(gr) * p.m + gc]);
    su[w] = make_float2(s[0].x + d.x, s[0].y + d.y);
  }
}

__global__ void __launch_bounds__(THREADS)
fused_rbgs_cx_kernel(const float2* __restrict__ u,
                     const float2* __restrict__ b,
                     const float* __restrict__ omegas,
                     float2* __restrict__ out, SweepCx p) {
  extern __shared__ float2 su[];
  const int r0 = blockIdx.y * TILE - 2, c0 = blockIdx.x * TILE - 2;
  for (int idx = threadIdx.x; idx < WIN * WIN; idx += blockDim.x) {
    const int gr = r0 + idx / WIN, gc = c0 + idx % WIN;
    const bool in = gr >= 0 && gr < p.n && gc >= 0 && gc < p.m;
    su[idx] = in ? u[static_cast<long>(gr) * p.m + gc]
                 : make_float2(0.f, 0.f);
  }
  __syncthreads();
  const float omega = omegas[p.om];
  half_sweep(su, b, p, omega, r0, c0, 0, 1);   // red: tile + 1-cell ring
  __syncthreads();
  half_sweep(su, b, p, omega, r0, c0, 1, 2);   // black: the tile
  __syncthreads();
  for (int idx = threadIdx.x; idx < TILE * TILE; idx += blockDim.x) {
    const int gr = r0 + 2 + idx / TILE, gc = c0 + 2 + idx % TILE;
    if (gr < p.n && gc < p.m)
      out[static_cast<long>(gr) * p.m + gc] =
          su[(2 + idx / TILE) * WIN + 2 + idx % TILE];
  }
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

extern "C" int es_fused_rbgs_sweep_cx(const float2* u, const float2* b,
                                      const float* omegas, int om,
                                      const double* vals, float2* out, int n,
                                      int m, void* stream) {
  if (invalid(vals, n, m)) return cudaErrorInvalidValue;
  const SweepCx p = make_sweep(vals, om, n, m);
  const dim3 grid((m + TILE - 1) / TILE, (n + TILE - 1) / TILE);
  fused_rbgs_cx_kernel<<<grid, THREADS, FUSED_SMEM,
                         static_cast<cudaStream_t>(stream)>>>(u, b, omegas,
                                                              out, p);
  return cudaGetLastError();
}
