// Variable-coefficient 5-point smoother kernels for Hopper (sm_90a), float32.
//
// The operator is a coefficient stack c (5, n, m): plane k multiplies u at
// offset k of (center, (-1,0), (+1,0), (0,-1), (0,+1)), zero outside the
// grid:  A u = cc*u + cn*up + cs*dn + cw*left + ce*right, summed in that
// order (rbgs_var.py:112, :222, :237).
//
// es_sweep_var replaces the TPU kernel
//   evostencils_tpu/ops/pallas/rbgs_var.py fused_rbgs_sweep_var /
//   jacobi_sweep_var (_fused_var_kernel):
//   one damped red-black sweep (red, then black with the new red values)
//   or one damped Jacobi sweep, u + (omega / cc) * (b - A u).
// es_presmooth_residual_restrict_var replaces
//   rbgs_var.py presmooth_residual_restrict_var (_var_smooth_rr_kernel):
//   S in [1, 3] red-black or Jacobi sweeps u + (omega * (1 / cc)) * (b - A u),
//   then r = b - A u and the separable 3-tap 2:1 restriction of r (the row
//   taps, then the column taps), writing (u_s (n, m), rc ((n-1)/2, (m-1)/2)).
// es_prolong_correct_postsmooth_var replaces
//   rbgs_var.py prolong_correct_postsmooth_var (_var_pc_smooth_kernel):
//   u += omega_0 * P(e) with the separable 3-tap 1:2 prolongation (the
//   column expansion, then the row expansion), then S in [1, 3] sweeps
//   with omega_1..S.
// Each keeps its TPU body's order of operations: the standalone sweep
// takes omega / cc, the legs omega * (1 / cc).
//
// What bounds them: device-memory bytes.  A sweep must read u, b and the
// five coefficient planes once and write u once (32 bytes a point); a leg
// moves the coarse array (rc written or e read) besides.  The arithmetic is
// a few dozen flops a point.
//
// Design.  The tile walk is transfer.cu's: each leg block owns a 64 x 64
// fine tile and loads u and b with an 8-cell halo into shared memory,
// recomputing the halo redundantly; window-edge cells see zeros in place of
// their out-of-window neighbours, and the error moves inward one cell per
// half-sweep (or Jacobi sweep), so HALO = 8 covers 3 red-black sweeps, the
// residual and the restriction.  The coefficient planes stay out of shared
// memory: each cell reads its five coefficients through the read-only cache
// when it updates, so the window holds only u (two buffers, for Jacobi's
// update from the old values) and b: 3 * 80 * 80 * 4 = 76,800 bytes, where
// the coefficient planes too would take 128,000 more.  The standalone
// red-black sweep is rbgs.cu's: a 68 x 68 window with a 2-cell halo, red on
// the tile and a one-cell ring, then black on the tile; the Jacobi sweep is
// one thread a point writing a buffer it does not read.  Tiles start at even
// interior indices and red is an even sum of interior indices (interior
// index i is node i+1 on both axes, which leaves the parity unchanged).
// Cells outside the grid hold 0 and are never updated.  Relaxation factors
// are read from the device vector by index, so no launch waits on the host.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;
constexpr int HALO = 8;
constexpr int WIN = TILE + 2 * HALO;   // fine window edge of the legs
constexpr int CWIN = WIN / 2 + 1;      // coarse rows/columns feeding a window
constexpr int THREADS = 256;
constexpr int MAX_SWEEPS = 3;
constexpr int DOWN_SMEM = 3 * WIN * WIN * sizeof(float);
constexpr int UP_SMEM = DOWN_SMEM + CWIN * CWIN * sizeof(float);
constexpr int SWIN = TILE + 4;         // standalone red-black sweep window
constexpr int SWEEP_SMEM = 2 * SWIN * SWIN * sizeof(float);
constexpr int JAC_BX = 32, JAC_BY = 8;

struct VarLeg {
  float tr[3], tc[3];           // row and column transfer taps
  int om[MAX_SWEEPS + 1];       // indices into the relaxation-factor vector
  int sweeps;
  int red_black;                // 1 red-black sweeps, 0 Jacobi sweeps
  int n, m;
};

__device__ __forceinline__ bool inside(int n, int m, int gr, int gc) {
  return gr >= 0 && gr < n && gc >= 0 && gc < m;
}

// A u at one point of a window of edge `win`: `s` points at the point's
// value, `c` at its center coefficient in plane 0 of the stack, `nm` is
// the plane stride; neighbours outside the window read as 0.
__device__ __forceinline__ float apply_var(const float* s, int win, int wr,
                                           int wc,
                                           const float* __restrict__ c,
                                           long nm) {
  const float up = wr > 0 ? s[-win] : 0.f;
  const float dn = wr < win - 1 ? s[win] : 0.f;
  const float lf = wc > 0 ? s[-1] : 0.f;
  const float rt = wc < win - 1 ? s[1] : 0.f;
  return __ldg(c) * s[0] + __ldg(c + nm) * up + __ldg(c + 2 * nm) * dn +
         __ldg(c + 3 * nm) * lf + __ldg(c + 4 * nm) * rt;
}

// u and b over the leg window whose top-left interior index is (r0, c0).
__device__ void load_window(const float* __restrict__ u,
                            const float* __restrict__ b, float* su, float* sb,
                            const VarLeg& p, int r0, int c0) {
  for (int idx = threadIdx.x; idx < WIN * WIN; idx += blockDim.x) {
    const int wr = idx / WIN, wc = idx - wr * WIN;
    const int gr = r0 + wr, gc = c0 + wc;
    const bool in = inside(p.n, p.m, gr, gc);
    const long g = static_cast<long>(gr) * p.m + gc;
    su[idx] = in ? u[g] : 0.f;
    sb[idx] = in ? b[g] : 0.f;
  }
}

// p.sweeps sweeps on the window, with relaxation factors
// omegas[p.om[om_first]], omegas[p.om[om_first + 1]], ...  Red-black
// sweeps update `cur` in place (every neighbour of an updated cell has the
// other colour); a Jacobi sweep writes the other buffer.  Returns the
// buffer that holds the result.
__device__ float* var_sweeps(float* cur, float* other, const float* sb,
                             const float* __restrict__ c,
                             const float* __restrict__ omegas,
                             const VarLeg& p, int om_first, int r0, int c0) {
  const long nm = static_cast<long>(p.n) * p.m;
  for (int s = 0; s < p.sweeps; ++s) {
    const float om = omegas[p.om[om_first + s]];
    for (int parity = 0; parity < (p.red_black ? 2 : 1); ++parity) {
      float* dst = p.red_black ? cur : other;
      for (int idx = threadIdx.x; idx < WIN * WIN; idx += blockDim.x) {
        const int wr = idx / WIN, wc = idx - wr * WIN;
        const int gr = r0 + wr, gc = c0 + wc;
        if (!inside(p.n, p.m, gr, gc)) {
          if (!p.red_black) dst[idx] = 0.f;   // the other buffer's zeros
          continue;
        }
        const float v = cur[idx];
        if (p.red_black && ((gr + gc) & 1) != parity) continue;
        const float* cg = c + static_cast<long>(gr) * p.m + gc;
        const float au = apply_var(cur + idx, WIN, wr, wc, cg, nm);
        const float dinv = 1.0f / __ldg(cg);
        dst[idx] = v + om * dinv * (sb[idx] - au);
      }
      __syncthreads();
      if (!p.red_black) {
        float* t = cur;
        cur = other;
        other = t;
      }
    }
  }
  return cur;
}

__device__ void store_tile(const float* su, float* __restrict__ out,
                           const VarLeg& p, int r0, int c0) {
  for (int idx = threadIdx.x; idx < TILE * TILE; idx += blockDim.x) {
    const int i = idx / TILE, j = idx - i * TILE;
    const int gr = r0 + HALO + i, gc = c0 + HALO + j;
    if (inside(p.n, p.m, gr, gc))
      out[static_cast<long>(gr) * p.m + gc] = su[(HALO + i) * WIN + HALO + j];
  }
}

__global__ void __launch_bounds__(THREADS)
downleg_var_kernel(const float* __restrict__ u, const float* __restrict__ b,
                   const float* __restrict__ c,
                   const float* __restrict__ omegas, float* __restrict__ u_out,
                   float* __restrict__ rc, VarLeg p) {
  extern __shared__ float smem[];
  float* sb = smem;
  float* su = smem + WIN * WIN;
  float* alt = smem + 2 * WIN * WIN;
  const int r0 = blockIdx.y * TILE - HALO, c0 = blockIdx.x * TILE - HALO;
  load_window(u, b, su, sb, p, r0, c0);
  __syncthreads();
  su = var_sweeps(su, alt, sb, c, omegas, p, 0, r0, c0);

  // residual, in place of b, on the rows and columns the restriction
  // reads: window indices HALO .. HALO + TILE (inclusive) on both axes
  const long nm = static_cast<long>(p.n) * p.m;
  constexpr int RW = TILE + 1;
  for (int idx = threadIdx.x; idx < RW * RW; idx += blockDim.x) {
    const int wr = HALO + idx / RW, wc = HALO + idx % RW;
    const int w = wr * WIN + wc;
    const int gr = r0 + wr, gc = c0 + wc;
    float r = 0.f;
    if (inside(p.n, p.m, gr, gc)) {
      const float* cg = c + static_cast<long>(gr) * p.m + gc;
      r = sb[w] - apply_var(su + w, WIN, wr, wc, cg, nm);
    }
    sb[w] = r;
  }
  __syncthreads();
  store_tile(su, u_out, p, r0, c0);

  // coarse point (ci, cj) reads fine rows/columns 2ci..2ci+2, 2cj..2cj+2:
  // the row taps first, then the column taps (rbgs_var.py:261-266)
  const int nc = (p.n - 1) / 2, mc = (p.m - 1) / 2;
  constexpr int CT = TILE / 2;
  for (int idx = threadIdx.x; idx < CT * CT; idx += blockDim.x) {
    const int i = idx / CT, j = idx - i * CT;
    const int ci = blockIdx.y * CT + i, cj = blockIdx.x * CT + j;
    if (ci >= nc || cj >= mc) continue;
    const float* r = sb + (HALO + 2 * i) * WIN + HALO + 2 * j;
    float acc = 0.f;
    for (int e = 0; e < 3; ++e) {
      const float rows = p.tr[0] * r[e] + p.tr[1] * r[WIN + e] +
                         p.tr[2] * r[2 * WIN + e];
      acc += p.tc[e] * rows;
    }
    rc[static_cast<long>(ci) * mc + cj] = acc;
  }
}

__global__ void __launch_bounds__(THREADS)
upleg_var_kernel(const float* __restrict__ u, const float* __restrict__ e,
                 const float* __restrict__ b, const float* __restrict__ c,
                 const float* __restrict__ omegas, float* __restrict__ u_out,
                 VarLeg p) {
  extern __shared__ float smem[];
  float* sb = smem;
  float* su = smem + WIN * WIN;
  float* alt = smem + 2 * WIN * WIN;
  float* se = smem + 3 * WIN * WIN;
  const int r0 = blockIdx.y * TILE - HALO, c0 = blockIdx.x * TILE - HALO;
  // r0 and c0 are even: coarse index (r0 / 2 - 1) feeds the window's first
  // even fine row through its w[+1] tap
  const int cr0 = r0 / 2 - 1, cc0 = c0 / 2 - 1;
  const int nc = (p.n - 1) / 2, mc = (p.m - 1) / 2;
  load_window(u, b, su, sb, p, r0, c0);
  for (int idx = threadIdx.x; idx < CWIN * CWIN; idx += blockDim.x) {
    const int i = idx / CWIN, j = idx - i * CWIN;
    const int ci = cr0 + i, cj = cc0 + j;
    const bool in = ci >= 0 && ci < nc && cj >= 0 && cj < mc;
    se[idx] = in ? e[static_cast<long>(ci) * mc + cj] : 0.f;
  }
  __syncthreads();

  // u += omega_0 * P(e) over the whole window, halo included: fine index
  // 2i+1+o takes taps[o+1] * e[i] on each axis; the column expansion
  // first, then the row expansion (rbgs_var.py:348-355)
  const float om0 = omegas[p.om[0]];
  for (int idx = threadIdx.x; idx < WIN * WIN; idx += blockDim.x) {
    const int wr = idx / WIN, wc = idx - wr * WIN;
    const int gr = r0 + wr, gc = c0 + wc;
    if (!inside(p.n, p.m, gr, gc)) continue;
    float col[2];
    const int rows[2] = {(gr & 1) ? (gr - 1) / 2 : gr / 2 - 1, gr / 2};
    for (int k = 0; k < 2; ++k) {
      const float* er = se + (rows[k] - cr0) * CWIN;
      col[k] = (gc & 1) ? p.tc[1] * er[(gc - 1) / 2 - cc0]
                        : p.tc[2] * er[gc / 2 - 1 - cc0] +
                              p.tc[0] * er[gc / 2 - cc0];
    }
    const float corr = (gr & 1) ? p.tr[1] * col[0]
                                : p.tr[2] * col[0] + p.tr[0] * col[1];
    su[idx] += om0 * corr;
  }
  __syncthreads();
  su = var_sweeps(su, alt, sb, c, omegas, p, 1, r0, c0);
  store_tile(su, u_out, p, r0, c0);
}

// One half-sweep of colour `parity` of the standalone sweep on the window
// cells whose row and column indices both lie in [lo, SWIN - 1 - lo].
__device__ void var_half_sweep(float* su, const float* sb,
                               const float* __restrict__ c, float om, int n,
                               int m, int r0, int c0, int parity, int lo) {
  const long nm = static_cast<long>(n) * m;
  const int span = SWIN - 2 * lo;
  for (int idx = threadIdx.x; idx < span * span; idx += blockDim.x) {
    const int wr = lo + idx / span, wc = lo + idx % span;
    const int gr = r0 + wr, gc = c0 + wc;
    if (!inside(n, m, gr, gc) || ((gr + gc) & 1) != parity) continue;
    const int w = wr * SWIN + wc;
    const float* cg = c + static_cast<long>(gr) * m + gc;
    const float au = apply_var(su + w, SWIN, wr, wc, cg, nm);
    const float dinv = om / __ldg(cg);
    su[w] = su[w] + dinv * (sb[w] - au);
  }
}

__global__ void __launch_bounds__(THREADS)
rbgs_var_kernel(const float* __restrict__ u, const float* __restrict__ b,
                const float* __restrict__ c,
                const float* __restrict__ omegas, float* __restrict__ out,
                int om_id, int n, int m) {
  extern __shared__ float smem[];
  float* su = smem;
  float* sb = smem + SWIN * SWIN;
  const int r0 = blockIdx.y * TILE - 2, c0 = blockIdx.x * TILE - 2;
  for (int idx = threadIdx.x; idx < SWIN * SWIN; idx += blockDim.x) {
    const int gr = r0 + idx / SWIN, gc = c0 + idx % SWIN;
    const bool in = inside(n, m, gr, gc);
    const long g = static_cast<long>(gr) * m + gc;
    su[idx] = in ? u[g] : 0.f;
    sb[idx] = in ? b[g] : 0.f;
  }
  __syncthreads();
  const float om = omegas[om_id];
  var_half_sweep(su, sb, c, om, n, m, r0, c0, 0, 1);  // red: tile + ring
  __syncthreads();
  var_half_sweep(su, sb, c, om, n, m, r0, c0, 1, 2);  // black: the tile
  __syncthreads();
  for (int idx = threadIdx.x; idx < TILE * TILE; idx += blockDim.x) {
    const int gr = r0 + 2 + idx / TILE, gc = c0 + 2 + idx % TILE;
    if (gr < n && gc < m)
      out[static_cast<long>(gr) * m + gc] =
          su[(2 + idx / TILE) * SWIN + 2 + idx % TILE];
  }
}

__global__ void __launch_bounds__(JAC_BX * JAC_BY)
jacobi_var_kernel(const float* __restrict__ u, const float* __restrict__ b,
                  const float* __restrict__ c,
                  const float* __restrict__ omegas, float* __restrict__ out,
                  int om_id, int n, int m) {
  const int j = blockIdx.x * JAC_BX + threadIdx.x;
  const int i = blockIdx.y * JAC_BY + threadIdx.y;
  if (i >= n || j >= m) return;
  const long nm = static_cast<long>(n) * m;
  const long g = static_cast<long>(i) * m + j;
  const float up = i > 0 ? u[g - m] : 0.f;
  const float dn = i < n - 1 ? u[g + m] : 0.f;
  const float lf = j > 0 ? u[g - 1] : 0.f;
  const float rt = j < m - 1 ? u[g + 1] : 0.f;
  const float* cg = c + g;
  const float v = u[g];
  const float au = __ldg(cg) * v + __ldg(cg + nm) * up +
                   __ldg(cg + 2 * nm) * dn + __ldg(cg + 3 * nm) * lf +
                   __ldg(cg + 4 * nm) * rt;
  const float dinv = omegas[om_id] / __ldg(cg);
  out[g] = v + dinv * (b[g] - au);
}

VarLeg make_leg(const double* taps, const int* om_ids, int n_ids, int sweeps,
                int red_black, int n, int m) {
  VarLeg p;
  for (int k = 0; k < 3; ++k) {
    p.tr[k] = static_cast<float>(taps[k]);
    p.tc[k] = static_cast<float>(taps[3 + k]);
  }
  for (int k = 0; k <= MAX_SWEEPS; ++k) p.om[k] = k < n_ids ? om_ids[k] : 0;
  p.sweeps = sweeps;
  p.red_black = red_black ? 1 : 0;
  p.n = n;
  p.m = m;
  return p;
}

// Shared memory above 48 KB needs an explicit opt-in per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

dim3 tiles(int n, int m) {
  return dim3((m + TILE - 1) / TILE, (n + TILE - 1) / TILE);
}

bool bad_shape(int n, int m) { return n < 3 || m < 3 || !(n & 1) || !(m & 1); }

}  // namespace

// c: the (5, n, m) coefficient stack.  om: index of the relaxation factor
// in omegas.  red_black: 1 one red-black sweep, 0 one Jacobi sweep.
// Returns the launch's cudaError_t.
extern "C" int es_sweep_var(const float* u, const float* b, const float* c,
                            const float* omegas, int om, int red_black,
                            float* out, int n, int m, void* stream) {
  if (n < 1 || m < 1) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (red_black) {
    rbgs_var_kernel<<<tiles(n, m), THREADS, SWEEP_SMEM, s>>>(u, b, c, omegas,
                                                             out, om, n, m);
  } else {
    const dim3 grid((m + JAC_BX - 1) / JAC_BX, (n + JAC_BY - 1) / JAC_BY);
    jacobi_var_kernel<<<grid, dim3(JAC_BX, JAC_BY), 0, s>>>(u, b, c, omegas,
                                                            out, om, n, m);
  }
  return cudaGetLastError();
}

// taps: 3 row taps, 3 column taps.  om_ids: `sweeps` indices into omegas,
// in the order the sweeps run.
extern "C" int es_presmooth_residual_restrict_var(
    const float* u, const float* b, const float* c, const float* omegas,
    const int* om_ids, int sweeps, int red_black, const double* taps,
    float* u_out, float* rc, int n, int m, void* stream) {
  if (sweeps < 1 || sweeps > MAX_SWEEPS || bad_shape(n, m))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(downleg_var_kernel, DOWN_SMEM);
  if (err != cudaSuccess) return err;
  const VarLeg p = make_leg(taps, om_ids, sweeps, sweeps, red_black, n, m);
  downleg_var_kernel<<<tiles(n, m), THREADS, DOWN_SMEM,
                       static_cast<cudaStream_t>(stream)>>>(u, b, c, omegas,
                                                            u_out, rc, p);
  return cudaGetLastError();
}

// om_ids: 1 + sweeps indices into omegas: the coarse-grid-correction factor,
// then the post-sweeps in the order they run.
extern "C" int es_prolong_correct_postsmooth_var(
    const float* u, const float* e, const float* b, const float* c,
    const float* omegas, const int* om_ids, int sweeps, int red_black,
    const double* taps, float* u_out, int n, int m, void* stream) {
  if (sweeps < 1 || sweeps > MAX_SWEEPS || bad_shape(n, m))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(upleg_var_kernel, UP_SMEM);
  if (err != cudaSuccess) return err;
  const VarLeg p = make_leg(taps, om_ids, sweeps + 1, sweeps, red_black, n, m);
  upleg_var_kernel<<<tiles(n, m), THREADS, UP_SMEM,
                     static_cast<cudaStream_t>(stream)>>>(u, e, b, c, omegas,
                                                          u_out, p);
  return cudaGetLastError();
}
