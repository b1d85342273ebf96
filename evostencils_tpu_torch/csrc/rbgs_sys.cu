// Coupled-system smoother kernels for Hopper (sm_90a), float32: an F x F
// system of 9-point blocks, F = NF = 2 (linear elasticity, split-complex
// Helmholtz).
//
// The operator is a coefficient table c[i][j][k]: block (i, j)'s
// coefficient at offset k of NINE_OFFSETS = (0,0), (-1,0), (+1,0), (0,-1),
// (0,+1), (-1,-1), (-1,+1), (+1,-1), (+1,+1) (rows first), zero outside the
// grid.  Every half-sweep forms each field's residual from the state before
// it, r_i = b_i - sum_j sum_k c[i][j][k] u_j(x + o_k), summed over j, then k,
// plus the center fixups of its row; then u_i += omega * (sum_j minv[i][j]
// r_j, plus the point-solve fixups of its row) on the points of its colour
// (rbgs_sys.py:146-171, :279-323).  The red half updates every field before
// the black half of any field starts.  The sweep and the legs share this
// one order.  A zero coefficient's product is added too: that is exact.
//
// es_sweep_sys replaces the TPU kernel
//   evostencils_tpu/ops/pallas/rbgs_sys.py fused_rbgs_sweep_sys /
//   jacobi_sweep_sys (_fused_sys_kernel): one red-black sweep (red, then
//   black with the new red values) or one Jacobi sweep.
// es_presmooth_residual_restrict_sys replaces
//   rbgs_sys.py presmooth_residual_restrict_sys (_sys_smooth_rr_kernel):
//   S in [1, 3] red-black or Jacobi sweeps, then every field's residual and
//   its separable 3-tap 2:1 restriction (the row taps, then the column
//   taps), writing F x u_s (n, m) and F x rc ((n-1)/2, (m-1)/2).
// es_prolong_correct_postsmooth_sys replaces
//   rbgs_sys.py prolong_correct_postsmooth_sys (_sys_pc_smooth_kernel):
//   u_i += omega_0 * P(e_i) with the separable 3-tap 1:2 prolongation (the
//   column expansion, then the row expansion), then S in [1, 3] sweeps with
//   omega_1..S.
//
// Row fixups (exc / exc_minv, rbgs_sys.py:73-93): up to MAX_EXC axis-0 rows
// whose center coefficients, and up to MAX_EXC whose point-solve matrix,
// differ from the table's by constant F x F deltas.
//
// What bounds them: device-memory bytes.  A sweep must read u and b of
// every field once and write u once (12 bytes a point a field); a leg moves
// the coarse arrays besides.  The arithmetic is about 25 flops a point, a
// field and a half-sweep.
//
// Design.  The tile walk is rbgs_var.cu's: each leg block owns a 64 x 64
// fine tile and loads u and b of both fields with an 8-cell halo into shared
// memory (2 * 2 * 80 * 80 * 4 = 102,400 bytes), recomputing the halo
// redundantly; window-edge cells see zeros in place of their out-of-window
// neighbours, and the error moves inward one cell (in the Chebyshev norm,
// for a 9-point stencil) per half-sweep, so HALO = 8 covers 3 red-black
// sweeps, the residual and the restriction.  A red point's corner neighbours
// are red, so a half-sweep cannot update in place: each thread first
// computes the new values of all its points of the colour into registers,
// the block synchronises, and then writes them; this serves the Jacobi
// sweeps as well, without a second window.  The up-leg reads e through the
// read-only cache.  The standalone red-black sweep is rbgs.cu's: a 68 x 68
// window with a 2-cell halo, red on the tile and a one-cell ring (a black
// point's new value needs only its four axis neighbours red), then black on
// the tile; the Jacobi sweep is one thread a point writing buffers it does
// not read.  Tiles start at even interior indices and red is an even sum of
// interior indices.  Cells outside the grid hold 0 and are never updated.
// Relaxation factors are read from the device vector by index.

#include <cuda_runtime.h>

namespace {

constexpr int NF = 2;                  // fields the kernels are built for
constexpr int MAX_EXC = 4;
constexpr int MAX_SWEEPS = 3;
constexpr int THREADS = 512;
constexpr int TILE = 64;
constexpr int HALO = 8;
constexpr int WIN = TILE + 2 * HALO;   // fine window edge of the legs
constexpr int SWIN = TILE + 4;         // standalone red-black sweep window
constexpr int LEG_SMEM = 2 * NF * WIN * WIN * sizeof(float);
constexpr int SWEEP_SMEM = 2 * NF * SWIN * SWIN * sizeof(float);
constexpr int JAC_BX = 32, JAC_BY = 8;

// The operator: coefficient table, point-solve matrix, row fixups.
struct SysOp {
  float c[NF][NF][9];
  float minv[NF][NF];
  int n_exc, n_exc_minv;
  int exc_row[MAX_EXC], exc_minv_row[MAX_EXC];
  float exc[MAX_EXC][NF][NF], exc_minv[MAX_EXC][NF][NF];
};

// The tensors: F fields, right-hand sides, outputs, coarse arrays.
struct SysPtrs {
  const float* u[NF];
  const float* b[NF];
  const float* e[NF];
  float* out[NF];
  float* rc[NF];
};

struct SysLeg {
  float tr[3], tc[3];           // row and column transfer taps
  int om[MAX_SWEEPS + 1];       // indices into the relaxation-factor vector
  int sweeps;
  int red_black;                // 1 red-black sweeps, 0 Jacobi sweeps
  int n, m;
};

__device__ __forceinline__ bool inside(int n, int m, int gr, int gc) {
  return gr >= 0 && gr < n && gc >= 0 && gc < m;
}

// The nine values around s in a window of edge W (NINE_OFFSETS order);
// neighbours outside the window read as 0.
template <int W>
__device__ __forceinline__ void nine(const float* s, int wr, int wc,
                                     float v[9]) {
  const bool up = wr > 0, dn = wr < W - 1, lf = wc > 0, rt = wc < W - 1;
  v[0] = s[0];
  v[1] = up ? s[-W] : 0.f;
  v[2] = dn ? s[W] : 0.f;
  v[3] = lf ? s[-1] : 0.f;
  v[4] = rt ? s[1] : 0.f;
  v[5] = up && lf ? s[-W - 1] : 0.f;
  v[6] = up && rt ? s[-W + 1] : 0.f;
  v[7] = dn && lf ? s[W - 1] : 0.f;
  v[8] = dn && rt ? s[W + 1] : 0.f;
}

// r_i = b_i - (A u)_i at a point of global row gr whose neighbourhoods are
// v[j][k].
__device__ __forceinline__ void residuals(const float v[NF][9],
                                          const float b[NF], int gr,
                                          const SysOp& p, float r[NF]) {
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    float au = 0.f;
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int k = 0; k < 9; ++k) au += p.c[i][j][k] * v[j][k];
    for (int e = 0; e < p.n_exc; ++e)
      if (p.exc_row[e] == gr)
#pragma unroll
        for (int j = 0; j < NF; ++j) au += p.exc[e][i][j] * v[j][0];
    r[i] = b[i] - au;
  }
}

// The new values u_i + omega * (minv r)_i at a point of global row gr.
__device__ __forceinline__ void point_update(const float v[NF][9],
                                             const float b[NF], int gr,
                                             const SysOp& p, float om,
                                             float out[NF]) {
  float r[NF];
  residuals(v, b, gr, p, r);
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    float upd = 0.f;
#pragma unroll
    for (int j = 0; j < NF; ++j) upd += p.minv[i][j] * r[j];
    for (int e = 0; e < p.n_exc_minv; ++e)
      if (p.exc_minv_row[e] == gr)
#pragma unroll
        for (int j = 0; j < NF; ++j) upd += p.exc_minv[e][i][j] * r[j];
    out[i] = v[i][0] + om * upd;
  }
}

// Field f's window is su + f * W * W (and sb + f * W * W).
template <int W>
__device__ __forceinline__ void window_point(const float* su, const float* sb,
                                             int idx, int wr, int wc,
                                             float v[NF][9], float b[NF]) {
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    nine<W>(su + f * W * W + idx, wr, wc, v[f]);
    b[f] = sb[f * W * W + idx];
  }
}

// One half-sweep on the window cells whose row and column indices lie in
// [lo, W - 1 - lo]: colour `parity` (0 red, 1 black), or every cell (-1, a
// Jacobi sweep).  The new values are staged in registers and written after
// the block has read all the old ones.
template <int W>
__device__ void half_sweep(float* su, const float* sb, const SysOp& p,
                           float om, int n, int m, int r0, int c0, int parity,
                           int lo) {
  constexpr int K = (W * W + THREADS - 1) / THREADS;
  float nv[K][NF];
  unsigned todo = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int idx = threadIdx.x + k * THREADS;
    if (idx >= W * W) continue;
    const int wr = idx / W, wc = idx - wr * W;
    if (wr < lo || wr > W - 1 - lo || wc < lo || wc > W - 1 - lo) continue;
    const int gr = r0 + wr, gc = c0 + wc;
    if (!inside(n, m, gr, gc)) continue;
    if (parity >= 0 && ((gr + gc) & 1) != parity) continue;
    float v[NF][9], b[NF];
    window_point<W>(su, sb, idx, wr, wc, v, b);
    point_update(v, b, gr, p, om, nv[k]);
    todo |= 1u << k;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (!(todo & (1u << k))) continue;
    const int idx = threadIdx.x + k * THREADS;
#pragma unroll
    for (int f = 0; f < NF; ++f) su[f * W * W + idx] = nv[k][f];
  }
  __syncthreads();
}

// u and b of every field over the window of edge W whose top-left interior
// index is (r0, c0); zeros outside the grid.
template <int W>
__device__ void load_window(const SysPtrs& t, float* su, float* sb, int n,
                            int m, int r0, int c0) {
  for (int idx = threadIdx.x; idx < W * W; idx += blockDim.x) {
    const int wr = idx / W, wc = idx - wr * W;
    const int gr = r0 + wr, gc = c0 + wc;
    const bool in = inside(n, m, gr, gc);
    const long g = static_cast<long>(gr) * m + gc;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      su[f * W * W + idx] = in ? t.u[f][g] : 0.f;
      sb[f * W * W + idx] = in ? t.b[f][g] : 0.f;
    }
  }
}

// The TILE x TILE interior of the window (halo h) of every field to out.
template <int W>
__device__ void store_tile(const float* su, const SysPtrs& t, int n, int m,
                           int r0, int c0, int h) {
  for (int idx = threadIdx.x; idx < TILE * TILE; idx += blockDim.x) {
    const int i = idx / TILE, j = idx - i * TILE;
    const int gr = r0 + h + i, gc = c0 + h + j;
    if (!inside(n, m, gr, gc)) continue;
    const long g = static_cast<long>(gr) * m + gc;
#pragma unroll
    for (int f = 0; f < NF; ++f)
      t.out[f][g] = su[f * W * W + (h + i) * W + h + j];
  }
}

// p.sweeps sweeps on the leg window with factors omegas[L.om[om_first]],
// omegas[L.om[om_first + 1]], ...
__device__ void leg_sweeps(float* su, const float* sb, const SysOp& p,
                           const SysLeg& L, const float* __restrict__ omegas,
                           int om_first, int r0, int c0) {
  for (int s = 0; s < L.sweeps; ++s) {
    const float om = omegas[L.om[om_first + s]];
    if (L.red_black) {
      half_sweep<WIN>(su, sb, p, om, L.n, L.m, r0, c0, 0, 0);
      half_sweep<WIN>(su, sb, p, om, L.n, L.m, r0, c0, 1, 0);
    } else {
      half_sweep<WIN>(su, sb, p, om, L.n, L.m, r0, c0, -1, 0);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
downleg_sys_kernel(SysPtrs t, SysOp p, SysLeg L,
                   const float* __restrict__ omegas) {
  extern __shared__ float smem[];
  float* su = smem;
  float* sb = smem + NF * WIN * WIN;
  const int r0 = blockIdx.y * TILE - HALO, c0 = blockIdx.x * TILE - HALO;
  load_window<WIN>(t, su, sb, L.n, L.m, r0, c0);
  __syncthreads();
  leg_sweeps(su, sb, p, L, omegas, 0, r0, c0);

  // every field's residual, in place of its b, on the rows and columns the
  // restriction reads: window indices HALO .. HALO + TILE (inclusive) on
  // both axes; zero outside the grid
  constexpr int RW = TILE + 1;
  for (int idx = threadIdx.x; idx < RW * RW; idx += blockDim.x) {
    const int wr = HALO + idx / RW, wc = HALO + idx % RW;
    const int w = wr * WIN + wc;
    const int gr = r0 + wr, gc = c0 + wc;
    float r[NF] = {};
    if (inside(L.n, L.m, gr, gc)) {
      float v[NF][9], b[NF];
      window_point<WIN>(su, sb, w, wr, wc, v, b);
      residuals(v, b, gr, p, r);
    }
#pragma unroll
    for (int f = 0; f < NF; ++f) sb[f * WIN * WIN + w] = r[f];
  }
  __syncthreads();
  store_tile<WIN>(su, t, L.n, L.m, r0, c0, HALO);

  // coarse point (ci, cj) reads fine rows/columns 2ci..2ci+2, 2cj..2cj+2:
  // the row taps first, then the column taps (rbgs_sys.py:348-354)
  const int nc = (L.n - 1) / 2, mc = (L.m - 1) / 2;
  constexpr int CT = TILE / 2;
  for (int idx = threadIdx.x; idx < CT * CT; idx += blockDim.x) {
    const int i = idx / CT, j = idx - i * CT;
    const int ci = blockIdx.y * CT + i, cj = blockIdx.x * CT + j;
    if (ci >= nc || cj >= mc) continue;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const float* r = sb + f * WIN * WIN + (HALO + 2 * i) * WIN + HALO + 2 * j;
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const float rows = L.tr[0] * r[e] + L.tr[1] * r[WIN + e] +
                           L.tr[2] * r[2 * WIN + e];
        acc += L.tc[e] * rows;
      }
      t.rc[f][static_cast<long>(ci) * mc + cj] = acc;
    }
  }
}

__device__ __forceinline__ float coarse(const float* __restrict__ e, int nc,
                                        int mc, int ci, int cj) {
  return ci >= 0 && ci < nc && cj >= 0 && cj < mc
             ? __ldg(e + static_cast<long>(ci) * mc + cj)
             : 0.f;
}

__global__ void __launch_bounds__(THREADS)
upleg_sys_kernel(SysPtrs t, SysOp p, SysLeg L,
                 const float* __restrict__ omegas) {
  extern __shared__ float smem[];
  float* su = smem;
  float* sb = smem + NF * WIN * WIN;
  const int r0 = blockIdx.y * TILE - HALO, c0 = blockIdx.x * TILE - HALO;
  const int nc = (L.n - 1) / 2, mc = (L.m - 1) / 2;
  load_window<WIN>(t, su, sb, L.n, L.m, r0, c0);
  __syncthreads();

  // u += omega_0 * P(e) over the whole window, halo included: fine index
  // 2i+1+o takes taps[o+1] * e[i] on each axis; the column expansion first,
  // then the row expansion (rbgs_sys.py:436-445)
  const float om0 = omegas[L.om[0]];
  for (int idx = threadIdx.x; idx < WIN * WIN; idx += blockDim.x) {
    const int wr = idx / WIN, wc = idx - wr * WIN;
    const int gr = r0 + wr, gc = c0 + wc;
    if (!inside(L.n, L.m, gr, gc)) continue;
    const int rows[2] = {(gr & 1) ? (gr - 1) / 2 : gr / 2 - 1, gr / 2};
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      float col[2];
#pragma unroll
      for (int k = 0; k < 2; ++k)
        col[k] = (gc & 1)
                     ? L.tc[1] * coarse(t.e[f], nc, mc, rows[k], (gc - 1) / 2)
                     : L.tc[2] * coarse(t.e[f], nc, mc, rows[k], gc / 2 - 1) +
                           L.tc[0] * coarse(t.e[f], nc, mc, rows[k], gc / 2);
      const float corr = (gr & 1) ? L.tr[1] * col[0]
                                  : L.tr[2] * col[0] + L.tr[0] * col[1];
      su[f * WIN * WIN + idx] += om0 * corr;
    }
  }
  __syncthreads();
  leg_sweeps(su, sb, p, L, omegas, 1, r0, c0);
  store_tile<WIN>(su, t, L.n, L.m, r0, c0, HALO);
}

__global__ void __launch_bounds__(THREADS)
rbgs_sys_kernel(SysPtrs t, SysOp p, const float* __restrict__ omegas,
                int om_id, int n, int m) {
  extern __shared__ float smem[];
  float* su = smem;
  float* sb = smem + NF * SWIN * SWIN;
  const int r0 = blockIdx.y * TILE - 2, c0 = blockIdx.x * TILE - 2;
  load_window<SWIN>(t, su, sb, n, m, r0, c0);
  __syncthreads();
  const float om = omegas[om_id];
  half_sweep<SWIN>(su, sb, p, om, n, m, r0, c0, 0, 1);  // red: tile + ring
  half_sweep<SWIN>(su, sb, p, om, n, m, r0, c0, 1, 2);  // black: the tile
  store_tile<SWIN>(su, t, n, m, r0, c0, 2);
}

__global__ void __launch_bounds__(JAC_BX * JAC_BY)
jacobi_sys_kernel(SysPtrs t, SysOp p, const float* __restrict__ omegas,
                  int om_id, int n, int m) {
  const int j = blockIdx.x * JAC_BX + threadIdx.x;
  const int i = blockIdx.y * JAC_BY + threadIdx.y;
  if (i >= n || j >= m) return;
  const long g = static_cast<long>(i) * m + j;
  const bool up = i > 0, dn = i < n - 1, lf = j > 0, rt = j < m - 1;
  float v[NF][9], b[NF], out[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const float* s = t.u[f] + g;
    v[f][0] = s[0];
    v[f][1] = up ? s[-m] : 0.f;
    v[f][2] = dn ? s[m] : 0.f;
    v[f][3] = lf ? s[-1] : 0.f;
    v[f][4] = rt ? s[1] : 0.f;
    v[f][5] = up && lf ? s[-m - 1] : 0.f;
    v[f][6] = up && rt ? s[-m + 1] : 0.f;
    v[f][7] = dn && lf ? s[m - 1] : 0.f;
    v[f][8] = dn && rt ? s[m + 1] : 0.f;
    b[f] = t.b[f][g];
  }
  point_update(v, b, i, p, omegas[om_id], out);
#pragma unroll
  for (int f = 0; f < NF; ++f) t.out[f][g] = out[f];
}

// table: F*F*9 coefficients, then the F*F point-solve matrix.  rows and
// vals: the n_exc center fixups, then the n_exc_minv point-solve fixups
// (one row and F*F deltas each).  false when the kernels do not take them.
bool make_op(int F, const double* table, int n_exc, int n_exc_minv,
             const int* rows, const double* vals, SysOp* p) {
  if (F != NF || n_exc < 0 || n_exc > MAX_EXC || n_exc_minv < 0 ||
      n_exc_minv > MAX_EXC)
    return false;
  for (int i = 0; i < NF; ++i)
    for (int j = 0; j < NF; ++j) {
      for (int k = 0; k < 9; ++k)
        p->c[i][j][k] = static_cast<float>(table[(i * NF + j) * 9 + k]);
      p->minv[i][j] = static_cast<float>(table[NF * NF * 9 + i * NF + j]);
    }
  p->n_exc = n_exc;
  p->n_exc_minv = n_exc_minv;
  for (int e = 0; e < MAX_EXC; ++e) {
    p->exc_row[e] = e < n_exc ? rows[e] : -1;
    p->exc_minv_row[e] = e < n_exc_minv ? rows[n_exc + e] : -1;
    for (int i = 0; i < NF; ++i)
      for (int j = 0; j < NF; ++j) {
        p->exc[e][i][j] =
            e < n_exc ? static_cast<float>(vals[(e * NF + i) * NF + j]) : 0.f;
        p->exc_minv[e][i][j] =
            e < n_exc_minv
                ? static_cast<float>(vals[((n_exc + e) * NF + i) * NF + j])
                : 0.f;
      }
  }
  return true;
}

SysPtrs make_ptrs(const void* const* u, const void* const* b,
                  const void* const* e, void* const* out, void* const* rc) {
  SysPtrs t = {};
  for (int f = 0; f < NF; ++f) {
    t.u[f] = static_cast<const float*>(u[f]);
    t.b[f] = static_cast<const float*>(b[f]);
    t.e[f] = e ? static_cast<const float*>(e[f]) : nullptr;
    t.out[f] = static_cast<float*>(out[f]);
    t.rc[f] = rc ? static_cast<float*>(rc[f]) : nullptr;
  }
  return t;
}

SysLeg make_leg(const double* taps, const int* om_ids, int n_ids, int sweeps,
                int red_black, int n, int m) {
  SysLeg L;
  for (int k = 0; k < 3; ++k) {
    L.tr[k] = static_cast<float>(taps[k]);
    L.tc[k] = static_cast<float>(taps[3 + k]);
  }
  for (int k = 0; k <= MAX_SWEEPS; ++k) L.om[k] = k < n_ids ? om_ids[k] : 0;
  L.sweeps = sweeps;
  L.red_black = red_black ? 1 : 0;
  L.n = n;
  L.m = m;
  return L;
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

// u, b, out: F field pointers each.  om_id: index of the relaxation factor
// in omegas.  red_black: 1 one red-black sweep, 0 one Jacobi sweep.
// Returns the launch's cudaError_t.
extern "C" int es_sweep_sys(const void* const* u, const void* const* b,
                            void* const* out, int F, const double* table,
                            int n_exc, int n_exc_minv, const int* rows,
                            const double* vals, const float* omegas, int om_id,
                            int red_black, int n, int m, void* stream) {
  SysOp p;
  if (n < 1 || m < 1 || !make_op(F, table, n_exc, n_exc_minv, rows, vals, &p))
    return cudaErrorInvalidValue;
  const SysPtrs t = make_ptrs(u, b, nullptr, out, nullptr);
  const auto s = static_cast<cudaStream_t>(stream);
  if (red_black) {
    cudaError_t err = allow_smem(rbgs_sys_kernel, SWEEP_SMEM);
    if (err != cudaSuccess) return err;
    rbgs_sys_kernel<<<tiles(n, m), THREADS, SWEEP_SMEM, s>>>(t, p, omegas,
                                                             om_id, n, m);
  } else {
    const dim3 grid((m + JAC_BX - 1) / JAC_BX, (n + JAC_BY - 1) / JAC_BY);
    jacobi_sys_kernel<<<grid, dim3(JAC_BX, JAC_BY), 0, s>>>(t, p, omegas,
                                                            om_id, n, m);
  }
  return cudaGetLastError();
}

// taps: 3 row taps, 3 column taps.  om_ids: `sweeps` indices into omegas,
// in the order the sweeps run.
extern "C" int es_presmooth_residual_restrict_sys(
    const void* const* u, const void* const* b, void* const* u_out,
    void* const* rc, int F, const double* table, int n_exc, int n_exc_minv,
    const int* rows, const double* vals, const float* omegas,
    const int* om_ids, int sweeps, int red_black, const double* taps, int n,
    int m, void* stream) {
  SysOp p;
  if (sweeps < 1 || sweeps > MAX_SWEEPS || bad_shape(n, m) ||
      !make_op(F, table, n_exc, n_exc_minv, rows, vals, &p))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(downleg_sys_kernel, LEG_SMEM);
  if (err != cudaSuccess) return err;
  const SysPtrs t = make_ptrs(u, b, nullptr, u_out, rc);
  const SysLeg L = make_leg(taps, om_ids, sweeps, sweeps, red_black, n, m);
  downleg_sys_kernel<<<tiles(n, m), THREADS, LEG_SMEM,
                       static_cast<cudaStream_t>(stream)>>>(t, p, L, omegas);
  return cudaGetLastError();
}

// om_ids: 1 + sweeps indices into omegas: the coarse-grid-correction factor,
// then the post-sweeps in the order they run.
extern "C" int es_prolong_correct_postsmooth_sys(
    const void* const* u, const void* const* e, const void* const* b,
    void* const* u_out, int F, const double* table, int n_exc,
    int n_exc_minv, const int* rows, const double* vals, const float* omegas,
    const int* om_ids, int sweeps, int red_black, const double* taps, int n,
    int m, void* stream) {
  SysOp p;
  if (sweeps < 1 || sweeps > MAX_SWEEPS || bad_shape(n, m) ||
      !make_op(F, table, n_exc, n_exc_minv, rows, vals, &p))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(upleg_sys_kernel, LEG_SMEM);
  if (err != cudaSuccess) return err;
  const SysPtrs t = make_ptrs(u, b, e, u_out, nullptr);
  const SysLeg L = make_leg(taps, om_ids, sweeps + 1, sweeps, red_black, n, m);
  upleg_sys_kernel<<<tiles(n, m), THREADS, LEG_SMEM,
                     static_cast<cudaStream_t>(stream)>>>(t, p, L, omegas);
  return cudaGetLastError();
}
