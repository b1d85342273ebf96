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
// field and a half-sweep.  The legs do not reach that bound: each block
// recomputes its halo and runs its passes one after another, at two
// blocks an SM (PERF.md section 6 has their times against it).
//
// Design of the red-black sweep (rbgs_sys_kernel<FIX>): the legs' passes
// with no transfer.  A block owns a tile and stages u and b of both fields
// over a window two cells wider on every side (halo 2), zero outside the
// grid, by 4-byte cp.async (rows of 2047 and 255 floats are only 4-byte
// aligned), all of a thread's copies in flight before one wait, in the
// legs' layout split by column parity.  Red updates the window cells at a
// distance >= 1 from the window edge, black those at >= 2 (PassCells,
// rb_pass): their neighbours all lie in the window, so no read is
// predicated, and the tile (distance >= 2) is right after both.  A pass
// takes only the items of its colour, every lane busy; a red point's
// corner neighbours are red, so a pass cannot update in place: its new
// values are staged in registers across a barrier.  Row fixups are a
// template parameter, so linear elasticity runs no fixup loop.  The
// window is SweepWin's, 16 x 64 cells in 256-thread blocks, 16,384 bytes
// of static shared memory (no opt-in above 48 KB), five blocks an SM.  On
// the H100 it was the fastest of the 8 x 64, 16 x 64, 32 x 64 and 64 x 64
// windows at 2047^2, and staging b beat reading it through the read-only
// cache by 11%; 8 x 64 won 0.0005 ms at 255^2 and lost 0.0100 at 2047^2,
// too little for a second window class (PERF.md section 6).
// es_sweep_sys_info reports it from the card, and
// tests/test_torch_sys_tiles.py emulates its schedule in float64.  The
// Jacobi sweep is one thread a point writing buffers it does not read.
//
// Design of the legs.  Each 512-thread block owns a TILE x TILE fine tile
// and stages only u's window of both fields, with a halo sized to the
// leg: P = 2S half-sweeps (red-black) or S sweeps (Jacobi), halo P + 2 on
// the down-leg (the residual and the restriction's extra row read one cell
// past the tile) and P on the up-leg (the prolongation is pointwise).
// Pass p updates only the window cells at a Chebyshev distance >= p from
// the window edge: their neighbours all lie in the window, so no read is
// predicated, and the cells that are still right after pass p are exactly
// those at distance >= p.  b is read through the read-only cache where a
// point updates and in the residual.  The window is stored split by column
// parity (each row: its even columns, then its odd ones), so the cells of
// one colour in a row are contiguous: in a red-black pass a thread takes
// the cell of that colour of a horizontal pair, every lane busy, and the
// nine neighbour reads of a warp are bank-conflict free.  A red-black pass
// stages its new values in registers and writes them after a barrier; a
// Jacobi pass updates every cell of its region from one window into a
// second one, which keeps the registers under the two-block budget.  The
// down-leg forms the residual of the tile and its extra row and column
// (red-black: in registers, then over the window; Jacobi: into the free
// window) and restricts from there.  The up-leg stages e's coarse window
// once and prolongs from shared memory onto every window cell.  Kernels
// are instantiated per (leg, S, mode) and per whether the table has row
// fixups, so linear elasticity's path runs no fixup loop;
// __launch_bounds__(512, 2) keeps two blocks (32 warps) resident on an SM
// so that one block's loads overlap another's passes.  For the red-black
// V(2,1) the windows take 46,208 bytes (down, S = 2) and 36,992 + 10,368
// bytes (up, S = 1).
//
// Tiles start at even interior indices and red is an even sum of interior
// indices.  Cells outside the grid hold 0 and are never updated.
// Relaxation factors are read from the device vector by index.

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int NF = 2;                  // fields the kernels are built for
constexpr int MAX_EXC = 4;
constexpr int MAX_SWEEPS = 3;
constexpr int THREADS = 512;
constexpr int TILE = 64;              // a leg's fine tile
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
  int n, m;
};

__device__ __forceinline__ bool inside(int n, int m, int gr, int gc) {
  return gr >= 0 && gr < n && gc >= 0 && gc < m;
}

// r_i = b_i - (A u)_i at a point of global row gr whose neighbourhoods are
// v[j][k]; FIX adds the center fixups of the row.
template <bool FIX>
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
    if (FIX)
      for (int e = 0; e < p.n_exc; ++e)
        if (p.exc_row[e] == gr)
#pragma unroll
          for (int j = 0; j < NF; ++j) au += p.exc[e][i][j] * v[j][0];
    r[i] = b[i] - au;
  }
}

// The new values u_i + omega * (minv r)_i at a point of global row gr;
// FIX adds the fixups of the row.
template <bool FIX>
__device__ __forceinline__ void point_update(const float v[NF][9],
                                             const float b[NF], int gr,
                                             const SysOp& p, float om,
                                             float out[NF]) {
  float r[NF];
  residuals<FIX>(v, b, gr, p, r);
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    float upd = 0.f;
#pragma unroll
    for (int j = 0; j < NF; ++j) upd += p.minv[i][j] * r[j];
    if (FIX)
      for (int e = 0; e < p.n_exc_minv; ++e)
        if (p.exc_minv_row[e] == gr)
#pragma unroll
          for (int j = 0; j < NF; ++j) upd += p.exc_minv[e][i][j] * r[j];
    out[i] = v[i][0] + om * upd;
  }
}

// ---------------------------------------------------------------------------
// the standalone Jacobi sweep (the red-black sweep runs the legs' passes and
// follows them)
// ---------------------------------------------------------------------------

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
  point_update<true>(v, b, i, p, omegas[om_id], out);
#pragma unroll
  for (int f = 0; f < NF; ++f) t.out[f][g] = out[f];
}

// ---------------------------------------------------------------------------
// the legs
// ---------------------------------------------------------------------------

// Half-sweeps (red-black) or sweeps (Jacobi) of a leg, and its halo.
__host__ __device__ constexpr int leg_passes(int sweeps, bool red_black) {
  return red_black ? 2 * sweeps : sweeps;
}
__host__ __device__ constexpr int leg_halo(bool down, int sweeps,
                                           bool red_black) {
  return leg_passes(sweeps, red_black) + (down ? 2 : 0);
}
// u windows of a leg: red-black passes update one in place, Jacobi passes
// alternate between two.
__host__ __device__ constexpr int leg_windows(bool red_black) {
  return red_black ? 1 : 2;
}
// The window that holds u after pass p (after the load: p = 0).
__host__ __device__ constexpr int window_after(bool red_black, int p) {
  return red_black ? 0 : (p & 1);
}

// A leg window of edge W (even), one field: row wr holds its even columns
// at wr * W + wc / 2 and its odd ones at wr * W + W / 2 + wc / 2.
template <int W>
__device__ __forceinline__ int at(int wr, int wc) {
  return wr * W + (wc & 1) * (W / 2) + (wc >> 1);
}

// The nine values around window cell (wr, wc) of field window s
// (NINE_OFFSETS order); every neighbour lies in the window.
template <int W>
__device__ __forceinline__ void nine_split(const float* s, int wr, int wc,
                                           float v[9]) {
  const int c = at<W>(wr, wc);
  // the cells left and right of (wr, wc), in the other half of the row
  const int l = at<W>(wr, wc - 1) - c, r = at<W>(wr, wc + 1) - c;
  v[0] = s[c];
  v[1] = s[c - W];
  v[2] = s[c + W];
  v[3] = s[c + l];
  v[4] = s[c + r];
  v[5] = s[c - W + l];
  v[6] = s[c - W + r];
  v[7] = s[c + W + l];
  v[8] = s[c + W + r];
}

// The cells of pass LO (1-based) of a window of WR rows and W columns (a
// leg's is square): rows [LO, WR - 1 - LO] and columns [LO, W - 1 - LO],
// A = W - 2 LO of them in each row, A / 2 of each column parity.  Item q
// is cell s = q mod (A / 2) of half h of row LO + q / (A / 2) in a
// red-black pass, whose column parity the colour fixes; in a Jacobi pass
// both halves of a row are items.  NT threads take the items, K each.
template <int W, int LO, bool RB, int WR = W, int NT = THREADS>
struct PassCells {
  static constexpr int A = W - 2 * LO;
  static constexpr int HA = A / 2;
  static constexpr int ITEMS = (RB ? 1 : 2) * (WR - 2 * LO) * HA;
  static constexpr int K = (ITEMS + NT - 1) / NT;
  // window cell of item q; colour parity (red-black only)
  static __device__ __forceinline__ void cell(int q, int r0, int c0,
                                              int parity, int& wr, int& wc) {
    int h, s;
    if (RB) {
      wr = LO + q / HA;
      s = q - (wr - LO) * HA;
      // the column parity whose cells in this row have colour `parity`
      h = (parity + r0 + wr + c0) & 1;
    } else {
      wr = LO + q / A;
      const int rem = q - (wr - LO) * A;
      h = rem >= HA;
      s = rem - h * HA;
    }
    // first column of parity h at or after LO, then every other one
    wc = LO + ((h ^ LO) & 1) + 2 * s;
  }
};

// Red-black pass LO of a window of WR rows and W columns (a leg's is
// square) taken by NT threads: the cells of PassCells, new values staged
// in registers and written after a barrier.  b is read through the
// read-only cache, or (SB) from sb, a window of b in u's layout.
template <int W, int LO, bool FIX, int WR = W, int NT = THREADS,
          bool SB = false>
__device__ __forceinline__ void rb_pass(float* su, const SysPtrs& t,
                                        const SysOp& p, float om, int n,
                                        int m, int r0, int c0, int parity,
                                        const float* sb = nullptr) {
  using C = PassCells<W, LO, true, WR, NT>;
  float nv[C::K][NF];
#pragma unroll
  for (int k = 0; k < C::K; ++k) {
    const int q = threadIdx.x + k * NT;
    if (q >= C::ITEMS) continue;
    int wr, wc;
    C::cell(q, r0, c0, parity, wr, wc);
    const int gr = r0 + wr, gc = c0 + wc;
    if (!inside(n, m, gr, gc)) continue;
    float v[NF][9], b[NF];
    const long g = static_cast<long>(gr) * m + gc;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      nine_split<W>(su + f * WR * W, wr, wc, v[f]);
      b[f] = SB ? sb[f * WR * W + at<W>(wr, wc)] : __ldg(t.b[f] + g);
    }
    point_update<FIX>(v, b, gr, p, om, nv[k]);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < C::K; ++k) {
    const int q = threadIdx.x + k * NT;
    if (q >= C::ITEMS) continue;
    int wr, wc;
    C::cell(q, r0, c0, parity, wr, wc);
    if (!inside(n, m, r0 + wr, c0 + wc)) continue;
#pragma unroll
    for (int f = 0; f < NF; ++f) su[f * WR * W + at<W>(wr, wc)] = nv[k][f];
  }
  __syncthreads();
}

// Jacobi pass LO of a leg: every cell of PassCells from window src into
// window dst (zero outside the grid), which the next pass reads.
template <int W, int LO, bool FIX>
__device__ __forceinline__ void jacobi_pass(const float* src, float* dst,
                                            const SysPtrs& t, const SysOp& p,
                                            float om, int n, int m, int r0,
                                            int c0) {
  using C = PassCells<W, LO, false>;
#pragma unroll
  for (int k = 0; k < C::K; ++k) {
    const int q = threadIdx.x + k * THREADS;
    if (q >= C::ITEMS) continue;
    int wr, wc;
    C::cell(q, r0, c0, 0, wr, wc);
    const int gr = r0 + wr, gc = c0 + wc;
    float nv[NF] = {};
    if (inside(n, m, gr, gc)) {
      float v[NF][9], b[NF];
      const long g = static_cast<long>(gr) * m + gc;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        nine_split<W>(src + f * W * W, wr, wc, v[f]);
        b[f] = __ldg(t.b[f] + g);
      }
      point_update<FIX>(v, b, gr, p, om, nv);
    }
#pragma unroll
    for (int f = 0; f < NF; ++f) dst[f * W * W + at<W>(wr, wc)] = nv[f];
  }
  __syncthreads();
}

// Passes LO..P of a leg: pass LO runs sweep (LO - 1) / 2 (red-black: red,
// then black) or LO - 1 (Jacobi) with factor omegas[L.om[om_first + s]].
// su holds leg_windows(RB) windows of NF fields.
template <int W, int P, bool RB, bool FIX, int LO = 1>
__device__ __forceinline__ void leg_sweeps(float* su, const SysPtrs& t,
                                           const SysOp& p, const SysLeg& L,
                                           const float* __restrict__ omegas,
                                           int om_first, int r0, int c0) {
  if constexpr (LO <= P) {
    constexpr int s = RB ? (LO - 1) / 2 : LO - 1;
    const float om = omegas[L.om[om_first + s]];
    constexpr int WIN = NF * W * W;
    if constexpr (RB)
      rb_pass<W, LO, FIX>(su, t, p, om, L.n, L.m, r0, c0, (LO - 1) & 1);
    else
      jacobi_pass<W, LO, FIX>(su + window_after(false, LO - 1) * WIN,
                              su + window_after(false, LO) * WIN, t, p, om,
                              L.n, L.m, r0, c0);
    leg_sweeps<W, P, RB, FIX, LO + 1>(su, t, p, L, omegas, om_first, r0, c0);
  }
}

// u of every field over the leg window of edge W whose top-left interior
// index is (r0, c0), read row-contiguously; zeros outside the grid.
template <int W>
__device__ __forceinline__ void load_u(const SysPtrs& t, float* su, int n,
                                       int m, int r0, int c0) {
  constexpr int K = (W * W + THREADS - 1) / THREADS;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int idx = threadIdx.x + k * THREADS;
    if (idx >= W * W) continue;
    const int wr = idx / W, wc = idx - wr * W;
    const int gr = r0 + wr, gc = c0 + wc;
    const bool in = inside(n, m, gr, gc);
    const long g = static_cast<long>(gr) * m + gc;
#pragma unroll
    for (int f = 0; f < NF; ++f)
      su[f * W * W + at<W>(wr, wc)] = in ? __ldg(t.u[f] + g) : 0.f;
  }
}

// The TILE x TILE interior of the leg window (halo H) of every field to
// out.
template <int W, int H>
__device__ __forceinline__ void store_u(const float* su, const SysPtrs& t,
                                        int n, int m, int r0, int c0) {
  constexpr int K = TILE * TILE / THREADS;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int idx = threadIdx.x + k * THREADS;
    const int i = idx / TILE, j = idx - i * TILE;
    const int gr = r0 + H + i, gc = c0 + H + j;
    if (!inside(n, m, gr, gc)) continue;
    const long g = static_cast<long>(gr) * m + gc;
#pragma unroll
    for (int f = 0; f < NF; ++f)
      t.out[f][g] = su[f * W * W + at<W>(H + i, H + j)];
  }
}

template <int S, bool RB, bool FIX>
__global__ void __launch_bounds__(THREADS, 2)
downleg_sys_kernel(SysPtrs t, SysOp p, SysLeg L,
                   const float* __restrict__ omegas) {
  constexpr int P = leg_passes(S, RB);
  constexpr int H = leg_halo(true, S, RB);
  constexpr int W = TILE + 2 * H;
  extern __shared__ float su[];
  const int r0 = blockIdx.y * TILE - H, c0 = blockIdx.x * TILE - H;
  load_u<W>(t, su, L.n, L.m, r0, c0);
  __syncthreads();
  leg_sweeps<W, P, RB, FIX>(su, t, p, L, omegas, 0, r0, c0);
  constexpr int WIN = NF * W * W;
  const float* uw = su + window_after(RB, P) * WIN;

  // every field's residual on the rows and columns the restriction reads,
  // window indices H .. H + TILE (inclusive) on both axes, zero outside
  // the grid, into window rw: red-black in registers, then over u's
  // window once the tile is stored; Jacobi straight into the other
  // window.  Item q is slot s of half h (column parity) of row
  // H + q / (2 RH).
  float* rw = su + (RB ? 0 : 1 - window_after(RB, P)) * WIN;
  constexpr int RW = TILE + 1, RH = (RW + 1) / 2;
  constexpr int RK = (RW * 2 * RH + THREADS - 1) / THREADS;
  float rv[RB ? RK : 1][NF];
#pragma unroll
  for (int k = 0; k < RK; ++k) {
    const int q = threadIdx.x + k * THREADS;
    const int i = q / (2 * RH), rem = q - i * 2 * RH;
    const int h = rem >= RH, s = rem - h * RH;
    const int wr = H + i, wc = H + ((h ^ H) & 1) + 2 * s;
    const int gr = r0 + wr, gc = c0 + wc;
    float* r = rv[RB ? k : 0];
#pragma unroll
    for (int f = 0; f < NF; ++f) r[f] = 0.f;
    if (i >= RW || wc > H + TILE) continue;
    if (inside(L.n, L.m, gr, gc)) {
      float v[NF][9], b[NF];
      const long g = static_cast<long>(gr) * L.m + gc;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        nine_split<W>(uw + f * W * W, wr, wc, v[f]);
        b[f] = __ldg(t.b[f] + g);
      }
      residuals<FIX>(v, b, gr, p, r);
    }
    if (!RB)
#pragma unroll
      for (int f = 0; f < NF; ++f) rw[f * W * W + at<W>(wr, wc)] = r[f];
  }
  store_u<W, H>(uw, t, L.n, L.m, r0, c0);
  __syncthreads();
  if constexpr (RB) {
#pragma unroll
    for (int k = 0; k < RK; ++k) {
      const int q = threadIdx.x + k * THREADS;
      const int i = q / (2 * RH), rem = q - i * 2 * RH;
      const int h = rem >= RH, s = rem - h * RH;
      const int wc = H + ((h ^ H) & 1) + 2 * s;
      if (i >= RW || wc > H + TILE) continue;
#pragma unroll
      for (int f = 0; f < NF; ++f)
        rw[f * W * W + at<W>(H + i, wc)] = rv[k][f];
    }
    __syncthreads();
  }

  // coarse point (ci, cj) reads fine rows/columns 2ci..2ci+2, 2cj..2cj+2:
  // the row taps first, then the column taps (rbgs_sys.py:348-354)
  const int nc = (L.n - 1) / 2, mc = (L.m - 1) / 2;
  constexpr int CT = TILE / 2;
#pragma unroll
  for (int k = 0; k < CT * CT / THREADS; ++k) {
    const int idx = threadIdx.x + k * THREADS;
    const int i = idx / CT, j = idx - i * CT;
    const int ci = blockIdx.y * CT + i, cj = blockIdx.x * CT + j;
    if (ci >= nc || cj >= mc) continue;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const float* r = rw + f * W * W;
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const int wc = H + 2 * j + e;
        const float rows = L.tr[0] * r[at<W>(H + 2 * i, wc)] +
                           L.tr[1] * r[at<W>(H + 2 * i + 1, wc)] +
                           L.tr[2] * r[at<W>(H + 2 * i + 2, wc)];
        acc += L.tc[e] * rows;
      }
      t.rc[f][static_cast<long>(ci) * mc + cj] = acc;
    }
  }
}

// Coarse rows (and columns) an up-leg window of edge w prolongs from: a
// fine index x reads coarse x / 2 - 1 and x / 2 (even x) or (x - 1) / 2
// (odd x), so a window starting at x0 reads from floor(x0 / 2) - 1 on,
// w / 2 + 2 of them.
__host__ __device__ constexpr int coarse_edge(int w) { return w / 2 + 2; }

template <int S, bool RB, bool FIX>
__global__ void __launch_bounds__(THREADS, 2)
upleg_sys_kernel(SysPtrs t, SysOp p, SysLeg L,
                 const float* __restrict__ omegas) {
  constexpr int P = leg_passes(S, RB);
  constexpr int H = leg_halo(false, S, RB);
  constexpr int W = TILE + 2 * H;
  constexpr int CW = coarse_edge(W);
  constexpr int WIN = NF * W * W;
  extern __shared__ float su[];
  float* se = su + leg_windows(RB) * WIN;
  const int r0 = blockIdx.y * TILE - H, c0 = blockIdx.x * TILE - H;
  const int cr0 = (r0 >> 1) - 1, cc0 = (c0 >> 1) - 1;   // floor
  const int nc = (L.n - 1) / 2, mc = (L.m - 1) / 2;
  load_u<W>(t, su, L.n, L.m, r0, c0);
  constexpr int EK = (CW * CW + THREADS - 1) / THREADS;
#pragma unroll
  for (int k = 0; k < EK; ++k) {
    const int idx = threadIdx.x + k * THREADS;
    if (idx >= CW * CW) continue;
    const int i = idx / CW, j = idx - i * CW;
    const int ci = cr0 + i, cj = cc0 + j;
    const bool in = inside(nc, mc, ci, cj);
    const long g = static_cast<long>(ci) * mc + cj;
#pragma unroll
    for (int f = 0; f < NF; ++f)
      se[f * CW * CW + idx] = in ? __ldg(t.e[f] + g) : 0.f;
  }
  __syncthreads();

  // u += omega_0 * P(e) on every window cell: fine index 2i+1+o takes
  // taps[o+1] * e[i] on each axis; the column expansion first, then the
  // row expansion (rbgs_sys.py:436-445).  Item q is slot s of half h
  // (column parity) of row q / W.
  const float om0 = omegas[L.om[0]];
  constexpr int PK = W * W / THREADS + (W * W % THREADS ? 1 : 0);
#pragma unroll
  for (int k = 0; k < PK; ++k) {
    const int q = threadIdx.x + k * THREADS;
    if (q >= W * W) continue;
    const int wr = q / W, rem = q - wr * W;
    const int h = rem >= W / 2, wc = 2 * (rem - h * (W / 2)) + h;
    const int gr = r0 + wr, gc = c0 + wc;
    if (!inside(L.n, L.m, gr, gc)) continue;
    // coarse window rows and columns: (odd) the one, (even) before, after
    const int ra = ((gr - 1) >> 1) - cr0, ca = ((gc - 1) >> 1) - cc0;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const float* e = se + f * CW * CW;
      float col[2];
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        const float* er = e + (ra + k2) * CW;
        col[k2] = (gc & 1) ? L.tc[1] * er[ca]
                           : L.tc[2] * er[ca] + L.tc[0] * er[ca + 1];
      }
      const float corr = (gr & 1) ? L.tr[1] * col[0]
                                  : L.tr[2] * col[0] + L.tr[0] * col[1];
      su[f * W * W + at<W>(wr, wc)] += om0 * corr;
    }
  }
  __syncthreads();
  leg_sweeps<W, P, RB, FIX>(su, t, p, L, omegas, 1, r0, c0);
  store_u<W, H>(su + window_after(RB, P) * WIN, t, L.n, L.m, r0, c0);
}

// ---------------------------------------------------------------------------
// the standalone red-black sweep: rbgs_sys_kernel<FIX> (es_sweep_sys; see
// the design note at the top)
// ---------------------------------------------------------------------------

// The sweep's window: 16 x 64 cells, halo 2, blocks of 256 threads, at
// least four resident on an SM (64 registers a thread); u and b of both
// fields staged, each in the legs' layout.
struct SweepWin {
  static constexpr int H = 2;
  static constexpr int WR = 16, WC = 64;
  static constexpr int NT = 256;
  static constexpr int BLOCKS = 1024 / NT;
  static constexpr int TR = WR - 2 * H, TC = WC - 2 * H;
  static constexpr int FIELD = WR * WC;   // one field's window
  static constexpr int SMEM =
      2 * NF * FIELD * static_cast<int>(sizeof(float));   // u, then b
  static_assert(FIELD % NT == 0 && TR > 0 && TR % 2 == 0,
                "whole copies a thread, even tiles");
  static_assert(SMEM <= 48 * 1024, "no dynamic shared memory opt-in");
};

// u and b of every field over the sweep window whose top-left
// interior index is (r0, c0), zero outside the grid, by cp.async: every
// copy of the thread in flight, then one wait and a barrier.  Lanes copy
// consecutive columns of a row.
template <typename L>
__device__ __forceinline__ void stage_sweep(const SysPtrs& t, float* su,
                                            int n, int m, int r0, int c0) {
#pragma unroll
  for (int k = 0; k < L::FIELD / L::NT; ++k) {
    const int idx = threadIdx.x + k * L::NT;
    const int wr = idx / L::WC, wc = idx % L::WC;
    const int gr = r0 + wr, gc = c0 + wc;
    const bool in = inside(n, m, gr, gc);
    const long g = in ? static_cast<long>(gr) * m + gc : 0;
    float* dst = su + at<L::WC>(wr, wc);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      copy_async(dst + f * L::FIELD, t.u[f] + g, in);
      copy_async(dst + (NF + f) * L::FIELD, t.b[f] + g, in);
    }
  }
  copy_wait_all();
  __syncthreads();
}

// The tile (the window less the halo) of every field to out.
template <typename L>
__device__ __forceinline__ void store_sweep(const float* su,
                                            const SysPtrs& t, int n, int m,
                                            int r0, int c0) {
#pragma unroll
  for (int k = 0; k < L::FIELD / L::NT; ++k) {
    const int idx = threadIdx.x + k * L::NT;
    const int wr = idx / L::WC, wc = idx % L::WC;
    const int gr = r0 + wr, gc = c0 + wc;
    if (wr < L::H || wr >= L::WR - L::H || wc < L::H ||
        wc >= L::WC - L::H || !inside(n, m, gr, gc))
      continue;
    const long g = static_cast<long>(gr) * m + gc;
#pragma unroll
    for (int f = 0; f < NF; ++f)
      t.out[f][g] = su[f * L::FIELD + at<L::WC>(wr, wc)];
  }
}

template <bool FIX>
__global__ void __launch_bounds__(SweepWin::NT, SweepWin::BLOCKS)
rbgs_sys_kernel(SysPtrs t, SysOp p, const float* __restrict__ omegas,
                int om_id, int n, int m) {
  using L = SweepWin;
  __shared__ float su[L::SMEM / sizeof(float)];
  const int r0 = blockIdx.y * L::TR - L::H, c0 = blockIdx.x * L::TC - L::H;
  const float om = omegas[om_id];
  stage_sweep<L>(t, su, n, m, r0, c0);
  const float* sb = su + NF * L::FIELD;
  // red on the cells at distance >= 1, black on those at >= 2
  rb_pass<L::WC, 1, FIX, L::WR, L::NT, true>(su, t, p, om, n, m, r0, c0, 0,
                                             sb);
  rb_pass<L::WC, 2, FIX, L::WR, L::NT, true>(su, t, p, om, n, m, r0, c0, 1,
                                             sb);
  store_sweep<L>(su, t, n, m, r0, c0);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

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

SysLeg make_leg(const double* taps, const int* om_ids, int n_ids, int n,
                int m) {
  SysLeg L;
  for (int k = 0; k < 3; ++k) {
    L.tr[k] = static_cast<float>(taps[k]);
    L.tc[k] = static_cast<float>(taps[3 + k]);
  }
  for (int k = 0; k <= MAX_SWEEPS; ++k) L.om[k] = k < n_ids ? om_ids[k] : 0;
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

// The red-black sweep's instantiation: with row fixups or without.
using SweepKernel = void (*)(SysPtrs, SysOp, const float*, int, int, int);
SweepKernel sweep_of(bool fix) {
  return fix ? rbgs_sys_kernel<true> : rbgs_sys_kernel<false>;
}

bool bad_shape(int n, int m) { return n < 3 || m < 3 || !(n & 1) || !(m & 1); }

// One leg instantiation: its kernel, halo and shared memory.
using LegKernel = void (*)(SysPtrs, SysOp, SysLeg, const float*);
struct LegInst {
  LegKernel kernel;
  int halo;
  int smem;
};

template <bool DOWN, int S, bool RB, bool FIX>
LegInst leg_inst() {
  constexpr int H = leg_halo(DOWN, S, RB);
  constexpr int W = TILE + 2 * H;
  constexpr int CW = coarse_edge(W);
  constexpr int U = leg_windows(RB) * NF * W * W;
  if (DOWN)
    return {downleg_sys_kernel<S, RB, FIX>, H,
            static_cast<int>(U * sizeof(float))};
  return {upleg_sys_kernel<S, RB, FIX>, H,
          static_cast<int>((U + NF * CW * CW) * sizeof(float))};
}

template <bool DOWN, int S>
LegInst leg_inst_of_mode(bool red_black, bool fix) {
  if (red_black)
    return fix ? leg_inst<DOWN, S, true, true>()
               : leg_inst<DOWN, S, true, false>();
  return fix ? leg_inst<DOWN, S, false, true>()
             : leg_inst<DOWN, S, false, false>();
}

// The instantiation of a leg; kernel null for a sweep count it lacks.
LegInst find_leg(bool down, int sweeps, bool red_black, bool fix) {
  switch (sweeps) {
    case 1:
      return down ? leg_inst_of_mode<true, 1>(red_black, fix)
                  : leg_inst_of_mode<false, 1>(red_black, fix);
    case 2:
      return down ? leg_inst_of_mode<true, 2>(red_black, fix)
                  : leg_inst_of_mode<false, 2>(red_black, fix);
    case 3:
      return down ? leg_inst_of_mode<true, 3>(red_black, fix)
                  : leg_inst_of_mode<false, 3>(red_black, fix);
    default:
      return {nullptr, 0, 0};
  }
}

bool has_fixups(const SysOp& p) { return p.n_exc + p.n_exc_minv > 0; }

// Launch a leg whose halo the caller derived; refuse one the instantiation
// was not built for.
cudaError_t launch_leg(bool down, int sweeps, int red_black, int halo,
                       const SysOp& p, const SysPtrs& t, const SysLeg& L,
                       const float* omegas, void* stream) {
  const LegInst inst = find_leg(down, sweeps, red_black != 0, has_fixups(p));
  if (!inst.kernel || halo != inst.halo) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(inst.kernel, inst.smem);
  if (err != cudaSuccess) return err;
  inst.kernel<<<tiles(L.n, L.m), THREADS, inst.smem,
                static_cast<cudaStream_t>(stream)>>>(t, p, L, omegas);
  return cudaGetLastError();
}

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
    using L = SweepWin;
    const dim3 grid((m + L::TC - 1) / L::TC, (n + L::TR - 1) / L::TR);
    sweep_of(has_fixups(p))<<<grid, L::NT, 0, s>>>(t, p, omegas, om_id, n,
                                                   m);
  } else {
    const dim3 grid((m + JAC_BX - 1) / JAC_BX, (n + JAC_BY - 1) / JAC_BY);
    jacobi_sys_kernel<<<grid, dim3(JAC_BX, JAC_BY), 0, s>>>(t, p, omegas,
                                                            om_id, n, m);
  }
  return cudaGetLastError();
}

// taps: 3 row taps, 3 column taps.  om_ids: `sweeps` indices into omegas,
// in the order the sweeps run.  halo: the window halo the caller derived
// for (down-leg, sweeps, red_black); any other is refused.
extern "C" int es_presmooth_residual_restrict_sys(
    const void* const* u, const void* const* b, void* const* u_out,
    void* const* rc, int F, const double* table, int n_exc, int n_exc_minv,
    const int* rows, const double* vals, const float* omegas,
    const int* om_ids, int sweeps, int red_black, const double* taps,
    int halo, int n, int m, void* stream) {
  SysOp p;
  if (sweeps < 1 || sweeps > MAX_SWEEPS || bad_shape(n, m) ||
      !make_op(F, table, n_exc, n_exc_minv, rows, vals, &p))
    return cudaErrorInvalidValue;
  return launch_leg(true, sweeps, red_black, halo, p,
                    make_ptrs(u, b, nullptr, u_out, rc),
                    make_leg(taps, om_ids, sweeps, n, m), omegas, stream);
}

// om_ids: 1 + sweeps indices into omegas: the coarse-grid-correction factor,
// then the post-sweeps in the order they run.  halo: as above, for the
// up-leg.
extern "C" int es_prolong_correct_postsmooth_sys(
    const void* const* u, const void* const* e, const void* const* b,
    void* const* u_out, int F, const double* table, int n_exc,
    int n_exc_minv, const int* rows, const double* vals, const float* omegas,
    const int* om_ids, int sweeps, int red_black, const double* taps,
    int halo, int n, int m, void* stream) {
  SysOp p;
  if (sweeps < 1 || sweeps > MAX_SWEEPS || bad_shape(n, m) ||
      !make_op(F, table, n_exc, n_exc_minv, rows, vals, &p))
    return cudaErrorInvalidValue;
  return launch_leg(false, sweeps, red_black, halo, p,
                    make_ptrs(u, b, e, u_out, nullptr),
                    make_leg(taps, om_ids, sweeps + 1, n, m), omegas, stream);
}

// What a leg instantiation (down or up, sweeps, red_black, with row fixups
// or not) is on this card: info[0] its halo, [1] its resident blocks per
// SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor at its shared memory),
// [2] registers per thread, [3] local memory per thread in bytes (spills
// land there), [4] dynamic shared memory per block in bytes.
extern "C" int es_leg_sys_info(int down, int sweeps, int red_black,
                               int fixups, int* info) {
  const LegInst inst = find_leg(down != 0, sweeps, red_black != 0,
                                fixups != 0);
  if (!inst.kernel) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(inst.kernel, inst.smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, inst.kernel,
                                                      THREADS, inst.smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, inst.kernel);
  if (err != cudaSuccess) return err;
  info[0] = inst.halo;
  info[1] = blocks;
  info[2] = attr.numRegs;
  info[3] = static_cast<int>(attr.localSizeBytes);
  info[4] = inst.smem;
  return cudaSuccess;
}

// What es_sweep_sys's red-black kernel (with row fixups or not) is on this
// card: info[0], [1] its tile's rows and columns, [2] its halo, [3]
// threads per block, [4] resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), [5] registers per
// thread, [6] local memory per thread in bytes (spills land there), [7]
// shared memory per block in bytes.
extern "C" int es_sweep_sys_info(int fixups, int* info) {
  using L = SweepWin;
  const void* kernel = reinterpret_cast<const void*>(sweep_of(fixups != 0));
  int blocks = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, L::NT, 0);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  info[0] = L::TR;
  info[1] = L::TC;
  info[2] = L::H;
  info[3] = L::NT;
  info[4] = blocks;
  info[5] = attr.numRegs;
  info[6] = static_cast<int>(attr.localSizeBytes);
  info[7] = static_cast<int>(attr.sharedSizeBytes);
  return cudaSuccess;
}
