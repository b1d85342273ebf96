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
//   one damped red-black sweep (red, then black with the new red values;
//   rbgs_var_kernel) or one damped Jacobi sweep (jacobi_var_kernel),
//   u + (omega / cc) * (b - A u).
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
// The Jacobi sweep (jacobi_var_kernel) is one thread a point writing a
// buffer it does not read, its five coefficients through the read-only
// cache.
//
// Design of the windowed kernels: the legs (downleg_var_kernel<S, RB>,
// upleg_var_kernel<S, RB>: one instantiation per sweep count and mode) and
// the standalone red-black sweep (rbgs_var_kernel) are forms of one
// template, VarShape<F, S, RB, K>.
// Like transfer.cu's legs they are latency-bound before they are
// bandwidth-bound: a block loads, then runs its passes between barriers,
// so the card needs many blocks resident.  A block stages u, b and the
// four neighbour coefficient planes over its window by 4-byte cp.async (a
// 2047-wide row is 8,188 bytes, so rows are not 16-byte aligned), all of a
// thread's copies in flight at once, and reads the centre coefficient of
// each of its cells into registers beside them: every coefficient crosses
// device memory once per window, and no pass re-reads it.  Over the 32 x
// 64 window six planes take 49,920 bytes (52,368 with the up-leg's coarse
// window of e), so four 256-thread blocks (32 warps) are resident on an
// SM; over the 16 x 64 window 25,344 bytes, eight blocks.  Each thread
// then forms, once and in registers, the factor of each of its cells: the
// legs 1/cc, used with omega in every half-sweep as the TPU body forms
// dinv once per leg (rbgs_var.py:214, :223); the sweep omega / cc, as its
// TPU body forms dinv (rbgs_var.py:96) and adds dinv * (b - A u) (:113).
// The halo is the form's own: P = 2S half-sweeps (red-black) or P = S
// sweeps (Jacobi), P + 2 on the down-leg, P on the up-leg and on the sweep
// (one red-black sweep: 2), and the tile is the window less the halo on
// every side.  Pass p updates only the window cells at a distance >= p
// from the window edge: their neighbours all lie in the window, so no read
// is predicated, and the cells still right after pass p are exactly those.
// A plane is stored split by column parity (all even columns, then all odd
// ones, 16 banks apart), so a colour's cells of a row are contiguous: in a
// red-black half-sweep lane x updates slot x of its rows, every lane busy,
// every warp's reads bank-conflict free, in place; a Jacobi sweep computes
// all of a thread's cells into registers, the block synchronises, then
// writes them.  The down-leg forms the residual of the tile and one row
// and column past it in place of b and restricts it from there; the
// up-leg stages e's coarse window once and prolongs from it onto every
// window cell; the sweep stores its tile after its two passes.  The legs
// take the 32 x 64 window (class 0) at every level: on the H100 it was the
// fastest of the 64 x 64, 48 x 64, 32 x 128 and 32 x 32 windows tried at
// 2047^2 .. 255^2, or within 4% of it (PERF.md section 6).  The sweep
// takes the 16 x 64 window (class 1) at every level: on the H100 it was
// 9-11% faster than 32 x 64 at 511^2 and 255^2, and 2.5% slower at 1023^2,
// within the spread of the turns there (PERF.md section 6).
// tests/test_torch_var_tiles.py
// emulates this schedule in float64, and es_var_leg_info and
// es_sweep_var_info report each instantiation's tile, halo and occupancy
// from the card.
//
// Tiles start at even interior indices (a Jacobi leg's window may start at
// an odd one) and red is an even sum of interior indices (interior index
// i is node i+1 on both axes, which leaves the parity unchanged).  Cells
// outside the grid hold 0 and are never updated.  Relaxation factors are
// read from the device vector by index, so no launch waits on the host.

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int MAX_SWEEPS = 3;
constexpr int JAC_BX = 32, JAC_BY = 8;

struct VarLeg {
  float tr[3], tc[3];           // row and column transfer taps
  int om[MAX_SWEEPS + 1];       // indices into the relaxation-factor vector
  int n, m;
};

__device__ __forceinline__ bool inside(int n, int m, int gr, int gc) {
  return gr >= 0 && gr < n && gc >= 0 && gc < m;
}

// ---------------------------------------------------------------------------
// The windowed kernels: downleg_var_kernel<S, RB> and
// upleg_var_kernel<S, RB> (es_presmooth_residual_restrict_var and
// es_prolong_correct_postsmooth_var), rbgs_var_kernel (es_sweep_var,
// red-black); see the design note at the top.
// ---------------------------------------------------------------------------

// The forms of the windowed kernel: the up-leg, the down-leg (numbered as
// es_var_leg_info takes its `down` flag) and the standalone red-black
// sweep.
enum VarForm : int { kVarUp = 0, kVarDown = 1, kVarSweep = 2 };

// Window class K: ROWS x 2 WIN_SLOTS cells, blocks of WIN_SLOTS x WIN_NY
// threads, at least BLOCKS resident on an SM (__launch_bounds__; shared
// memory or threads allow no more).  WIN_NY is even, so the rows of one
// thread share a parity.  The legs take class 0, the sweep class 1.
constexpr int WIN_SLOTS = 32, WIN_NY = 8;
template <int K>
struct VarWindow;
template <>
struct VarWindow<0> {
  static constexpr int ROWS = 32, BLOCKS = 4;
};
template <>
struct VarWindow<1> {
  static constexpr int ROWS = 16, BLOCKS = 8;
};

// Planes staged in shared memory, in this order: u, b, and the neighbour
// coefficients cn, cs, cw, ce (stack planes 1..4).  The centre coefficient
// and 1/cc live in registers.
constexpr int STAGED = 6;

// Form F of S sweeps (red-black RB, else Jacobi) in window class K: P
// passes (2S half-sweeps or S sweeps), the halo (P + 2 down, P up and on
// the sweep), the tile, and the windows' layout.  A plane holds the
// window's even columns row by row (row wr at wr * SL), then 16 floats of
// padding, then its odd columns (from HALF on), so that the two halves of
// a row start 16 banks apart; the up-leg's coarse window of e, CR x CC
// values, follows the STAGED planes.
template <int F, int S, bool RB_, int K = 0>
struct VarShape {
  static constexpr bool DOWN = F == kVarDown, UP = F == kVarUp;
  static constexpr bool SWEEP = F == kVarSweep, RB = RB_;
  static constexpr int P = RB ? 2 * S : S;
  static constexpr int H = DOWN ? P + 2 : P;
  static constexpr int WR = VarWindow<K>::ROWS, SL = WIN_SLOTS, NY = WIN_NY;
  static constexpr int WC = 2 * SL;
  static constexpr int THREADS = SL * NY;
  static constexpr int BLOCKS = VarWindow<K>::BLOCKS;
  static constexpr int TR = WR - 2 * H, TC = WC - 2 * H;
  static constexpr int KR = WR / NY;   // rows of a thread
  static constexpr int HALF = WR * SL + 16;
  static constexpr int PLANE = 2 * HALF;
  static constexpr int CR = WR / 2 + 2, CC = SL + 2;
  static constexpr int SMEM =
      (STAGED * PLANE + (UP ? CR * CC : 0)) * static_cast<int>(sizeof(float));
  // a red-black window starts at even interior indices, so a cell's
  // colour is the parity of its window indices
  static_assert(!RB || H % 2 == 0, "red-black halos are even");
  static_assert(SL == 32 && NY % 2 == 0 && WR % NY == 0 && TR > 0 &&
                    TC > 0,
                "a warp is a row's slots, and the window fits the halo");
};

template <typename L>
__device__ __forceinline__ int at(int wr, int wc) {
  return (wc & 1) * L::HALF + wr * L::SL + (wc >> 1);
}

// u, b and the neighbour coefficients over the window whose top-left
// interior index is (r0, c0), zero outside the grid, issued by cp.async:
// lane x copies columns x and x + SLOTS of its rows.
template <typename L>
__device__ __forceinline__ void stage_window(const float* __restrict__ u,
                                             const float* __restrict__ b,
                                             const float* __restrict__ c,
                                             float* sw, const VarLeg& p,
                                             int r0, int c0) {
  const long nm = static_cast<long>(p.n) * p.m;
#pragma unroll
  for (int k = 0; k < L::KR; ++k) {
    const int wr = threadIdx.y + k * L::NY, gr = r0 + wr;
    const bool row_in = gr >= 0 && gr < p.n;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int wc = threadIdx.x + j * L::SL, gc = c0 + wc;
      const bool in = row_in && gc >= 0 && gc < p.m;
      const long g = in ? static_cast<long>(gr) * p.m + gc : 0;
      float* dst = sw + at<L>(wr, wc);
      copy_async(dst, u + g, in);
      copy_async(dst + L::PLANE, b + g, in);
#pragma unroll
      for (int q = 1; q < 5; ++q)
        copy_async(dst + (1 + q) * L::PLANE, c + q * nm + g, in);
    }
  }
}

// e's coarse window: coarse rows cr0 .. cr0 + CR - 1 and columns cc0 ..
// cc0 + CC - 1, row-major, zero outside the coarse grid.
template <typename L>
__device__ __forceinline__ void stage_coarse(const float* __restrict__ e,
                                             float* se, const VarLeg& p,
                                             int cr0, int cc0) {
  const int nc = (p.n - 1) / 2, mc = (p.m - 1) / 2;
  for (int i = threadIdx.y; i < L::CR; i += L::NY) {
    const int ci = cr0 + i;
    for (int j = threadIdx.x; j < L::CC; j += L::SL) {
      const int cj = cc0 + j;
      const bool in = ci >= 0 && ci < nc && cj >= 0 && cj < mc;
      copy_async(se + i * L::CC + j,
                 in ? e + static_cast<long>(ci) * mc + cj : e, in);
    }
  }
}

// A thread's cells: on each of its rows ty + k NY, slot s of each half.
// Cell q of a row lies in half h = (q + ty) & 1, so in a red-black leg
// cell q has colour q (red: an even sum of interior indices).  The centre
// coefficient of every cell, read once from global memory (0 outside the
// grid).
template <typename L>
__device__ __forceinline__ void load_centre(const float* __restrict__ c,
                                            const VarLeg& p, int r0, int c0,
                                            float cc[2][L::KR]) {
  const int s = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int gc = c0 + 2 * s + ((q + ty) & 1);
#pragma unroll
    for (int k = 0; k < L::KR; ++k) {
      const int gr = r0 + ty + k * L::NY;
      cc[q][k] = inside(p.n, p.m, gr, gc)
                     ? __ldg(c + static_cast<long>(gr) * p.m + gc)
                     : 0.f;
    }
  }
}

// A u at the cell `w` of the u plane: `side` is its right neighbour in the
// other half, whose predecessor is its left one; the coefficients lie
// 2..5 planes on (rbgs_var.py:222).
template <typename L>
__device__ __forceinline__ float apply_at(const float* w, const float* side,
                                          float cc) {
  return cc * w[0] + w[2 * L::PLANE] * w[-L::SL] +
         w[3 * L::PLANE] * w[L::SL] + w[4 * L::PLANE] * side[-1] +
         w[5 * L::PLANE] * side[0];
}

// Whether pass PASS updates window cell (wr, wc) at grid index (gr, gc):
// in the grid and at a distance >= PASS from the window's edge.
template <typename L, int PASS>
__device__ __forceinline__ bool updates(const VarLeg& p, int wr, int wc,
                                        int gr, int gc) {
  return wr >= PASS && wr <= L::WR - 1 - PASS && wc >= PASS &&
         wc <= L::WC - 1 - PASS && inside(p.n, p.m, gr, gc);
}

// Half-sweep PASS (1-based) of a red-black form: colour q = (PASS - 1) & 1
// (red first), in place, on cell q of each of the thread's rows: a leg's
// u + (omega * (1 / cc)) * (b - A u) (rbgs_var.py:218-224), the sweep's
// u + (omega / cc) * (b - A u) (:96, :113), dv holding the cell's 1 / cc or
// omega / cc.
template <typename L, int PASS>
__device__ __forceinline__ void rb_pass(float* sw, float om,
                                        const float cc[2][L::KR],
                                        const float dv[2][L::KR],
                                        const VarLeg& p, int r0, int c0) {
  constexpr int q = (PASS - 1) & 1;
  const int s = threadIdx.x, ty = threadIdx.y;
  const int h = (q + ty) & 1, wc = 2 * s + h, gc = c0 + wc;
  float* cell = sw + h * L::HALF + s;
  const float* side = sw + (1 - h) * L::HALF + s + h;
#pragma unroll
  for (int k = 0; k < L::KR; ++k) {
    const int wr = ty + k * L::NY;
    if (!updates<L, PASS>(p, wr, wc, r0 + wr, gc)) continue;
    float* w = cell + wr * L::SL;
    const float au = apply_at<L>(w, side + wr * L::SL, cc[q][k]);
    const float f = L::SWEEP ? dv[q][k] : om * dv[q][k];
    w[0] = w[0] + f * (w[L::PLANE] - au);
  }
}

// Sweep PASS of a Jacobi leg: every cell of the thread from the old
// values, held in registers until the block has read them.
template <typename L, int PASS>
__device__ __forceinline__ void jacobi_pass(float* sw, float om,
                                            const float cc[2][L::KR],
                                            const float dv[2][L::KR],
                                            const VarLeg& p, int r0,
                                            int c0) {
  const int s = threadIdx.x, ty = threadIdx.y;
  float nv[2][L::KR];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int h = (q + ty) & 1, wc = 2 * s + h;
    const float* cell = sw + h * L::HALF + s;
    const float* side = sw + (1 - h) * L::HALF + s + h;
#pragma unroll
    for (int k = 0; k < L::KR; ++k) {
      const int wr = ty + k * L::NY;
      nv[q][k] = 0.f;
      if (!updates<L, PASS>(p, wr, wc, r0 + wr, c0 + wc)) continue;
      const float* w = cell + wr * L::SL;
      const float au = apply_at<L>(w, side + wr * L::SL, cc[q][k]);
      nv[q][k] = w[0] + om * dv[q][k] * (w[L::PLANE] - au);
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int h = (q + ty) & 1, wc = 2 * s + h;
#pragma unroll
    for (int k = 0; k < L::KR; ++k) {
      const int wr = ty + k * L::NY;
      if (updates<L, PASS>(p, wr, wc, r0 + wr, c0 + wc))
        sw[h * L::HALF + wr * L::SL + s] = nv[q][k];
    }
  }
}

// Passes PASS..P, each followed by a barrier; pass q runs sweep (q - 1) / 2
// (red-black) or q - 1 (Jacobi) with omegas[p.om[om_first + sweep]] (the
// sweep's omega is already in dv).
template <typename L, int PASS = 1>
__device__ __forceinline__ void leg_passes(float* sw,
                                           const float* __restrict__ omegas,
                                           const VarLeg& p, int om_first,
                                           const float cc[2][L::KR],
                                           const float dv[2][L::KR], int r0,
                                           int c0) {
  if constexpr (PASS <= L::P) {
    const float om =
        L::SWEEP ? 1.f
                 : omegas[p.om[om_first + (L::RB ? (PASS - 1) / 2 : PASS - 1)]];
    if constexpr (L::RB)
      rb_pass<L, PASS>(sw, om, cc, dv, p, r0, c0);
    else
      jacobi_pass<L, PASS>(sw, om, cc, dv, p, r0, c0);
    __syncthreads();
    leg_passes<L, PASS + 1>(sw, omegas, p, om_first, cc, dv, r0, c0);
  }
}

// r = b - A u in place of b on the thread's cells of the tile and one row
// and column past it (window rows and columns H .. H + TR / TC); outside
// the grid every staged value is 0, and so is r.
template <typename L>
__device__ __forceinline__ void residual_in_place(float* sw,
                                                  const float cc[2][L::KR]) {
  const int s = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int h = (q + ty) & 1, wc = 2 * s + h;
    if (wc < L::H || wc > L::H + L::TC) continue;
    float* cell = sw + h * L::HALF + s;
    const float* side = sw + (1 - h) * L::HALF + s + h;
#pragma unroll
    for (int k = 0; k < L::KR; ++k) {
      const int wr = ty + k * L::NY;
      if (wr < L::H || wr > L::H + L::TR) continue;
      float* w = cell + wr * L::SL;
      w[L::PLANE] = w[L::PLANE] - apply_at<L>(w, side + wr * L::SL, cc[q][k]);
    }
  }
}

// The full restriction of the residual (b's plane) into rc: lane x takes
// coarse column x of the tile, each thread row every NY-th coarse row;
// the row taps first, then the column taps (rbgs_var.py:258-266).
template <typename L>
__device__ __forceinline__ void restrict_tile(const float* sw,
                                              float* __restrict__ rc,
                                              const VarLeg& p) {
  constexpr int CTR = L::TR / 2, CTC = L::TC / 2;
  const int j = threadIdx.x;
  const int mc = (p.m - 1) / 2, nc = (p.n - 1) / 2;
  const int cj = blockIdx.x * CTC + j;
  if (j >= CTC || cj >= mc) return;
  const float* r = sw + L::PLANE;
  for (int i = threadIdx.y; i < CTR; i += L::NY) {
    const int ci = blockIdx.y * CTR + i;
    if (ci >= nc) break;
    const int wr = L::H + 2 * i;
    float acc = 0.f;
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const int wc = L::H + 2 * j + e;
      const float rows = p.tr[0] * r[at<L>(wr, wc)] +
                         p.tr[1] * r[at<L>(wr + 1, wc)] +
                         p.tr[2] * r[at<L>(wr + 2, wc)];
      acc += p.tc[e] * rows;
    }
    rc[static_cast<long>(ci) * mc + cj] = acc;
  }
}

// u += om0 * P(e) on the thread's cells in the grid, from e's staged
// coarse window (its first row and column floor(r0 / 2) - 1, floor(c0 / 2)
// - 1): fine index 2i+1+o takes taps[o+1] * e[i] on each axis, the column
// expansion first, then the row expansion (rbgs_var.py:344-355).
template <typename L>
__device__ __forceinline__ void correct(float* sw, const float* se,
                                        const VarLeg& p, float om0, int r0,
                                        int c0) {
  const int cr0 = (r0 >> 1) - 1, cc0 = (c0 >> 1) - 1;
  const int s = threadIdx.x, ty = threadIdx.y;
  const auto col = [&p](const float* er, bool odd) {
    return odd ? p.tc[1] * er[0] : p.tc[2] * er[0] + p.tc[0] * er[1];
  };
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gc = c0 + 2 * s + h;
    if (gc < 0 || gc >= p.m) continue;
    // the coarse column at or before gc (odd: the one it takes)
    const int ca = ((gc - 1) >> 1) - cc0;
#pragma unroll
    for (int k = 0; k < L::KR; ++k) {
      const int wr = ty + k * L::NY, gr = r0 + wr;
      if (gr < 0 || gr >= p.n) continue;
      const float* er = se + (((gr - 1) >> 1) - cr0) * L::CC + ca;
      const float corr = (gr & 1) ? p.tr[1] * col(er, gc & 1)
                                  : p.tr[2] * col(er, gc & 1) +
                                        p.tr[0] * col(er + L::CC, gc & 1);
      sw[h * L::HALF + wr * L::SL + s] += om0 * corr;
    }
  }
}

// The tile of u's plane to out: lane x stores columns H + x and
// H + x + SLOTS of its rows.
template <typename L>
__device__ __forceinline__ void store_tile_var(const float* sw,
                                               float* __restrict__ out,
                                               const VarLeg& p, int r0,
                                               int c0) {
  for (int wr = L::H + threadIdx.y; wr < L::H + L::TR; wr += L::NY) {
    const int gr = r0 + wr;
    if (gr >= p.n) break;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int wc = L::H + threadIdx.x + j * L::SL, gc = c0 + wc;
      if (wc < L::H + L::TC && gc < p.m)
        out[static_cast<long>(gr) * p.m + gc] = sw[at<L>(wr, wc)];
    }
  }
}

// Stage the window (and, up, e's coarse window), read the centre
// coefficients, and form each cell's factor once: 1/cc on a leg, omega /
// cc with the sweep's omegas[p.om[0]] (IEEE division; inf outside the
// grid, where no cell is updated).
template <typename L>
__device__ __forceinline__ void stage(const float* __restrict__ u,
                                      const float* __restrict__ e,
                                      const float* __restrict__ b,
                                      const float* __restrict__ c, float* sw,
                                      const VarLeg& p, int r0, int c0,
                                      const float* __restrict__ omegas,
                                      float cc[2][L::KR],
                                      float dv[2][L::KR]) {
  stage_window<L>(u, b, c, sw, p, r0, c0);
  if constexpr (L::UP)
    stage_coarse<L>(e, sw + STAGED * L::PLANE, p, (r0 >> 1) - 1,
                    (c0 >> 1) - 1);
  load_centre<L>(c, p, r0, c0, cc);
  const float num = L::SWEEP ? omegas[p.om[0]] : 1.0f;
  copy_wait_all();
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int k = 0; k < L::KR; ++k) dv[q][k] = num / cc[q][k];
  __syncthreads();
}

template <int S, bool RB>
__global__ void __launch_bounds__(VarShape<kVarDown, S, RB>::THREADS,
                                  VarShape<kVarDown, S, RB>::BLOCKS)
downleg_var_kernel(const float* __restrict__ u, const float* __restrict__ b,
                   const float* __restrict__ c,
                   const float* __restrict__ omegas, float* __restrict__ u_out,
                   float* __restrict__ rc, VarLeg p) {
  using L = VarShape<kVarDown, S, RB>;
  extern __shared__ float sw[];
  const int r0 = blockIdx.y * L::TR - L::H, c0 = blockIdx.x * L::TC - L::H;
  float cc[2][L::KR], dv[2][L::KR];
  stage<L>(u, nullptr, b, c, sw, p, r0, c0, omegas, cc, dv);
  leg_passes<L>(sw, omegas, p, 0, cc, dv, r0, c0);
  store_tile_var<L>(sw, u_out, p, r0, c0);
  residual_in_place<L>(sw, cc);
  __syncthreads();
  restrict_tile<L>(sw, rc, p);
}

template <int S, bool RB>
__global__ void __launch_bounds__(VarShape<kVarUp, S, RB>::THREADS,
                                  VarShape<kVarUp, S, RB>::BLOCKS)
upleg_var_kernel(const float* __restrict__ u, const float* __restrict__ e,
                 const float* __restrict__ b, const float* __restrict__ c,
                 const float* __restrict__ omegas, float* __restrict__ u_out,
                 VarLeg p) {
  using L = VarShape<kVarUp, S, RB>;
  extern __shared__ float sw[];
  const int r0 = blockIdx.y * L::TR - L::H, c0 = blockIdx.x * L::TC - L::H;
  float cc[2][L::KR], dv[2][L::KR];
  stage<L>(u, e, b, c, sw, p, r0, c0, omegas, cc, dv);
  correct<L>(sw, sw + STAGED * L::PLANE, p, omegas[p.om[0]], r0, c0);
  __syncthreads();
  leg_passes<L>(sw, omegas, p, 1, cc, dv, r0, c0);
  store_tile_var<L>(sw, u_out, p, r0, c0);
}

// The red-black sweep's form: one red-black sweep in window class 1.
using SweepShape = VarShape<kVarSweep, 1, true, 1>;

// One red-black sweep: the two half-sweeps (halo 2), then the tile.
__global__ void __launch_bounds__(SweepShape::THREADS, SweepShape::BLOCKS)
rbgs_var_kernel(const float* __restrict__ u, const float* __restrict__ b,
                const float* __restrict__ c,
                const float* __restrict__ omegas, float* __restrict__ out,
                VarLeg p) {
  using L = SweepShape;
  extern __shared__ float sw[];
  const int r0 = blockIdx.y * L::TR - L::H, c0 = blockIdx.x * L::TC - L::H;
  float cc[2][L::KR], dv[2][L::KR];
  stage<L>(u, nullptr, b, c, sw, p, r0, c0, omegas, cc, dv);
  leg_passes<L>(sw, omegas, p, 0, cc, dv, r0, c0);
  store_tile_var<L>(sw, out, p, r0, c0);
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

VarLeg make_leg(const double* taps, const int* om_ids, int n_ids, int n,
                int m) {
  VarLeg p;
  for (int k = 0; k < 3; ++k) {
    p.tr[k] = static_cast<float>(taps[k]);
    p.tc[k] = static_cast<float>(taps[3 + k]);
  }
  for (int k = 0; k <= MAX_SWEEPS; ++k) p.om[k] = k < n_ids ? om_ids[k] : 0;
  p.n = n;
  p.m = m;
  return p;
}

// Shared memory above 48 KB needs an explicit opt-in per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

bool bad_shape(int n, int m) { return n < 3 || m < 3 || !(n & 1) || !(m & 1); }

// One instantiation of a windowed kernel: its kernel, halo, tile, threads
// and dynamic shared memory.
struct VarInst {
  const void* kernel;
  int halo, tile_rows, tile_cols, threads, smem;
};

template <int F, int S, bool RB, int K = 0>
VarInst var_inst() {
  using L = VarShape<F, S, RB, K>;
  const void* kernel;
  if constexpr (F == kVarDown)
    kernel = reinterpret_cast<const void*>(downleg_var_kernel<S, RB>);
  else if constexpr (F == kVarUp)
    kernel = reinterpret_cast<const void*>(upleg_var_kernel<S, RB>);
  else
    kernel = reinterpret_cast<const void*>(rbgs_var_kernel);
  return {kernel, L::H, L::TR, L::TC, L::THREADS, L::SMEM};
}

template <int F, bool RB>
VarInst var_inst_of_sweeps(int sweeps) {
  switch (sweeps) {
    case 1:
      return var_inst<F, 1, RB>();
    case 2:
      return var_inst<F, 2, RB>();
    case 3:
      return var_inst<F, 3, RB>();
    default:
      return {};
  }
}

// The instantiation of a leg; kernel null for a sweep count it lacks.
VarInst find_var_leg(bool down, int sweeps, bool red_black) {
  if (down)
    return red_black ? var_inst_of_sweeps<kVarDown, true>(sweeps)
                     : var_inst_of_sweeps<kVarDown, false>(sweeps);
  return red_black ? var_inst_of_sweeps<kVarUp, true>(sweeps)
                   : var_inst_of_sweeps<kVarUp, false>(sweeps);
}

// The red-black sweep's instantiation.
VarInst var_sweep() { return var_inst<kVarSweep, 1, true, 1>(); }

// Launch an instantiation (null: refused) on an n x m grid.  args: the
// kernel's arguments.
cudaError_t launch_var(const VarInst& inst, int n, int m, void** args,
                       void* stream) {
  if (!inst.kernel) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(inst.kernel, inst.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + inst.tile_cols - 1) / inst.tile_cols,
                  (n + inst.tile_rows - 1) / inst.tile_rows);
  err = cudaLaunchKernel(inst.kernel, grid, dim3(WIN_SLOTS, WIN_NY), args,
                         inst.smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Launch a leg with the halo the caller derived; refuse a halo the
// instantiation was not built for.
cudaError_t launch_var_leg(bool down, int sweeps, int red_black, int halo,
                           int n, int m, void** args, void* stream) {
  if (bad_shape(n, m)) return cudaErrorInvalidValue;
  const VarInst inst = find_var_leg(down, sweeps, red_black != 0);
  if (halo != inst.halo) return cudaErrorInvalidValue;
  return launch_var(inst, n, m, args, stream);
}

// What an instantiation is on this card: info[0], [1] its tile's rows and
// columns, [2] its halo, [3] threads per block, [4] resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at its shared memory),
// [5] registers per thread, [6] local memory per thread in bytes (spills
// land there), [7] dynamic shared memory per block in bytes.
cudaError_t var_info(const VarInst& inst, int* info) {
  if (!inst.kernel) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(inst.kernel, inst.smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, inst.kernel,
                                                      inst.threads, inst.smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, inst.kernel);
  if (err != cudaSuccess) return err;
  info[0] = inst.tile_rows;
  info[1] = inst.tile_cols;
  info[2] = inst.halo;
  info[3] = inst.threads;
  info[4] = blocks;
  info[5] = attr.numRegs;
  info[6] = static_cast<int>(attr.localSizeBytes);
  info[7] = inst.smem;
  return cudaSuccess;
}

}  // namespace

// c: the (5, n, m) coefficient stack.  om: index of the relaxation factor
// in omegas.  red_black: 1 one red-black sweep, 0 one Jacobi sweep.
// Returns the launch's cudaError_t.
extern "C" int es_sweep_var(const float* u, const float* b, const float* c,
                            const float* omegas, int om, int red_black,
                            float* out, int n, int m, void* stream) {
  if (n < 1 || m < 1) return cudaErrorInvalidValue;
  if (red_black) {
    VarLeg p = {};
    p.om[0] = om;
    p.n = n;
    p.m = m;
    void* args[] = {&u, &b, &c, &omegas, &out, &p};
    return launch_var(var_sweep(), n, m, args, stream);
  }
  const dim3 grid((m + JAC_BX - 1) / JAC_BX, (n + JAC_BY - 1) / JAC_BY);
  jacobi_var_kernel<<<grid, dim3(JAC_BX, JAC_BY), 0,
                      static_cast<cudaStream_t>(stream)>>>(u, b, c, omegas,
                                                           out, om, n, m);
  return cudaGetLastError();
}

// taps: 3 row taps, 3 column taps.  om_ids: `sweeps` indices into omegas,
// in the order the sweeps run.  halo: the window halo the caller derived
// for the down-leg of `sweeps` sweeps in this mode (any other is refused).
extern "C" int es_presmooth_residual_restrict_var(
    const float* u, const float* b, const float* c, const float* omegas,
    const int* om_ids, int sweeps, int red_black, const double* taps,
    float* u_out, float* rc, int halo, int n, int m, void* stream) {
  if (sweeps < 1 || sweeps > MAX_SWEEPS) return cudaErrorInvalidValue;
  VarLeg p = make_leg(taps, om_ids, sweeps, n, m);
  void* args[] = {&u, &b, &c, &omegas, &u_out, &rc, &p};
  return launch_var_leg(true, sweeps, red_black, halo, n, m, args, stream);
}

// om_ids: 1 + sweeps indices into omegas: the coarse-grid-correction factor,
// then the post-sweeps in the order they run.  halo: as above, for the
// up-leg.
extern "C" int es_prolong_correct_postsmooth_var(
    const float* u, const float* e, const float* b, const float* c,
    const float* omegas, const int* om_ids, int sweeps, int red_black,
    const double* taps, float* u_out, int halo, int n, int m, void* stream) {
  if (sweeps < 1 || sweeps > MAX_SWEEPS) return cudaErrorInvalidValue;
  VarLeg p = make_leg(taps, om_ids, sweeps + 1, n, m);
  void* args[] = {&u, &e, &b, &c, &omegas, &u_out, &p};
  return launch_var_leg(false, sweeps, red_black, halo, n, m, args, stream);
}

// What an instantiation of es_presmooth_residual_restrict_var (down 1) or
// es_prolong_correct_postsmooth_var (down 0) is on this card (var_info's
// eight ints).
extern "C" int es_var_leg_info(int down, int sweeps, int red_black,
                               int* info) {
  return var_info(find_var_leg(down != 0, sweeps, red_black != 0), info);
}

// What es_sweep_var's red-black sweep is on this card (var_info's eight
// ints).
extern "C" int es_sweep_var_info(int* info) {
  return var_info(var_sweep(), info);
}
