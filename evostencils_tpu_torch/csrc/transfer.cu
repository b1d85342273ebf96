// Fused V-cycle leg kernels for Hopper (sm_90a), float32 (the legs with
// both transfer axes also bf16 storage, see below).
//
// es_presmooth_residual_restrict replaces the TPU kernel
//   evostencils_tpu/ops/pallas/transfer.py presmooth_residual_restrict
//   (_smooth_rr_col_kernel):
//   S in [1, 3] damped red-black Gauss-Seidel sweeps of a constant 5-point
//   operator, then r = b - A u and the separable 3-tap 2:1 restriction of r,
//   writing (u_s (n, m), rc ((n-1)/2, (m-1)/2)).
// es_prolong_correct_postsmooth replaces
//   evostencils_tpu/ops/pallas/transfer.py prolong_correct_postsmooth_col
//   (_pc_smooth_col_kernel):
//   u += omega_0 * P(e) with the separable 3-tap 1:2 prolongation of the
//   coarse correction e, then S in [1, 3] red-black sweeps with omega_1..S.
// The same two entries with cols 0 replace presmooth_residual_rowrestrict
//   (_smooth_rr_kernel) and prolong_correct_postsmooth (_pc_smooth_kernel):
//   the legs with row-only transfers, rr ((n-1)/2, m) out or c_half
//   ((n-1)/2, m) in; the caller runs the column half.  All four legs and
//   both fused passes are forms of one windowed kernel,
//   col_leg_kernel<F, S, K>.
// es_upleg_downleg replaces upleg_downleg_col (_vleg_col_kernel) and, with
//   row-only transfers, upleg_downleg_fused (_vleg_kernel): the up-leg of
//   cycle k and the down-leg of cycle k+1 in one pass, u += omega_0 * P(e),
//   S in [1, 6] sweeps (the post-sweeps, then the next pre-sweeps), r and
//   its restriction, writing (u_next, rc) or (u_next, rr).
// es_residual_restrict replaces the TPU kernel
//   evostencils_tpu/ops/pallas/transfer.py residual_rowrestrict (_rr_kernel)
//   and the column restriction that compiler/lower.py:1338-1340 runs after
//   it in XLA: r = b - A u and the full 2:1 restriction, rc ((n-1)/2,
//   (m-1)/2), for smoother chains that no down-leg takes.  It is the
//   down-leg with no sweep, col_leg_kernel<kDown, 0, RR_WINDOW>.
// es_prolong_correct replaces prolong_row_correct (_pc_kernel) and the
//   column prolongation that lower.py:1373-1376 runs before it:
//   u + omega * P(e) with the full 1:2 prolongation of e.  It is the up-leg
//   with no sweep, col_leg_kernel<kUp, 0, PC_WINDOW>.
//
// What bounds them: device-memory bytes.  Each leg must read u and b once
// and write u once, plus the coarse array (rc written or e read); the
// arithmetic is a few dozen flops per point, far below the card's rate.
// The design keeps every intermediate sweep, the residual and the
// transfer inside shared memory, so a leg costs one pass over u and b
// instead of one pass per half-sweep; a fused pass saves a further read of
// u and b and a write of u per cycle.  es_residual_restrict and
// es_prolong_correct are single passes too: the first stages u's and b's
// windows as the down-leg does and walks the residual and restriction in
// registers, the second stages u's window and e's coarse window as the
// up-leg does (no b: it has no sweep) and corrects every window cell.
//
// The TPU kernel walks full-width row blocks in order.  Here thread blocks
// run in parallel.  Each one owns a tile of the fine grid and loads it with
// a ring of halo cells on every side, which it recomputes redundantly.
// Window-edge cells see zeros in place of their out-of-window neighbours;
// the error moves inward one cell per half-sweep, so after P = 2S
// half-sweeps only cells within P - 1 of the window edge are wrong.  The
// residual adds one ring and the restriction reads fine index 2i+2 past
// the tile, so a kernel that restricts needs a halo of P + 2 (2 with no
// sweep, the standalone residual restriction); the up-leg,
// whose prolongation is pointwise, needs P (0 with no sweep, the standalone
// prolongation-correction, whose tile is its window).  The prolongation is
// exact up to the window's edge (the coarse window covers it).  Tiles start
// at even interior indices, so every coarse point's 3x3 restriction window
// and every prolongation stencil lies in one tile, and red is (global row +
// global column) even in interior indices (interior index i is node i+1 on
// both axes, which leaves the parity unchanged).  Cells outside the grid
// hold 0 and are never updated (Dirichlet ring and ragged last tiles).
// Relaxation factors are read from the device vector by index, so no
// launch waits on the host.
//
// Design of the windowed kernels (col_leg_kernel<F, S, K>: the legs of
// every 2D Poisson V-cycle, with both transfer axes or row-only ones, the
// fused passes of the cycle loop in both forms, the standalone residual
// restriction, the down-leg of S = 0, and the standalone
// prolongation-correction, the up-leg of S = 0).  They are latency-bound
// before they are bandwidth-bound: a block loads, then runs its half-sweeps
// between barriers, so the card needs many small blocks resident to keep
// memory busy.  A block stages u and b over a window of one of N_LEG_WINDOWS
// classes K (64 x 64 or 32 x 64 cells, 256 threads, 40,960 or 20,480 bytes,
// and e's coarse window where the kernel prolongs e: 45,316 or 22,724); the
// caller picks the larger class when its tiles fill a wave of resident
// blocks on the card, else the smaller (ops/kernels/transfer.leg_window):
// the legs at 4095^2 and 2047^2 take 64 x 64, the levels from 1023^2 down
// 32 x 64.  The row-only up-leg and pass stage c_half's window too (51,520
// or 25,920 bytes), which leaves room for 4 blocks of the 64 x 64 class an
// SM.  The halo is the form's own: P + 2 on the down-legs and the fused
// passes, P on the up-legs, and the tile is the window less the halo on
// every side.  A class is built for a form and sweep count only if its tile
// keeps at least the halo's depth of rows (a window at most three tiles
// high): the 32 x 64 class serves passes of up to 4 sweeps.  Pass p updates
// only the window cells at a distance >= p from the window edge: their
// neighbours all lie in the window, so no read is predicated, and the cells
// still right after pass p are exactly those.  The windows are stored split
// by column parity (each row: its even columns, then its odd ones, the odd
// half padded to 16 banks), so a colour's cells of a row are contiguous: in
// a half-sweep lane x updates slot x of its rows, every lane busy, and
// every warp's reads are bank-conflict free; 5-point red-black updates in
// place.  u and b are loaded by 4-byte cp.async (a 4095-wide row is 16,380
// bytes, so rows are not 16-byte aligned), all of a thread's copies in
// flight at once; b staged beside u keeps the half-sweeps off the read-only
// cache's latency.  A kernel that prolongs e stages e's coarse window once
// and corrects every window cell from it; the row-only up-leg and pass
// stage the rows of c_half, already prolonged along columns, that the
// window needs (on an H100, at 4 blocks an SM, 9% faster than at 5 reading
// c_half through the cache).  A kernel that restricts forms the residual of
// the tile and one row (and column) past it in registers: lane x walks the
// fine rows of a run of coarse rows, u's rows above and below in registers,
// and restricts as it goes; with both transfer axes it takes coarse column
// x, row-only the fine columns 2x and 2x + 1.
// The standalone prolongation-correction stages u's window and e's coarse
// window only, corrects every window cell from them and stores the window:
// with no sweep the tile is the window, so no cell is loaded twice, and no
// thread divides to find its point or reads e through the cache behind a
// branch.  It has a class of its own, PC_WINDOW (16 x 64 cells, 6,308
// bytes, 8 blocks an SM): on an H100 it beat 32 x 64 by 0.0005-0.0006 ms
// at 511^2 and 255^2, where few blocks run and each one's load, barrier
// and store set the time, tied at 1023^2 and lost 0.0008 at 4095^2; 8 x 64
// won 0.0002-0.0003 at 511^2 and 255^2 and lost 0.0073 at 4095^2, 64 x 64
// lost at every level, and reading u into registers with only e staged
// gained nothing.
// tests/test_torch_transfer_tiles.py and tests/test_torch_fused_tiles.py
// emulate this schedule in float64, and es_transfer_leg_info reports each
// instantiation's tile, halo and occupancy from the card.
//
// bf16 storage (es_presmooth_residual_restrict_bf16,
// es_prolong_correct_postsmooth_bf16): the legs with both transfer axes
// also take u, b, e and their outputs as bf16, col_leg_kernel<F, S, K,
// bf16> for F kDown and kUp with 1..3 sweeps, as the TPU kernels load
// their storage type and compute in float32 (transfer.py:774-779,
// :876-879).  A bf16 leg moves half the bytes of a float32 one.  One
// 4-byte word of a bf16 row holds an even and an odd column, which a
// 4-byte cp.async cannot split into the windows' column-parity halves, and
// a row of odd width starts on a 2-byte boundary every other row; so a
// thread loads each bf16 value with a plain read, widens it to float and
// stores it into the same float windows the float32 kernel stages by
// cp.async.  Every pass, residual and transfer then runs the float32
// code, every sum and omega product in float registers and shared
// memory, and each output value is rounded once on store (round to
// nearest even, as the TPU kernel's .astype(out_ref.dtype) rounds).
// es_transfer_leg_info_bf16 reports those instantiations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "cp_async.cuh"

namespace {

constexpr int MAX_SWEEPS = 3;
constexpr int MAX_FUSED_SWEEPS = 2 * MAX_SWEEPS;

struct Leg {
  // 5-point stencil: center and the neighbours up (-1,0), down (+1,0),
  // left (0,-1) and right (0,+1)
  float c, a_up, a_dn, a_lf, a_rt;
  // 1/c and the neighbour coefficients scaled by it
  float dinv, d_up, d_dn, d_lf, d_rt;
  // row and column transfer taps of a leg; of a fused pass, the
  // restriction's
  float tr[3], tc[3];
  // the prolongation's taps: a fused pass's own, else tr and tc
  float pr[3], pc[3];
  // indices into the relaxation-factor vector
  int om[MAX_FUSED_SWEEPS + 1];
  int sweeps;
  int n, m;
};

// ---------------------------------------------------------------------------
// The windowed kernels: col_leg_kernel<F, S, K> in the forms F of
// es_presmooth_residual_restrict, es_prolong_correct_postsmooth,
// es_upleg_downleg, es_residual_restrict and es_prolong_correct (see the
// design note at the top).
// ---------------------------------------------------------------------------

// The forms, numbered as es_transfer_leg_info takes them: the up-leg, the
// down-leg, the fused pass with both transfer axes or row-only ones, and
// the row-only down-leg and up-leg.
enum Form : int {
  kUp = 0, kDown = 1, kPassCols = 2, kPassRows = 3, kDownRows = 4,
  kUpRows = 5
};

// Shared memory of an SM that blocks can hold, and what each block
// reserves besides its own.
constexpr int SM_SMEM = 228 * 1024, BLOCK_SMEM_RESERVED = 1024;

// Window class K: ROWS x 2 SLOTS cells, blocks of SLOTS x NY threads,
// BLOCKS resident on an SM where shared memory allows (__launch_bounds__).
// NY is even, so the rows of one thread share a parity.
template <int K>
struct LegWindow;
template <>
struct LegWindow<0> {
  static constexpr int ROWS = 64, SLOTS = 32, NY = 8, BLOCKS = 5;
};
template <>
struct LegWindow<1> {
  static constexpr int ROWS = 32, SLOTS = 32, NY = 8, BLOCKS = 6;
};
template <>
struct LegWindow<2> {
  static constexpr int ROWS = 16, SLOTS = 32, NY = 8, BLOCKS = 8;
};
// The legs' and passes' classes (0 and 1), and all classes
constexpr int N_LEG_WINDOWS = 2, N_WINDOWS = 3;
// The standalone residual restriction's one class: with no sweep, 32 x 64
// beats 64 x 64 at every level from 4095^2 down on an H100.
constexpr int RR_WINDOW = 1;
// The standalone prolongation-correction's one class, which nothing else
// takes (see the design note at the top).
constexpr int PC_WINDOW = 2;

// Form F of S sweeps in window class K: P = 2S half-sweeps, the halo (P on
// the up-legs, P + 2 where the kernel restricts), the tile, and the
// windows' layout.  Row wr of a window holds its even columns at wr * RS +
// wc / 2 and its odd ones at wr * RS + ODD + wc / 2; ODD is SLOTS padded
// to 16 mod 32 banks, so that 32 consecutive columns from an even one fall
// in 32 banks.  b's window (B floats on) follows u's, and the coarse
// operand's window follows both: e's, CR x CC values, where the kernel
// prolongs e, c_half's, CR rows in u's layout, in the row-only up-leg and
// pass.  The standalone prolongation-correction (PC) stages no b.  The
// class is built for the form only if the tile keeps at least H rows.
template <int F, int S, int K>
struct ColLeg {
  using Win = LegWindow<K>;
  static constexpr bool PASS = F == kPassCols || F == kPassRows;
  // the up-legs (halo P, nothing restricted), the forms that restrict
  // along rows only, and the down-legs (nothing corrected, so the passes
  // start at omegas[om[0]])
  static constexpr bool UP = F == kUp || F == kUpRows;
  static constexpr bool ROWS = F == kPassRows || F == kDownRows;
  static constexpr bool DOWN = F == kDown || F == kDownRows;
  static constexpr int P = 2 * S;
  static constexpr int H = UP ? P : P + 2;
  static constexpr int WR = Win::ROWS, SL = Win::SLOTS, NY = Win::NY;
  static constexpr int WC = 2 * SL;
  static constexpr int THREADS = SL * NY;
  static constexpr int TR = WR - 2 * H, TC = WC - 2 * H;
  static constexpr int ODD = SL + (48 - SL % 32) % 32;
  static constexpr int RS = ODD + SL;
  static constexpr int B = WR * RS;
  static constexpr int CR = WR / 2 + 1, CC = SL + 1;
  static constexpr bool STAGES_E = F == kUp || F == kPassCols;
  static constexpr bool STAGES_HALF = F == kUpRows || F == kPassRows;
  // the up-leg of no sweep: the standalone prolongation-correction
  static constexpr bool PC = F == kUp && S == 0;
  static constexpr bool STAGES_B = !PC;
  // the fine windows staged (u's, b's), e's or c_half's window after them
  static constexpr int FINE = STAGES_B ? 2 : 1;
  static constexpr int SMEM =
      (FINE * B + (STAGES_E ? CR * CC : STAGES_HALF ? CR * RS : 0)) *
      static_cast<int>(sizeof(float));
  static constexpr int FIT = SM_SMEM / (SMEM + BLOCK_SMEM_RESERVED);
  static constexpr int BLOCKS = FIT < Win::BLOCKS ? FIT : Win::BLOCKS;
  // S >= 1 in the legs' classes; S = 0 only for the down-leg in class
  // RR_WINDOW, the standalone residual restriction, and the up-leg in
  // class PC_WINDOW, the standalone prolongation-correction
  static constexpr bool BUILT =
      (S >= 1 ? K < N_LEG_WINDOWS
              : (F == kDown && K == RR_WINDOW) ||
                    (F == kUp && K == PC_WINDOW)) &&
      S <= (PASS ? MAX_FUSED_SWEEPS : MAX_SWEEPS) && TR >= H;
  static_assert(NY % 2 == 0 && WR % NY == 0 && TC > 0,
                "a window class must fit the form's halo");
};

template <typename L>
__device__ __forceinline__ int split_at(int wr, int wc) {
  return wr * L::RS + (wc & 1) * L::ODD + (wc >> 1);
}

using bf16 = __nv_bfloat16;

// Form F of S sweeps in window class K is built for storage type T: every
// built form for float, the legs with both transfer axes and a sweep for
// bf16.
template <int F, int S, int K, typename T>
constexpr bool kBuilt =
    ColLeg<F, S, K>::BUILT &&
    (std::is_same_v<T, float> || ((F == kUp || F == kDown) && S >= 1));

// One value of a field into its float window slot: a float by cp.async,
// a bf16 read and widened to float; zero when !in (src is then not read).
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      bool in) {
  copy_async(dst, src, in);
}
__device__ __forceinline__ void stage(float* dst, const bf16* src, bool in) {
  *dst = in ? __bfloat162float(__ldg(src)) : 0.f;
}

// One float result into its storage type, rounded once (to nearest even).
__device__ __forceinline__ void store_value(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store_value(bf16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

// u and b (b only where the form stages it) over the window whose top-left
// interior index is (r0, c0), zero outside the grid, issued by cp.async
// (float; bf16 read and widened, stage()): lane x copies columns x and
// x + SLOTS of its rows.
template <typename L, typename T>
__device__ __forceinline__ void load_window_split(const T* __restrict__ u,
                                                  const T* __restrict__ b,
                                                  float* su, const Leg& p,
                                                  int r0, int c0) {
  // a bf16 value waits in a register until it is widened and stored, so
  // a bf16 window is loaded BATCH rows of a thread at a time (8 values in
  // flight): all at once, the legs of 2 and 3 sweeps in the 64 x 64 class
  // spill on an H100
  constexpr int ROWS = L::WR / L::NY;
  constexpr int BATCH = std::is_same_v<T, float> ? ROWS : 2;
#pragma unroll 1
  for (int k0 = 0; k0 < ROWS; k0 += BATCH) {
#pragma unroll
    for (int k = k0; k < k0 + BATCH; ++k) {
      const int wr = threadIdx.y + k * L::NY, gr = r0 + wr;
      const bool row_in = gr >= 0 && gr < p.n;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int wc = threadIdx.x + j * L::SL, gc = c0 + wc;
        const bool in = row_in && gc >= 0 && gc < p.m;
        const long g = in ? static_cast<long>(gr) * p.m + gc : 0;
        float* dst = su + split_at<L>(wr, wc);
        stage(dst, u + g, in);
        if constexpr (L::STAGES_B) stage(dst + L::B, b + g, in);
      }
    }
  }
}

// e's coarse window: coarse rows cr0 .. cr0 + CR - 1 and columns cc0 ..
// cc0 + CC - 1, row-major, zero outside the coarse grid.
template <typename L, typename T>
__device__ __forceinline__ void load_coarse_split(const T* __restrict__ e,
                                                  float* se, const Leg& p,
                                                  int cr0, int cc0) {
  const int nc = (p.n - 1) / 2, mc = (p.m - 1) / 2;
#pragma unroll
  for (int k = 0; k < (L::CR + L::NY - 1) / L::NY; ++k) {
    const int i = threadIdx.y + k * L::NY, ci = cr0 + i;
    if (i >= L::CR) break;
#pragma unroll
    for (int j0 = 0; j0 < L::CC; j0 += L::SL) {
      const int j = j0 + threadIdx.x, cj = cc0 + j;
      if (j >= L::CC) break;
      const bool in = ci >= 0 && ci < nc && cj >= 0 && cj < mc;
      stage(se + i * L::CC + j,
            in ? e + static_cast<long>(ci) * mc + cj : e, in);
    }
  }
}

// c_half's window: coarse rows cr0 .. cr0 + CR - 1 at the window's fine
// columns, split by column parity as u's rows are, zero outside the grid.
template <typename L>
__device__ __forceinline__ void load_half_split(const float* __restrict__ ch,
                                                float* sc, const Leg& p,
                                                int cr0, int c0) {
  const int nc = (p.n - 1) / 2;
#pragma unroll
  for (int k = 0; k < (L::CR + L::NY - 1) / L::NY; ++k) {
    const int i = threadIdx.y + k * L::NY, ci = cr0 + i;
    if (i >= L::CR) break;
    const bool row_in = ci >= 0 && ci < nc;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int wc = threadIdx.x + j * L::SL, gc = c0 + wc;
      const bool in = row_in && gc >= 0 && gc < p.m;
      copy_async(sc + split_at<L>(i, wc),
                 in ? ch + static_cast<long>(ci) * p.m + gc : ch, in);
    }
  }
}

// Half-sweep PASS (1-based) on the window cells at a distance >= PASS from
// its edge: red (an even sum of interior indices) on odd passes, black on
// even ones, in place (the four neighbours of a cell have the other
// colour).  Lane x updates the cell of slot x of the colour's half of each
// of its rows.
template <typename L, int PASS>
__device__ __forceinline__ void col_pass(float* su, float om, const Leg& p,
                                         int r0, int c0) {
  constexpr int colour = (PASS - 1) & 1;
  const int s = threadIdx.x, ty = threadIdx.y;
  // r0 + c0 is even and every row of this thread has ty's parity, so the
  // colour's cells of its rows all have column parity h
  const int h = (colour + ty) & 1;
  const int wc = 2 * s + h, gc = c0 + wc;
  if (wc < PASS || wc > L::WC - 1 - PASS || gc < 0 || gc >= p.m) return;
  float* cell = su + h * L::ODD + s;
  // the right neighbour, in the other half; the left one precedes it
  const float* right = su + (1 - h) * L::ODD + s + h;
#pragma unroll
  for (int k = 0; k < L::WR / L::NY; ++k) {
    const int wr = ty + k * L::NY, gr = r0 + wr;
    if (wr < PASS || wr > L::WR - 1 - PASS || gr < 0 || gr >= p.n) continue;
    float* c = cell + wr * L::RS;
    const float* rt = right + wr * L::RS;
    const float v = c[0];
    const float off = p.d_up * c[-L::RS] + p.d_dn * c[L::RS] +
                      p.d_lf * rt[-1] + p.d_rt * rt[0];
    c[0] = v + om * (p.dinv * c[L::B] - v - off);
  }
}

// Passes PASS..P, each followed by a barrier; pass q runs sweep (q - 1) / 2
// with omegas[p.om[om_first + (q - 1) / 2]].
template <typename L, int PASS = 1>
__device__ __forceinline__ void col_passes(float* su,
                                           const float* __restrict__ omegas,
                                           const Leg& p, int om_first, int r0,
                                           int c0) {
  if constexpr (PASS <= L::P) {
    col_pass<L, PASS>(su, omegas[p.om[om_first + (PASS - 1) / 2]], p, r0, c0);
    __syncthreads();
    col_passes<L, PASS + 1>(su, omegas, p, om_first, r0, c0);
  }
}

// The tile of the window to out: lane x stores columns H + x and
// H + x + SLOTS of its rows.
template <typename L, typename T>
__device__ __forceinline__ void store_tile_split(const float* su,
                                                 T* __restrict__ out,
                                                 const Leg& p, int r0,
                                                 int c0) {
#pragma unroll
  for (int k = 0; k < (L::TR + L::NY - 1) / L::NY; ++k) {
    const int wr = L::H + threadIdx.y + k * L::NY, gr = r0 + wr;
    if (wr >= L::H + L::TR || gr >= p.n) break;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int wc = L::H + threadIdx.x + j * L::SL, gc = c0 + wc;
      if (wc < L::H + L::TC && gc < p.m)
        store_value(out + static_cast<long>(gr) * p.m + gc,
                    su[split_at<L>(wr, wc)]);
    }
  }
}

// The window values of row wr at columns H + 2j + Q .. H + 2j + Q + N - 1
// (H is even, so column H + 2j + q lies in the half of q's parity).
template <typename L, int Q, int N>
__device__ __forceinline__ void row_values(const float* w, int wr, int j,
                                           float v[N]) {
  const float* ev = w + wr * L::RS + L::H / 2 + j;
#pragma unroll
  for (int q = Q; q < Q + N; ++q)
    v[q - Q] = (q & 1) ? ev[L::ODD + ((q - 1) >> 1)] : ev[q >> 1];
}

// r = b - A u on the tile and one row and column past it, and its full
// restriction into rc: lane x takes coarse column x of the tile and each
// thread row a run of RUN coarse rows, walking its fine rows 2i .. 2i + 2
// once with u's rows above and below in registers.  Each coarse value is
// the row taps first, then the column taps (transfer.py:802-807).
template <typename L, typename T>
__device__ __forceinline__ void residual_restrict_split(
    const float* su, T* __restrict__ rc, const Leg& p, int r0, int c0) {
  constexpr int CTR = L::TR / 2, CTC = L::TC / 2;
  constexpr int RUN = (CTR + L::NY - 1) / L::NY;
  const int j = threadIdx.x, i0 = threadIdx.y * RUN;
  const int len = min(RUN, CTR - i0);
  if (j >= CTC || len <= 0) return;
  const int nc = (p.n - 1) / 2, mc = (p.m - 1) / 2;
  const int ci0 = blockIdx.y * CTR + i0, cj = blockIdx.x * CTC + j;
  const int gc = c0 + L::H + 2 * j;
  const int wr0 = L::H + 2 * i0;
  float up[5], cur[5], pend[3];
  row_values<L, -1, 5>(su, wr0 - 1, j, up);
  row_values<L, -1, 5>(su, wr0, j, cur);
#pragma unroll
  for (int x = 0; x <= 2 * RUN; ++x) {
    if (x > 2 * len) break;
    const int gr = r0 + wr0 + x;
    float dn[5], bv[3], r[3];
    row_values<L, -1, 5>(su, wr0 + x + 1, j, dn);
    row_values<L, 0, 3>(su + L::B, wr0 + x, j, bv);
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      r[e] = 0.f;
      if (gr < p.n && gc + e < p.m) {
        const float au = p.c * cur[e + 1] + p.a_up * up[e + 1] +
                         p.a_dn * dn[e + 1] + p.a_lf * cur[e] +
                         p.a_rt * cur[e + 2];
        r[e] = bv[e] - au;
      }
    }
    if (x & 1) {
#pragma unroll
      for (int e = 0; e < 3; ++e) pend[e] += p.tr[1] * r[e];
    } else {
      const int ci = ci0 + x / 2 - 1;   // the coarse row this row ends
      if (x > 0) {
#pragma unroll
        for (int e = 0; e < 3; ++e) pend[e] += p.tr[2] * r[e];
        if (ci < nc && cj < mc)
          store_value(rc + static_cast<long>(ci) * mc + cj,
                      p.tc[0] * pend[0] + p.tc[1] * pend[1] +
                          p.tc[2] * pend[2]);
      }
#pragma unroll
      for (int e = 0; e < 3; ++e) pend[e] = p.tr[0] * r[e];
    }
#pragma unroll
    for (int e = 0; e < 5; ++e) {
      up[e] = cur[e];
      cur[e] = dn[e];
    }
  }
}

// r = b - A u on the tile and one row past it, and its row restriction
// into rr ((n-1)/2, m), rr[i, j] = tr[0] r[2i, j] + tr[1] r[2i+1, j] +
// tr[2] r[2i+2, j] (transfer.py:265-271): lane x takes the tile's fine
// columns 2x and 2x + 1 (slot x of both halves) and each thread row a run
// of RUN coarse rows, walking its fine rows once with u's rows above and
// below in registers.
template <typename L>
__device__ __forceinline__ void residual_rowrestrict_split(
    const float* su, float* __restrict__ rr, const Leg& p, int r0, int c0) {
  constexpr int CTR = L::TR / 2;
  constexpr int RUN = (CTR + L::NY - 1) / L::NY;
  const int j = threadIdx.x, i0 = threadIdx.y * RUN;
  const int len = min(RUN, CTR - i0);
  if (2 * j >= L::TC || len <= 0) return;
  const int nc = (p.n - 1) / 2;
  const int ci0 = blockIdx.y * CTR + i0;
  const int gc = c0 + L::H + 2 * j;
  const int wr0 = L::H + 2 * i0;
  float up[4], cur[4], pend[2];
  row_values<L, -1, 4>(su, wr0 - 1, j, up);
  row_values<L, -1, 4>(su, wr0, j, cur);
#pragma unroll
  for (int x = 0; x <= 2 * RUN; ++x) {
    if (x > 2 * len) break;
    const int gr = r0 + wr0 + x;
    float dn[4], bv[2], r[2];
    row_values<L, -1, 4>(su, wr0 + x + 1, j, dn);
    row_values<L, 0, 2>(su + L::B, wr0 + x, j, bv);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      r[e] = 0.f;
      if (gr < p.n && gc + e < p.m) {
        const float au = p.c * cur[e + 1] + p.a_up * up[e + 1] +
                         p.a_dn * dn[e + 1] + p.a_lf * cur[e] +
                         p.a_rt * cur[e + 2];
        r[e] = bv[e] - au;
      }
    }
    if (x & 1) {
#pragma unroll
      for (int e = 0; e < 2; ++e) pend[e] += p.tr[1] * r[e];
    } else {
      const int ci = ci0 + x / 2 - 1;   // the coarse row this row ends
      if (x > 0 && ci < nc) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (gc + e < p.m)
            rr[static_cast<long>(ci) * p.m + gc + e] =
                pend[e] + p.tr[2] * r[e];
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) pend[e] = p.tr[0] * r[e];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      up[e] = cur[e];
      cur[e] = dn[e];
    }
  }
}

// u += om0 * P(e) on every window cell in the grid, from e's staged coarse
// window: fine index 2i+1+o takes taps[o+1] * e[i] on each axis, the column
// expansion first, then the row expansion (transfer.py:896-903), with the
// prolongation's taps p.pr, p.pc.  The window starts at even (r0, c0) and
// its coarse window at r0 / 2 - 1, so slot s of a row reads coarse columns
// s and s + 1, and row wr coarse rows wr / 2 and wr / 2 + 1 (even) or
// (wr + 1) / 2 (odd).
template <typename L>
__device__ __forceinline__ void correct_split(float* su, const float* se,
                                              const Leg& p, float om0, int r0,
                                              int c0) {
  const int s = threadIdx.x, ty = threadIdx.y;
  // the column expansion of coarse window row `er` at column parity h
  const auto col = [&p](const float* er, int h) {
    return h ? p.pc[1] * er[1] : p.pc[2] * er[0] + p.pc[0] * er[1];
  };
#pragma unroll
  for (int k = 0; k < L::WR / L::NY; ++k) {
    const int wr = ty + k * L::NY, gr = r0 + wr;
    if (gr < 0 || gr >= p.n) continue;
    // coarse window row wr / 2 + 1 (even wr) or (wr + 1) / 2 (odd wr)
    const float* er = se + ((wr >> 1) + 1) * L::CC + s;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gc = c0 + 2 * s + h;
      if (gc < 0 || gc >= p.m) continue;
      const float corr =
          (wr & 1) ? p.pr[1] * col(er, h)
                   : p.pr[2] * col(er - L::CC, h) + p.pr[0] * col(er, h);
      su[wr * L::RS + h * L::ODD + s] += om0 * corr;
    }
  }
}

// u += om0 * P_row(c_half) on every window cell in the grid, from
// c_half's staged window: fine row 2i+1 takes pr[1] c[i], fine row 2i
// takes pr[2] c[i-1] + pr[0] c[i] (transfer.py:487-490), 0 outside the
// coarse rows.  The coarse window starts at r0 / 2 - 1, so row wr reads
// coarse window rows wr / 2 and wr / 2 + 1 (even) or (wr + 1) / 2 (odd);
// lane x corrects slot x of both halves of its rows.
template <typename L>
__device__ __forceinline__ void correct_rows_split(float* su, const float* sc,
                                                   const Leg& p, float om0,
                                                   int r0, int c0) {
  const int s = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int k = 0; k < L::WR / L::NY; ++k) {
    const int wr = ty + k * L::NY, gr = r0 + wr;
    if (gr < 0 || gr >= p.n) continue;
    // coarse window row wr / 2 + 1 (even wr) or (wr + 1) / 2 (odd wr)
    const float* cr = sc + ((wr >> 1) + 1) * L::RS + s;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gc = c0 + 2 * s + h;
      if (gc < 0 || gc >= p.m) continue;
      const float* c = cr + h * L::ODD;
      const float corr = (wr & 1) ? p.pr[1] * c[0]
                                  : p.pr[2] * c[-L::RS] + p.pr[0] * c[0];
      su[wr * L::RS + h * L::ODD + s] += om0 * corr;
    }
  }
}

// Form F of S sweeps in window class K.  e: e ((n-1)/2, (m-1)/2) (kUp,
// kPassCols) or c_half ((n-1)/2, m) (kUpRows, kPassRows), not read by the
// down-legs; r_out: rc ((n-1)/2, (m-1)/2) (kDown, kPassCols) or rr
// ((n-1)/2, m) (kDownRows, kPassRows), not written by the up-legs.  T:
// the storage type of u, e, b and the outputs (kBuilt).
template <int F, int S, int K, typename T = float>
__global__ void __launch_bounds__(ColLeg<F, S, K>::THREADS,
                                  ColLeg<F, S, K>::BLOCKS)
col_leg_kernel(const T* __restrict__ u, const T* __restrict__ e,
               const T* __restrict__ b, const float* __restrict__ omegas,
               T* __restrict__ u_out, T* __restrict__ r_out, Leg p) {
  using L = ColLeg<F, S, K>;
  extern __shared__ float su[];
  float* se = su + L::FINE * L::B;
  const int r0 = blockIdx.y * L::TR - L::H, c0 = blockIdx.x * L::TC - L::H;
  load_window_split<L>(u, b, su, p, r0, c0);
  if constexpr (L::STAGES_E)
    load_coarse_split<L>(e, se, p, (r0 >> 1) - 1, (c0 >> 1) - 1);
  else if constexpr (L::STAGES_HALF)
    load_half_split<L>(e, se, p, (r0 >> 1) - 1, c0);
  copy_wait_all();
  __syncthreads();
  if constexpr (!L::DOWN) {
    const float om0 = omegas[p.om[0]];
    if constexpr (L::STAGES_HALF)
      correct_rows_split<L>(su, se, p, om0, r0, c0);
    else
      correct_split<L>(su, se, p, om0, r0, c0);
    __syncthreads();
  }
  col_passes<L>(su, omegas, p, L::DOWN ? 0 : 1, r0, c0);
  if constexpr (S > 0 || L::PC) store_tile_split<L>(su, u_out, p, r0, c0);
  if constexpr (L::ROWS)
    residual_rowrestrict_split<L>(su, r_out, p, r0, c0);
  else if constexpr (!L::UP)
    residual_restrict_split<L>(su, r_out, p, r0, c0);
}

void set_taps(float* t, const double* c) {
  for (int k = 0; k < 3; ++k) t[k] = static_cast<float>(c[k]);
}

// coeffs: 5 stencil values, the row and column taps of the leg (tr, tc)
// and, for a fused pass (fused true), the prolongation's (pr, pc).
Leg make_leg(const double* coeffs, const int* om_ids, int n_ids, int sweeps,
             int n, int m, bool fused = false) {
  Leg p;
  const double c = coeffs[0], dinv = 1.0 / c;
  p.c = static_cast<float>(c);
  p.a_up = static_cast<float>(coeffs[1]);
  p.a_dn = static_cast<float>(coeffs[2]);
  p.a_lf = static_cast<float>(coeffs[3]);
  p.a_rt = static_cast<float>(coeffs[4]);
  p.dinv = static_cast<float>(dinv);
  p.d_up = static_cast<float>(coeffs[1] * dinv);
  p.d_dn = static_cast<float>(coeffs[2] * dinv);
  p.d_lf = static_cast<float>(coeffs[3] * dinv);
  p.d_rt = static_cast<float>(coeffs[4] * dinv);
  set_taps(p.tr, coeffs + 5);
  set_taps(p.tc, coeffs + 8);
  set_taps(p.pr, fused ? coeffs + 11 : coeffs + 5);
  set_taps(p.pc, fused ? coeffs + 14 : coeffs + 8);
  for (int k = 0; k <= MAX_FUSED_SWEEPS; ++k)
    p.om[k] = k < n_ids ? om_ids[k] : 0;
  p.sweeps = sweeps;
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

bool bad_shape(int n, int m) { return n < 3 || m < 3 || !(n & 1) || !(m & 1); }

// One instantiation of a windowed kernel: its kernel, halo, tile, block
// (SLOTS x NY threads), its __launch_bounds__ blocks per SM and dynamic
// shared memory; kernel null where the class is not built for the form.
struct ColInst {
  const void* kernel;
  int halo, tile_rows, tile_cols, slots, ny, blocks, smem;
};

template <int F, int S, int K, typename T>
ColInst col_inst() {
  using L = ColLeg<F, S, K>;
  if constexpr (!kBuilt<F, S, K, T>) {
    return {};
  } else {
    return {reinterpret_cast<const void*>(col_leg_kernel<F, S, K, T>), L::H,
            L::TR, L::TC, L::SL, L::NY, L::BLOCKS, L::SMEM};
  }
}

// The instantiation of form F for `sweeps` sweeps (S.. on) in `window`
// (K.. on) for storage type T; null for a count or class it lacks.
template <int F, typename T, int S = 0, int K = 0>
ColInst find_of_form(int sweeps, int window) {
  if constexpr (S > MAX_FUSED_SWEEPS) {
    return {};
  } else if constexpr (K == N_WINDOWS) {
    return find_of_form<F, T, S + 1, 0>(sweeps, window);
  } else {
    if (sweeps == S && window == K) return col_inst<F, S, K, T>();
    return find_of_form<F, T, S, K + 1>(sweeps, window);
  }
}

// bf16: storage in bf16, built for the forms kDown and kUp only.
ColInst find_col_leg(int form, int sweeps, int window, bool bf16_storage) {
  if (bf16_storage) {
    switch (form) {
      case kUp:
        return find_of_form<kUp, bf16>(sweeps, window);
      case kDown:
        return find_of_form<kDown, bf16>(sweeps, window);
      default:
        return {};
    }
  }
  switch (form) {
    case kUp:
      return find_of_form<kUp, float>(sweeps, window);
    case kDown:
      return find_of_form<kDown, float>(sweeps, window);
    case kPassCols:
      return find_of_form<kPassCols, float>(sweeps, window);
    case kPassRows:
      return find_of_form<kPassRows, float>(sweeps, window);
    case kDownRows:
      return find_of_form<kDownRows, float>(sweeps, window);
    case kUpRows:
      return find_of_form<kUpRows, float>(sweeps, window);
    default:
      return {};
  }
}

// Launch a windowed kernel in the window class the caller chose, with the
// halo it derived; refuse a halo the instantiation was not built for.
// args: the kernel's arguments.
cudaError_t launch_col_leg(int form, int sweeps, int halo, int window, int n,
                           int m, void** args, void* stream,
                           bool bf16_storage = false) {
  const ColInst inst = find_col_leg(form, sweeps, window, bf16_storage);
  if (!inst.kernel || halo != inst.halo) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(inst.kernel, inst.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + inst.tile_cols - 1) / inst.tile_cols,
                  (n + inst.tile_rows - 1) / inst.tile_rows);
  cudaLaunchKernel(inst.kernel, grid, dim3(inst.slots, inst.ny), args,
                   inst.smem, static_cast<cudaStream_t>(stream));
  return cudaGetLastError();
}

// What the card makes of an instantiation (es_transfer_leg_info).
int leg_info(int form, int sweeps, int window, bool bf16_storage,
             int* info) {
  const ColInst inst = find_col_leg(form, sweeps, window, bf16_storage);
  if (!inst.kernel) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(inst.kernel, inst.smem);
  if (err != cudaSuccess) return err;
  const int threads = inst.slots * inst.ny;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, inst.kernel,
                                                      threads, inst.smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, inst.kernel);
  if (err != cudaSuccess) return err;
  info[0] = inst.tile_rows;
  info[1] = inst.tile_cols;
  info[2] = inst.halo;
  info[3] = threads;
  info[4] = blocks;
  info[5] = attr.numRegs;
  info[6] = static_cast<int>(attr.localSizeBytes);
  info[7] = inst.smem;
  return cudaSuccess;
}

}  // namespace

extern "C" const char* es_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// coeffs: 5 stencil values (center, (-1,0), (+1,0), (0,-1), (0,+1)),
// 3 row taps, 3 column taps.  om_ids: `sweeps` indices into omegas, in the
// order the sweeps run.  cols 1: writes rc ((n-1)/2, (m-1)/2).  cols 0:
// writes the row-restricted residual rr ((n-1)/2, m), the column taps not
// read; replaces evostencils_tpu/ops/pallas/transfer.py
// presmooth_residual_rowrestrict (_smooth_rr_kernel).  halo: the window
// halo the caller derived for the down-leg of `sweeps` sweeps in that form
// (any other is refused); window: the window class (0 or 1) the caller
// chose for the level.  Returns the launch's cudaError_t.
extern "C" int es_presmooth_residual_restrict(
    const float* u, const float* b, const float* omegas, const int* om_ids,
    int sweeps, const double* coeffs, float* u_out, float* r_out, int cols,
    int halo, int window, int n, int m, void* stream) {
  if (sweeps < 1 || sweeps > MAX_SWEEPS || bad_shape(n, m))
    return cudaErrorInvalidValue;
  Leg p = make_leg(coeffs, om_ids, sweeps, sweeps, n, m);
  const float* e = nullptr;
  void* args[] = {&u, &e, &b, &omegas, &u_out, &r_out, &p};
  return launch_col_leg(cols ? kDown : kDownRows, sweeps, halo, window, n,
                        m, args, stream);
}

// om_ids: 1 + sweeps indices into omegas: the coarse-grid-correction factor,
// then the post-sweeps in the order they run.  cols 1: e ((n-1)/2,
// (m-1)/2) in.  cols 0: c_half ((n-1)/2, m) in, the coarse correction
// prolonged along columns already, corrected with the row taps (the
// column taps not read); replaces evostencils_tpu/ops/pallas/transfer.py
// prolong_correct_postsmooth (_pc_smooth_kernel).  halo, window: as above,
// for the up-leg.
extern "C" int es_prolong_correct_postsmooth(
    const float* u, const float* e, const float* b, const float* omegas,
    const int* om_ids, int sweeps, const double* coeffs, float* u_out,
    int cols, int halo, int window, int n, int m, void* stream) {
  if (sweeps < 1 || sweeps > MAX_SWEEPS || bad_shape(n, m))
    return cudaErrorInvalidValue;
  Leg p = make_leg(coeffs, om_ids, sweeps + 1, sweeps, n, m);
  float* r_out = nullptr;
  void* args[] = {&u, &e, &b, &omegas, &u_out, &r_out, &p};
  return launch_col_leg(cols ? kUp : kUpRows, sweeps, halo, window, n, m,
                        args, stream);
}

// es_presmooth_residual_restrict with both transfer axes in bf16
// storage: u, b, u_out and rc are bf16, omegas float32; replaces the TPU
// kernel's bf16 form (presmooth_residual_restrict, transfer.py:810, on a
// bf16 grid: _smooth_rr_col_kernel loads bf16, computes in float32 and
// rounds on store).  The other arguments as there.
extern "C" int es_presmooth_residual_restrict_bf16(
    const bf16* u, const bf16* b, const float* omegas, const int* om_ids,
    int sweeps, const double* coeffs, bf16* u_out, bf16* r_out, int halo,
    int window, int n, int m, void* stream) {
  if (sweeps < 1 || sweeps > MAX_SWEEPS || bad_shape(n, m))
    return cudaErrorInvalidValue;
  Leg p = make_leg(coeffs, om_ids, sweeps, sweeps, n, m);
  const bf16* e = nullptr;
  void* args[] = {&u, &e, &b, &omegas, &u_out, &r_out, &p};
  return launch_col_leg(kDown, sweeps, halo, window, n, m, args, stream,
                        true);
}

// es_prolong_correct_postsmooth with both transfer axes in bf16 storage:
// u, e, b and u_out are bf16, omegas float32; replaces the bf16 form of
// prolong_correct_postsmooth_col (transfer.py:917, _pc_smooth_col_kernel).
// The other arguments as there.
extern "C" int es_prolong_correct_postsmooth_bf16(
    const bf16* u, const bf16* e, const bf16* b, const float* omegas,
    const int* om_ids, int sweeps, const double* coeffs, bf16* u_out,
    int halo, int window, int n, int m, void* stream) {
  if (sweeps < 1 || sweeps > MAX_SWEEPS || bad_shape(n, m))
    return cudaErrorInvalidValue;
  Leg p = make_leg(coeffs, om_ids, sweeps + 1, sweeps, n, m);
  bf16* r_out = nullptr;
  void* args[] = {&u, &e, &b, &omegas, &u_out, &r_out, &p};
  return launch_col_leg(kUp, sweeps, halo, window, n, m, args, stream, true);
}

// What an instantiation of es_prolong_correct_postsmooth (form 0 with
// column transfers, 5 row-only), es_presmooth_residual_restrict (form 1,
// 4 row-only), es_residual_restrict (form 1, sweeps 0), es_prolong_correct
// (form 0, sweeps 0) or es_upleg_downleg (form 2, 3 row-only) is on this
// card:
// info[0], [1] its tile's rows and columns, [2] its halo, [3] threads per
// block, [4] resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at its shared memory),
// [5] registers per thread, [6] local memory per thread in bytes (spills
// land there), [7] dynamic shared memory per block in bytes.
extern "C" int es_transfer_leg_info(int form, int sweeps, int window,
                                    int* info) {
  return leg_info(form, sweeps, window, false, info);
}

// es_transfer_leg_info for the bf16-storage instantiations: form 0 (the
// up-leg, es_prolong_correct_postsmooth_bf16) or 1 (the down-leg,
// es_presmooth_residual_restrict_bf16), 1..3 sweeps, window class 0 or 1.
extern "C" int es_transfer_leg_info_bf16(int form, int sweeps, int window,
                                         int* info) {
  return leg_info(form, sweeps, window, true, info);
}

// The up-leg of cycle k and the down-leg of cycle k+1 in one pass.
// coeffs: 5 stencil values, the restriction's row and column taps, the
// prolongation's row and column taps.  om_ids: 1 + sweeps (1..6) indices:
// the coarse-grid-correction factor, the post-sweeps, the next pre-sweeps.
// cols 1: e ((n-1)/2, (m-1)/2) in, rc ((n-1)/2, (m-1)/2) out; replaces
// evostencils_tpu/ops/pallas/transfer.py upleg_downleg_col
// (_vleg_col_kernel).  cols 0: c_half ((n-1)/2, m) in, rr ((n-1)/2, m)
// out, the column taps not read; replaces upleg_downleg_fused
// (_vleg_kernel).  halo, window: as for es_presmooth_residual_restrict,
// for the pass of `sweeps` sweeps.
extern "C" int es_upleg_downleg(const float* u, const float* e,
                                const float* b, const float* omegas,
                                const int* om_ids, int sweeps,
                                const double* coeffs, float* u_out,
                                float* r_out, int cols, int halo, int window,
                                int n, int m, void* stream) {
  if (sweeps < 1 || sweeps > MAX_FUSED_SWEEPS || bad_shape(n, m))
    return cudaErrorInvalidValue;
  Leg p = make_leg(coeffs, om_ids, sweeps + 1, sweeps, n, m, true);
  void* args[] = {&u, &e, &b, &omegas, &u_out, &r_out, &p};
  return launch_col_leg(cols ? kPassCols : kPassRows, sweeps, halo, window,
                        n, m, args, stream);
}

// coeffs as for es_presmooth_residual_restrict.  Writes rc ((n-1)/2,
// (m-1)/2) = R (b - A u); replaces the TPU kernel
// evostencils_tpu/ops/pallas/transfer.py residual_rowrestrict (_rr_kernel)
// together with the column half that lower.py:1340 leaves to XLA.  halo,
// window: as for es_presmooth_residual_restrict, for the down-leg of no
// sweep.
extern "C" int es_residual_restrict(const float* u, const float* b,
                                    const double* coeffs, float* rc,
                                    int halo, int window, int n, int m,
                                    void* stream) {
  if (bad_shape(n, m)) return cudaErrorInvalidValue;
  Leg p = make_leg(coeffs, nullptr, 0, 0, n, m);
  const float* e = nullptr;
  const float* omegas = nullptr;
  float* u_out = nullptr;
  void* args[] = {&u, &e, &b, &omegas, &u_out, &rc, &p};
  return launch_col_leg(kDown, 0, halo, window, n, m, args, stream);
}

// coeffs as above (the stencil values are not read).  om_id: index of the
// coarse-grid-correction factor in omegas.  Writes u + omega * P(e);
// replaces evostencils_tpu/ops/pallas/transfer.py prolong_row_correct
// (_pc_kernel) together with the column half that lower.py:1373 leaves to
// XLA.  halo, window: as for es_prolong_correct_postsmooth, for the up-leg
// of no sweep.
extern "C" int es_prolong_correct(const float* u, const float* e,
                                  const float* omegas, int om_id,
                                  const double* coeffs, float* u_out,
                                  int halo, int window, int n, int m,
                                  void* stream) {
  if (bad_shape(n, m)) return cudaErrorInvalidValue;
  Leg p = make_leg(coeffs, &om_id, 1, 0, n, m);
  const float* b = nullptr;
  float* r_out = nullptr;
  void* args[] = {&u, &e, &b, &omegas, &u_out, &r_out, &p};
  return launch_col_leg(kUp, 0, halo, window, n, m, args, stream);
}
