// Fused 3D V(2,1) leg kernels for Hopper (sm_90a), float32.
//
// es_downleg_wavefront_3d replaces the TPU kernel
//   evostencils_tpu/ops/pallas/wavefront3d.py downleg_wavefront_3d
//   (_wavefront_kernel):
//   two damped red-black Gauss-Seidel sweeps of a constant 7-point
//   operator (omega_1 for the first, omega_2 for the second), then
//   r = b - A u and the separable 3-tap 2:1 restriction of r on all three
//   axes, writing (u_s (n0, n1, n2), rc ((n0-1)/2, (n1-1)/2, (n2-1)/2)).
// es_upleg_wavefront_3d replaces
//   evostencils_tpu/ops/pallas/wavefront3d.py upleg_wavefront_3d
//   (_upleg_kernel):
//   u += omega_c * P(e) with the separable 3-tap 1:2 prolongation of the
//   coarse correction e on all three axes, then one red-black sweep with
//   omega_s.
//
// What bounds them: device-memory bytes.  Each leg must read u and b once
// and write u once, plus the coarse array (rc written or e read); the
// arithmetic is a few dozen flops per point, far below the card's rate.
// So every intermediate half-sweep, the residual and the transfers stay on
// chip, and a leg costs one pass over u and b, plus the halo that
// neighbouring blocks read again (mostly from L2).
//
// Design: 2.5-D blocking with a pipeline whose stages are independent.
// Each block owns a T x T tile of the (axis-1, axis-2) plane and walks a
// chunk of axis 0 plane by plane.  At step s plane s arrives, and the
// down-leg's four half-sweeps run on planes s-1 (red, omega_1), s-3
// (black, omega_1), s-5 (red, omega_2) and s-7 (black, omega_2): a lag of
// LAG = 2 planes per stage.  With that lag the four stages of a step read
// and write disjoint cells and each reads exactly the values that the
// sequential sweeps give, so a step is one pass over the block's threads
// and one barrier (with a lag of one plane, stage 1 would read the black
// cells of plane s-2 that stage 2 writes in the same step).
// Each thread owns two neighbouring cells of the window, one of each
// colour, and keeps their axis-0 columns of u (planes s-9 .. s) in
// registers; only the in-plane neighbours come from shared memory, where
// every plane's window lives in a ring.  A cell that is red on plane s-1
// is red on s-5 and black on s-3 and s-7, so each step every thread
// updates one cell on the red stages' planes and the other on the black
// stages': no lane idles on the other colour (see "Colours" below).
// Planes s+1 and s+2 of u and b are in flight (cp.async, zero-filled
// outside the grid) while step s computes, so no load waits on the chain.
// The owner of a cell stores its final u (plane s-7) from its registers
// and forms the residual of plane s-8, which it adds into the
// restriction's axis-0 pass of the coarse planes it feeds; once a coarse
// plane's pass is complete, its axis-1 and axis-2 passes follow after the
// barrier.  The up-leg forms the axis-0 pass of the prolongation once per
// coarse window cell, a step before its fine plane arrives, so that a
// fine cell adds only the axis-1 and axis-2 passes.
//
// Halos.  A window cell sees zeros in place of its out-of-window
// neighbours; the error moves inward one cell per half-sweep, so stage k
// updates only the cells at a Chebyshev distance >= k from the window
// edge (their neighbours all lie in the window: no read is predicated).
// The residual is needed on the tile and one more row and column (the
// restriction reads fine index 2i+2 past the tile), so the down-leg's
// window reaches D_LO = 5 cells before the tile and D_HI = 6 after it.
// Axis 0 is cut into chunks so that enough blocks run; a chunk loads
// D_WARM = 5 planes before its first plane and after its last residual
// plane and treats the planes beyond as zero: the same rule along axis 0.
// The up-leg's prolongation is pointwise and its two half-sweeps need a
// halo and a warm-up of 2 (its window has 3 cells after the tile).
// Tiles and chunks start at even interior indices on every axis, so every
// coarse point's restriction window and every prolongation stencil lies
// in one block.  Interior index i is node
// i+1 on every axis, so red (even node sum) is an ODD interior-index sum
// in 3D (wavefront3d.py:98).  Cells outside the grid hold 0 and are never
// updated.  Relaxation factors are read from the device vector by index,
// so no launch waits on the host.  tests/test_torch_wavefront_tiles.py
// emulates this schedule in float64; ops/kernels/wavefront3d.py states its
// constants, and es_wavefront_3d_info reports them with the card's
// occupancy.  The pipeline's device helpers live in csrc/pipeline3d.cuh,
// which the standalone 3D red-black sweep (csrc/sweep3d.cu) and residual
// restriction (csrc/leg3d.cu) share.
//
// Per block: the down-leg keeps 11 u and 11 b planes of 43 x 43 and two
// axis-0 passes of 33 x 33 (171,512 bytes; 925 threads, one block an SM);
// the up-leg 6 u and 6 b planes of 37 x 37 (one more cell after the tile
// than its sweeps need, so that the rows are odd), 4 coarse planes and two
// axis-0 passes of 20 x 20 (75,360 bytes; 685 threads, one block an SM:
// at two, the 40 registers a thread could have would spill).

#include <cuda_runtime.h>

#include "pipeline3d.cuh"

namespace {

constexpr int T = 32;                    // in-plane tile edge (axes 1, 2)
constexpr int MIN_CHUNK = 8;             // fewest axis-0 planes a block walks

// down-leg
constexpr int D_LO = 5, D_HI = 6;        // window cells before / after tile
constexpr int D_WARM = 5;                // planes loaded past a chunk's ends
constexpr int DW = T + D_LO + D_HI;      // window edge (odd)
constexpr int D_CELLS = DW * DW;
constexpr int D_HALF = (D_CELLS + 1) / 2;  // even cells; the odd ones follow
constexpr int D_PS = 2 * D_HALF;         // plane stride
constexpr int D_RING = 4 * LAG + 1 + AHEAD;  // u, b planes s-8 .. s+AHEAD
constexpr int D_COL = 4 * LAG + 3;       // column registers (see the loop)
constexpr int RW = T + 1;                // residual region edge
constexpr int R_PS = RW * RW;            // a coarse plane's axis-0 pass
constexpr int CT = T / 2;                // coarse tile edge
constexpr int DOWN_THREADS = D_HALF, DOWN_BLOCKS_PER_SM = 1;
constexpr int DOWN_SMEM = (2 * D_RING * D_PS + 2 * R_PS) * sizeof(float);

// up-leg
constexpr int U_LO = 2, U_HI = 3;        // window cells before / after tile
constexpr int U_WARM = 2;
constexpr int UW = T + U_LO + U_HI;      // window edge (odd)
constexpr int U_CELLS = UW * UW;
constexpr int U_HALF = (U_CELLS + 1) / 2;
constexpr int U_PS = 2 * U_HALF;
constexpr int U_RING = 2 * LAG + AHEAD;  // u, b planes s-3 .. s+AHEAD
constexpr int U_COL = 2 * LAG + 2;       // column registers (see the loop)
constexpr int CW = (UW + 1) / 2 + 1;     // coarse window edge
constexpr int C_PS = CW * CW;
constexpr int UP_THREADS = U_HALF, UP_BLOCKS_PER_SM = 1;
constexpr int C_RING = 4;                // coarse planes, slot c & 3
constexpr int UP_SMEM =
    (2 * U_RING * U_PS + (C_RING + 2) * C_PS) * sizeof(float);

// Colours.  A window's first cell has an even grid-index sum (y0 + x0 is
// even) and its rows are odd, so cell w of the window is red on plane P
// exactly when P + w is odd.  Each thread owns the cells 2t and 2t+1, one
// of each colour, and a plane's window is stored split: the even cells,
// then the odd ones.  At a step every thread updates its red cell on the
// red stages' planes and its black cell on the black stages', and a
// warp's lanes read consecutive addresses of one half (no bank conflict).
static_assert(DW % 2 == 1 && UW % 2 == 1, "odd window rows");
static_assert(T % 2 == 0 && U_LO % 2 == 0,
              "tiles and the up-leg's window start at even indices");
static_assert(D_WARM % 2 == 1 && U_WARM % 2 == 0,
              "a down-leg chunk starts at an odd step, an up-leg's at even");
static_assert(C_PS <= UP_THREADS, "one thread a coarse window cell");
static_assert(CT * CT <= DOWN_THREADS, "one thread a coarse tile point");

struct Leg3 {
  // 7-point stencil: center, then the neighbours -x, +x, -y, +y, -z, +z
  // (x = axis 0, y = axis 1, z = axis 2)
  float c, cxm, cxp, cym, cyp, czm, czp;
  // 1/c and the neighbour coefficients scaled by it (premultiplied form,
  // wavefront3d.py:75-76)
  float dinv, dxm, dxp, dym, dyp, dzm, dzp;
  float t0[3], t1[3], t2[3];    // transfer taps per axis
  int om0, om1;                 // indices into the relaxation-factor vector
  int n0, n1, n2;
  int chunk;                    // axis-0 planes per block (even)
};

__global__ void __launch_bounds__(DOWN_THREADS, DOWN_BLOCKS_PER_SM)
downleg3d_kernel(const float* __restrict__ u, const float* __restrict__ b,
                 const float* __restrict__ omegas, float* __restrict__ u_out,
                 float* __restrict__ rc, Leg3 p) {
  extern __shared__ float smem[];
  float* su = smem;                          // D_RING u planes
  float* sb = su + D_RING * D_PS;            // D_RING b planes
  float* sa = sb + D_RING * D_PS;            // 2 axis-0 passes, slot c & 1
  const int t = threadIdx.x;
  const int y0 = blockIdx.y * T - D_LO, x0 = blockIdx.x * T - D_LO;
  const int z0 = blockIdx.z * p.chunk;
  const int z1 = min(z0 + p.chunk, p.n0);    // planes [z0, z1) are stored
  const int qmax = min(z0 + p.chunk, p.n0 - 1);  // last residual plane
  const int L0 = z0 - D_WARM, last = qmax + 4 * LAG + 1;
  // planes [pa, pb] are loaded and updated; the others read as zero
  const int pa = max(L0, 0), pb = min(qmax + D_WARM, p.n0 - 1);
  const int nc1 = (p.n1 - 1) / 2, nc2 = (p.n2 - 1) / 2;
  const long plane = static_cast<long>(p.n1) * p.n2;
  const float om1 = omegas[p.om0], om2 = omegas[p.om1];
  const Cell ce = make_cell<DW, D_LO, T, true>(2 * t, y0, x0, 0, 0, p);
  const Cell co = make_cell<DW, D_LO, T, true>(2 * t + 1, y0, x0, 0, 0, p);
  // u's axis-0 column of each cell; at the first step of a pair (B = 0)
  // col[9 - k] holds plane s-k, at the second (B = 1) col[10 - k]
  float cole[D_COL], colo[D_COL];
#pragma unroll
  for (int j = 0; j < D_COL; ++j) cole[j] = colo[j] = 0.f;
  // planes L0 .. L0 + AHEAD - 1 in flight before the first step
#pragma unroll
  for (int a = 0; a < AHEAD; ++a)
    fetch_plane<D_HALF>(ce, co, u, b, su + a * D_PS, sb + a * D_PS, L0 + a,
                        pa, pb, plane);
  copy_wait<AHEAD - 1>();
  __syncthreads();

  int slot = 0;                              // ring slot of plane s
  // step s; SE: s is even; col[B + 9 - k] holds plane s-k
  auto step = [&](auto se_, auto b_, int s) {
    constexpr bool SE = decltype(se_)::value;
    constexpr int B = decltype(b_)::value;
    {
      const int o = slot_back<D_RING>(slot, -AHEAD) * D_PS;
      fetch_plane<D_HALF>(ce, co, u, b, su + o, sb + o, s + AHEAD, pa, pb,
                          plane);
    }
    const int o0 = slot * D_PS, o1 = slot_back<D_RING>(slot, 1) * D_PS,
              o3 = slot_back<D_RING>(slot, 3) * D_PS,
              o5 = slot_back<D_RING>(slot, 5) * D_PS,
              o7 = slot_back<D_RING>(slot, 7) * D_PS,
              o8 = slot_back<D_RING>(slot, 8) * D_PS;
    auto active = [&](int pl) { return pl >= pa && pl <= pb; };
    // plane s has arrived
    if (ce.grid()) cole[B + 9] = su[o0 + t];
    if (co.grid()) colo[B + 9] = su[o0 + D_HALF + t];
    // X takes the red stages (planes s-1, s-5; red cells have P + w odd),
    // Y the black ones (s-3, s-7)
    const Cell& X = pick<SE>(ce, co);
    const Cell& Y = pick<SE>(co, ce);
    auto& cx = pick<SE>(cole, colo);
    auto& cy = pick<SE>(colo, cole);
    const int ix = SE ? t : D_HALF + t, iy = SE ? D_HALF + t : t;
    const bool x1 = X.grid() && active(s - 1) && X.dist() >= 1;
    const bool x5 = X.grid() && active(s - 5) && X.dist() >= 3;
    const bool y3 = Y.grid() && active(s - 3) && Y.dist() >= 2;
    const bool y7 = Y.grid() && active(s - 7) && Y.dist() >= 4;
    // the four half-sweeps touch four planes: each cell's reads first
    Around n1{}, n5{}, n3{}, n7{};
    if (x1) n1 = around<SE, DW, D_HALF>(su + o1, sb + o1, t);
    if (x5) n5 = around<SE, DW, D_HALF>(su + o5, sb + o5, t);
    if (x1) {
      cx[B + 8] = relax(cx[B + 7], cx[B + 8], cx[B + 9], n1, om1, p);
      su[o1 + ix] = cx[B + 8];
    }
    if (x5) {
      cx[B + 4] = relax(cx[B + 3], cx[B + 4], cx[B + 5], n5, om2, p);
      su[o5 + ix] = cx[B + 4];
    }
    if (y3) n3 = around<!SE, DW, D_HALF>(su + o3, sb + o3, t);
    if (y7) n7 = around<!SE, DW, D_HALF>(su + o7, sb + o7, t);
    if (y3) {
      cy[B + 6] = relax(cy[B + 5], cy[B + 6], cy[B + 7], n3, om1, p);
      su[o3 + iy] = cy[B + 6];
    }
    if (y7) {
      cy[B + 2] = relax(cy[B + 1], cy[B + 2], cy[B + 3], n7, om2, p);
      su[o7 + iy] = cy[B + 2];
    }
    // plane s-7 is final in both cells
    if (s - 7 >= z0 && s - 7 < z1) {
      float* out = u_out + (s - 7) * plane;
      if (ce.tile()) out[ce.g] = cole[B + 2];
      if (co.tile()) out[co.g] = colo[B + 2];
    }
    // residual of plane q = s-8 on the tile and one more row and column,
    // summed into the restriction's axis-0 pass: per fine cell, coarse
    // plane c is (t0[0] r(2c) + t0[1] r(2c+1)) + t0[2] r(2c+2)
    // (wavefront3d.py:164-197); q and s have one parity
    const int q = s - 8;
    if (q >= z0 && q <= qmax) {
      auto res = [&](const float* c, const Around& n) {
        return residual(c[B + 0], c[B + 1], c[B + 2], n, p);
      };
      float* acur = sa + ((SE ? q / 2 - 1 : (q - 1) / 2) & 1) * R_PS;
      float* anew = sa + ((q / 2) & 1) * R_PS;
      const bool fin = q >= z0 + 2, start = q <= qmax - 2;
      auto add = [&](const Cell& c, float r) {
        if constexpr (SE) {
          if (fin) acur[c.aux] += p.t0[2] * r;
          if (start) anew[c.aux] = p.t0[0] * r;
        } else {
          acur[c.aux] += p.t0[1] * r;
        }
      };
      if (ce.tile1())
        add(ce, res(cole, around<true, DW, D_HALF>(su + o8, sb + o8, t)));
      if (co.tile1())
        add(co,
            res(colo, around<false, DW, D_HALF>(su + o8, sb + o8, t)));
    }
    // coarse plane c = qr/2 - 1 was finished at the last step (qr = 2c+2):
    // its axis-1 pass, then its axis-2 pass
    if constexpr (!SE) {
      const int qr = q - 1;
      constexpr int first = DOWN_THREADS - CT * CT;
      if (qr >= z0 + 2 && qr <= qmax && t >= first) {
        const int idx = t - first;
        const int i = idx / CT, j = idx - i * CT;
        const int ci = blockIdx.y * CT + i, cj = blockIdx.x * CT + j;
        if (ci < nc1 && cj < nc2) {
          const float* a0 = sa + ((qr / 2 - 1) & 1) * R_PS;
          float acc = 0.f;
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            float rows = 0.f;
#pragma unroll
            for (int a = 0; a < 3; ++a)
              rows += p.t1[a] * a0[(2 * i + a) * RW + 2 * j + d];
            acc += p.t2[d] * rows;
          }
          rc[(static_cast<long>(qr / 2 - 1) * nc1 + ci) * nc2 + cj] = acc;
        }
      }
    }
    // plane s+1 is in; plane s+AHEAD may still be in flight
    copy_wait<AHEAD - 1>();
    __syncthreads();
    slot = next_slot<D_RING>(slot);
  };
  // L0 is odd: steps come in pairs (odd, even)
  for (int s = L0;; s += 2) {
    step(Bool<false>{}, Int<0>{}, s);
    if (s + 1 > last) break;
    step(Bool<true>{}, Int<1>{}, s + 1);
    if (s + 2 > last) break;
    shift2(cole);
    shift2(colo);
  }
  copy_wait<0>();
}

// Prolongation along one axis: fine interior index g reads coarse index
// c = floor((g-1)/2) with weight t[1] when g is odd, t[2] when even, and
// when even also c+1 with weight t[0] (transfer.py:896-903).
struct Taps {
  int c;
  float w0, w1;
  bool two;
};

__device__ __forceinline__ Taps taps_of(int g, const float* t) {
  Taps k;
  k.two = !(g & 1);
  k.c = (g - 1) >> 1;
  k.w0 = k.two ? t[2] : t[1];
  k.w1 = t[0];
  return k;
}

__global__ void __launch_bounds__(UP_THREADS, UP_BLOCKS_PER_SM)
upleg3d_kernel(const float* __restrict__ u, const float* __restrict__ e,
               const float* __restrict__ b, const float* __restrict__ omegas,
               float* __restrict__ u_out, Leg3 p) {
  extern __shared__ float smem[];
  float* su = smem;                          // U_RING u planes
  float* sb = su + U_RING * U_PS;            // U_RING b planes
  float* se = sb + U_RING * U_PS;            // C_RING coarse planes
  float* si = se + C_RING * C_PS;            // 2 axis-0 passes, slot F & 1
  const int t = threadIdx.x;
  const int y0 = blockIdx.y * T - U_LO, x0 = blockIdx.x * T - U_LO;
  // y0 and x0 are even: coarse index y0/2 - 1 feeds the window's first
  // (even) fine index through its t[2] tap
  const int cy0 = y0 / 2 - 1, cx0 = x0 / 2 - 1;
  const int z0 = blockIdx.z * p.chunk;
  const int z1 = min(z0 + p.chunk, p.n0);
  const int L0 = z0 - U_WARM, last = z1 - 1 + 2 * LAG - 1;
  const int pa = max(L0, 0), pb = min(z1 - 1 + U_WARM, p.n0 - 1);
  const long plane = static_cast<long>(p.n1) * p.n2;
  const float om_c = omegas[p.om0], om_s = omegas[p.om1];
  const Cell ce = make_cell<UW, U_LO, T, false>(2 * t, y0, x0, cy0, cx0, p);
  const Cell co = make_cell<UW, U_LO, T, false>(2 * t + 1, y0, x0, cy0, cx0, p);

  // start the copy of this thread's cell of coarse plane c of e's window
  // into slot c & 3, zero outside e; it joins the next fine plane's group
  auto fetch_coarse = [&](int c) {
    if (t >= C_PS) return;
    const int nc0 = (p.n0 - 1) / 2, nc1 = (p.n1 - 1) / 2,
              nc2 = (p.n2 - 1) / 2;
    const int i = t / CW, j = t - i * CW;
    const int ci = cy0 + i, cj = cx0 + j;
    const bool in = c >= 0 && c < nc0 && ci >= 0 && ci < nc1 && cj >= 0 &&
                    cj < nc2;
    const long g = in ? (static_cast<long>(c) * nc1 + ci) * nc2 + cj : 0;
    copy_async(se + (c & (C_RING - 1)) * C_PS + t, e + g, in);
  };
  // the axis-0 pass of the prolongation for fine plane F over e's window
  // (this thread's cell): the prolongation's first pass, which the
  // fine cells' axis-1 and axis-2 passes read
  auto inner = [&](int F) {
    if (t >= C_PS) return;
    const Taps k = taps_of(F, p.t0);
    float acc = 0.f;
    acc += k.w0 * se[(k.c & (C_RING - 1)) * C_PS + t];
    if (k.two) acc += k.w1 * se[((k.c + 1) & (C_RING - 1)) * C_PS + t];
    si[(F & 1) * C_PS + t] = acc;
  };

  // u's axis-0 column of each cell; at the first step of a pair (B = 0)
  // col[4 - k] holds plane s-k, at the second (B = 1) col[5 - k]
  float cole[U_COL], colo[U_COL];
#pragma unroll
  for (int j = 0; j < U_COL; ++j) cole[j] = colo[j] = 0.f;
  // fine plane F reads coarse planes F/2 - 1 and F/2 (F even) or (F-1)/2
  // (F odd); coarse plane c travels with fine plane 2c - 1, and the axis-0
  // pass of plane F is formed a step before F arrives.  L0 is even.
  fetch_coarse(L0 / 2 - 1);
  fetch_coarse(L0 / 2);
#pragma unroll
  for (int a = 0; a < AHEAD; ++a) {
    if ((L0 + a) & 1) fetch_coarse((L0 + a + 1) / 2);
    fetch_plane<U_HALF>(ce, co, u, b, su + a * U_PS, sb + a * U_PS, L0 + a,
                        pa, pb, plane);
  }
  copy_wait<AHEAD - 1>();
  __syncthreads();
  inner(L0);
  __syncthreads();

  int slot = 0;                              // ring slot of plane s
  auto step = [&](auto se_, auto b_, int s) {
    constexpr bool SE = decltype(se_)::value;
    constexpr int B = decltype(b_)::value;
    {
      const int o = slot_back<U_RING>(slot, -AHEAD) * U_PS;
      if ((s + AHEAD) & 1) fetch_coarse((s + AHEAD + 1) / 2);
      fetch_plane<U_HALF>(ce, co, u, b, su + o, sb + o, s + AHEAD, pa, pb,
                          plane);
    }
    const int o0 = slot * U_PS, o1 = slot_back<U_RING>(slot, 1) * U_PS,
              o3 = slot_back<U_RING>(slot, 3) * U_PS;
    auto active = [&](int pl) { return pl >= pa && pl <= pb; };
    // X takes the red stage (plane s-1), Y the black one (s-3)
    const Cell& X = pick<SE>(ce, co);
    const Cell& Y = pick<SE>(co, ce);
    auto& cx = pick<SE>(cole, colo);
    auto& cy = pick<SE>(colo, cole);
    const int ix = SE ? t : U_HALF + t, iy = SE ? U_HALF + t : t;
    const bool x1 = X.grid() && active(s - 1) && X.dist() >= 1;
    const bool y3 = Y.grid() && active(s - 3) && Y.dist() >= 2;
    Around n1{}, n3{};
    if (x1) n1 = around<SE, UW, U_HALF>(su + o1, sb + o1, t);
    if (y3) n3 = around<!SE, UW, U_HALF>(su + o3, sb + o3, t);
    // plane s has arrived: add omega_c * P(e), its axis-1 pass, then its
    // axis-2 pass over the axis-0 pass formed at the last step
    // (wavefront3d.py:321-343)
    const bool a0 = active(s);
    const float* pi = si + (s & 1) * C_PS;
    auto correct = [&](const Cell& c, int i, float* col) {
      float v = su[o0 + i];
      if (a0 && c.grid()) {
        const bool ty2 = c.even_y(), tx2 = c.even_x();
        const float wy0 = ty2 ? p.t1[2] : p.t1[1];
        const float wx0 = tx2 ? p.t2[2] : p.t2[1];
        const int m = c.aux;
        auto mid = [&](int k) {
          float acc = 0.f;
          acc += wy0 * pi[k];
          if (ty2) acc += p.t1[0] * pi[k + CW];
          return acc;
        };
        float corr = 0.f;
        corr += wx0 * mid(m);
        if (tx2) corr += p.t2[0] * mid(m + 1);
        v += om_c * corr;
        su[o0 + i] = v;
      }
      col[B + 4] = v;
    };
    correct(ce, t, cole);
    if (co.own()) correct(co, U_HALF + t, colo);
    // red on s-1 (distance >= 1) or black on s-3 (>= 2); either is the
    // cell's last update on that plane
    if (x1) {
      cx[B + 3] = relax(cx[B + 2], cx[B + 3], cx[B + 4], n1, om_s, p);
      su[o1 + ix] = cx[B + 3];
      if (X.tile() && s - 1 >= z0 && s - 1 < z1)
        u_out[(s - 1) * plane + X.g] = cx[B + 3];
    }
    if (y3) {
      cy[B + 1] = relax(cy[B + 0], cy[B + 1], cy[B + 2], n3, om_s, p);
      su[o3 + iy] = cy[B + 1];
      if (Y.tile() && s - 3 >= z0 && s - 3 < z1)
        u_out[(s - 3) * plane + Y.g] = cy[B + 1];
    }
    // the axis-0 pass of plane s+1: its coarse planes are in
    inner(s + 1);
    copy_wait<AHEAD - 1>();
    __syncthreads();
    slot = next_slot<U_RING>(slot);
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

Leg3 make_leg(const double* coeffs, const int* om_ids, int n0, int n1,
              int n2) {
  Leg3 p;
  const double c = coeffs[0], dinv = 1.0 / c;
  p.c = static_cast<float>(c);
  p.cxm = static_cast<float>(coeffs[1]);
  p.cxp = static_cast<float>(coeffs[2]);
  p.cym = static_cast<float>(coeffs[3]);
  p.cyp = static_cast<float>(coeffs[4]);
  p.czm = static_cast<float>(coeffs[5]);
  p.czp = static_cast<float>(coeffs[6]);
  p.dinv = static_cast<float>(dinv);
  p.dxm = static_cast<float>(coeffs[1] * dinv);
  p.dxp = static_cast<float>(coeffs[2] * dinv);
  p.dym = static_cast<float>(coeffs[3] * dinv);
  p.dyp = static_cast<float>(coeffs[4] * dinv);
  p.dzm = static_cast<float>(coeffs[5] * dinv);
  p.dzp = static_cast<float>(coeffs[6] * dinv);
  for (int k = 0; k < 3; ++k) {
    p.t0[k] = static_cast<float>(coeffs[7 + k]);
    p.t1[k] = static_cast<float>(coeffs[10 + k]);
    p.t2[k] = static_cast<float>(coeffs[13 + k]);
  }
  p.om0 = om_ids[0];
  p.om1 = om_ids[1];
  p.n0 = n0;
  p.n1 = n1;
  p.n2 = n2;
  return p;
}

bool bad_shape(int n0, int n1, int n2) {
  return n0 < 3 || n1 < 3 || n2 < 3 || !(n0 & 1) || !(n1 & 1) || !(n2 & 1);
}

}  // namespace

// coeffs: 7 stencil values (center, -x, +x, -y, +y, -z, +z), then 3 taps
// for each of axes 0, 1, 2.  om_ids: the two sweeps' indices into omegas,
// in the order they run.  Returns the launch's cudaError_t.
extern "C" int es_downleg_wavefront_3d(const float* u, const float* b,
                                       const float* omegas, const int* om_ids,
                                       const double* coeffs, float* u_out,
                                       float* rc, int n0, int n1, int n2,
                                       void* stream) {
  if (bad_shape(n0, n1, n2)) return cudaErrorInvalidValue;
  static bool opted[MAX_DEVICES];
  cudaError_t err = opt_in_smem(downleg3d_kernel, DOWN_SMEM, opted);
  if (err != cudaSuccess) return err;
  Leg3 p = make_leg(coeffs, om_ids, n0, n1, n2);
  const dim3 grid = pipeline_blocks(n0, n1, n2, T, DOWN_BLOCKS_PER_SM,
                                    MIN_CHUNK, &p.chunk, &err);
  if (err != cudaSuccess) return err;
  downleg3d_kernel<<<grid, DOWN_THREADS, DOWN_SMEM,
                     static_cast<cudaStream_t>(stream)>>>(u, b, omegas, u_out,
                                                          rc, p);
  return cudaGetLastError();
}

// om_ids: the coarse-grid-correction factor's index, then the post-sweep's.
extern "C" int es_upleg_wavefront_3d(const float* u, const float* e,
                                     const float* b, const float* omegas,
                                     const int* om_ids, const double* coeffs,
                                     float* u_out, int n0, int n1, int n2,
                                     void* stream) {
  if (bad_shape(n0, n1, n2)) return cudaErrorInvalidValue;
  static bool opted[MAX_DEVICES];
  cudaError_t err = opt_in_smem(upleg3d_kernel, UP_SMEM, opted);
  if (err != cudaSuccess) return err;
  Leg3 p = make_leg(coeffs, om_ids, n0, n1, n2);
  const dim3 grid = pipeline_blocks(n0, n1, n2, T, UP_BLOCKS_PER_SM,
                                    MIN_CHUNK, &p.chunk, &err);
  if (err != cudaSuccess) return err;
  upleg3d_kernel<<<grid, UP_THREADS, UP_SMEM,
                   static_cast<cudaStream_t>(stream)>>>(u, e, b, omegas,
                                                        u_out, p);
  return cudaGetLastError();
}

// What the card makes of a leg (down != 0: the down-leg): the 11 values of
// pipeline_info (csrc/pipeline3d.cuh).
extern "C" int es_wavefront_3d_info(int down, int* info) {
  if (down)
    return pipeline_info(reinterpret_cast<const void*>(downleg3d_kernel), T,
                         D_LO, D_HI, D_WARM, MIN_CHUNK, DOWN_THREADS,
                         DOWN_SMEM, info);
  return pipeline_info(reinterpret_cast<const void*>(upleg3d_kernel), T,
                       U_LO, U_HI, U_WARM, MIN_CHUNK, UP_THREADS, UP_SMEM,
                       info);
}
