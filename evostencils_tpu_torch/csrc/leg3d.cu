// Standalone 3D transfer kernels for Hopper (sm_90a), float32.
//
// es_residual_restrict_3d replaces the TPU kernel
//   evostencils_tpu/ops/pallas/leg3d.py residual_restrict_3d
//   (_rr3d_kernel): r = b - A u of a constant 7-point operator, summed
//   c*u + cxm*xm + cxp*xp + cym*ym + cyp*yp + czm*zm + czp*zp left to right
//   (leg3d.py:125-131), then the separable 3-tap 2:1 restriction of r on
//   axis 0, then axis 1, then axis 2 (leg3d.py:237-260), writing
//   rc ((n0-1)/2, (n1-1)/2, (n2-1)/2).
// es_prolong_correct_3d replaces
//   evostencils_tpu/ops/pallas/leg3d.py prolong_correct_3d (_pc3d_kernel):
//   u + omega * P(e), the separable 3-tap 1:2 interpolation of the coarse
//   correction e on axis 0, then axis 1, then axis 2 (leg3d.py:313-340).
// The TPU kernels do axis 2 on the matrix unit (restrict_lane_matrix,
// prolong_lane_matrices), a layout device that has no counterpart here.
//
// What bounds them: device-memory bytes.  The restriction must read u and b
// once and write rc once; the prolongation must read u and e once and write
// u once: 2 fine arrays and 1 coarse array each, 140,844,532 bytes at
// 255^3, 0.0420 ms at 3.35 TB/s.  Each does about a dozen flops a point.
//
// es_residual_restrict_3d: the tail of the 3D down-leg in
// csrc/wavefront3d.cu with no sweep (the plane pipeline of
// csrc/pipeline3d.cuh).  Each block owns a 32 x 32 tile of fine points in
// the (axis-1, axis-2) plane, i.e. a 16 x 16 tile of coarse points, and
// walks a chunk of axis 0: at step s plane s arrives and the owners form
// the residual of plane s-1 from their cells' axis-0 columns of u, kept in
// registers, and the in-plane neighbours in shared memory.  They add it
// into the restriction's axis-0 pass of the coarse plane(s) that the fine
// plane feeds; once a coarse plane's pass is complete, its axis-1 and
// axis-2 passes follow the step's barrier.  Planes s+1 and s+2 of u and b
// are in flight (cp.async, zero-filled outside the grid) while step s
// computes, and a step takes one barrier.  Each thread owns two cells of
// a window split by parity; no cell pays a divide.  Tiles and chunks start
// at even interior indices, so every coarse point's restriction window
// lies in one block; the residual is needed on the tile and one more row
// and column (fine index 2i+2 past the tile), so the window reaches 1
// cell before the tile and 2 after it (35 x 35), and a chunk loads one
// plane past each end.  Shared memory: 4 u and 4 b planes and two axis-0
// passes of 33 x 33, 47,944 bytes; 613 threads, 2 blocks an SM.
// es_prolong_correct_3d: the 3D up-leg's prolongation with no sweep, on
// the same plane pipeline.  Each block owns a 32 x 32 tile of fine points
// in the (axis-1, axis-2) plane, starting at even indices, and walks a
// chunk of axis 0; the prolongation is pointwise, so the window is the
// tile itself and u is read once and u_out written once a point.  e's
// coarse window, 17 x 17 cells from coarse index y0/2 - 1 on, is staged by
// cp.async a coarse plane at a time into a ring of 4, each coarse plane
// travelling with fine plane 2c - 1, so a coarse plane leaves device memory
// once per chunk.  At step s fine plane s is corrected: its cells read the
// prolongation's axis-0 pass, formed once per coarse window cell at the
// step before into a double buffer, and add the axis-1 and then the axis-2
// pass (at most 4 shared reads, the parity from the cell, no loop), then
// store u + omega * corr; u's plane s arrived by cp.async AHEAD planes
// early, so the store never waits on a load.  One barrier a step.  Each
// thread owns PC_CELLS / PC_THREADS cells of one column, whose rows share a
// parity; the cells a warp touches are consecutive in a row.  Shared
// memory: 3 u planes of 32 x 32, 4 coarse planes and two axis-0 passes of
// 17 x 17, 19,224 bytes; 512 threads, 3 blocks an SM, chunks for a wave of
// 2 (on an H100 this beat 16-tiles, 128, 256 and 1024 threads, waves of 3
// and 4 and 4 planes in flight at 255^3, 127^3 and 63^3; PERF.md).
// es_prolong_correct_3d_info and es_residual_restrict_3d_info report the
// schedules with the card's occupancy; ops/kernels/leg3d.py states their
// constants, and tests/test_torch_wavefront_tiles.py emulates them in
// float64.
// Coarse point c of an axis sits at fine index 2c+1 on it.  Cells outside
// the grid hold 0.  The relaxation factor is read from the device vector
// by index, so no launch waits on the host.

#include <cuda_runtime.h>

#include "pipeline3d.cuh"

namespace {

constexpr int RR_T = 32;                   // fine tile edge (axes 1, 2)
constexpr int RR_LO = 1, RR_HI = 2;        // window cells before / after
constexpr int RR_WARM = 1;                 // planes loaded past each end
constexpr int RR_W = RR_T + RR_LO + RR_HI;   // window edge (odd)
constexpr int RR_HALF = (RR_W * RR_W + 1) / 2;  // even cells; the odd follow
constexpr int RR_PS = 2 * RR_HALF;         // plane stride
constexpr int RR_RING = 2 + AHEAD;         // u, b planes s-1 .. s+AHEAD
constexpr int RR_COL = 4;                  // column registers (the loop)
constexpr int RW = RR_T + 1;               // residual region edge
constexpr int R_PS = RW * RW;              // a coarse plane's axis-0 pass
constexpr int CT = RR_T / 2;               // coarse tile edge
// chunks of 2 planes at 63^3, where the 4 tiles would leave SMs idle
constexpr int RR_MIN_CHUNK = 2;            // fewest planes a chunk holds
constexpr int RR_THREADS = RR_HALF, RR_BLOCKS_PER_SM = 2;
constexpr int RR_SMEM = (2 * RR_RING * RR_PS + 2 * R_PS) * sizeof(float);

// prolongation-correction
constexpr int PC_T = 32;                   // fine tile edge (axes 1, 2)
constexpr int PC_THREADS = 512;
constexpr int PC_BLOCKS_PER_SM = 3;        // resident (38 registers)
// chunks fill a wave of 2 blocks an SM: at 127^3 chunks of 8 planes beat
// the 6 of a wave of 3 on an H100
constexpr int PC_WAVE = 2;
constexpr int PC_AHEAD = 2;                // u planes in flight past s
constexpr int PC_MIN_CHUNK = 2;            // fewest planes a chunk holds
constexpr int PC_CELLS = PC_T * PC_T;
constexpr int PC_RING = PC_AHEAD + 1;      // u planes s .. s+AHEAD
constexpr int PC_CW = PC_T / 2 + 1;        // coarse window edge
constexpr int PC_CS = PC_CW * PC_CW;       // a coarse window plane
constexpr int PC_CRING = 4;                // coarse planes, slot c & 3
constexpr int PC_SMEM =
    (PC_RING * PC_CELLS + (PC_CRING + 2) * PC_CS) * sizeof(float);

static_assert(RR_W % 2 == 1, "odd window rows");
static_assert(RR_T % 2 == 0 && RR_WARM % 2 == 1,
              "tiles and chunks start at even indices, walks at odd steps");
static_assert(CT * CT <= RR_THREADS, "one thread a coarse tile point");
static_assert(PC_T % 2 == 0 && (PC_T & (PC_T - 1)) == 0 &&
                  PC_CELLS % PC_THREADS == 0 &&
                  (PC_THREADS / PC_T) % 2 == 0,
              "even tile starts; a thread's cells one column, one parity");
static_assert(PC_CS <= PC_THREADS, "one thread a coarse window cell");
static_assert(PC_SMEM <= 48 * 1024, "no shared-memory opt-in");
// coarse plane c + 4 is fetched at step 2c + 7 - AHEAD, after the last
// read of plane c (step 2c + 1)
static_assert(2 * PC_CRING > PC_AHEAD + 2, "the coarse ring holds");

struct Transfer3 {
  // 7-point stencil: center, then the neighbours -x, +x, -y, +y, -z, +z
  // (x = axis 0, y = axis 1, z = axis 2)
  float c, cxm, cxp, cym, cyp, czm, czp;
  float t0[3], t1[3], t2[3];    // transfer taps per axis
  int om;                       // index into the relaxation-factor vector
  int n0, n1, n2;
  int chunk;                    // fine planes per block (even)
};

__global__ void __launch_bounds__(RR_THREADS, RR_BLOCKS_PER_SM)
residual_restrict3d_kernel(const float* __restrict__ u,
                           const float* __restrict__ b,
                           float* __restrict__ rc, Transfer3 p) {
  extern __shared__ float smem[];
  float* su = smem;                          // RR_RING u planes
  float* sb = su + RR_RING * RR_PS;          // RR_RING b planes
  float* sa = sb + RR_RING * RR_PS;          // 2 axis-0 passes, slot c & 1
  const int t = threadIdx.x;
  const int y0 = blockIdx.y * RR_T - RR_LO, x0 = blockIdx.x * RR_T - RR_LO;
  const int z0 = blockIdx.z * p.chunk;
  const int qmax = min(z0 + p.chunk, p.n0 - 1);  // last residual plane
  // residual planes [z0, qmax] feed coarse planes [z0/2, qmax/2 - 1]; the
  // last one's axis-1 and axis-2 passes run at step qmax + 2
  const int L0 = z0 - RR_WARM, last = qmax + 2;
  // planes [pa, pb] are loaded; the others read as zero
  const int pa = max(L0, 0), pb = min(qmax + RR_WARM, p.n0 - 1);
  const int nc1 = (p.n1 - 1) / 2, nc2 = (p.n2 - 1) / 2;
  const long plane = static_cast<long>(p.n1) * p.n2;
  const Cell ce = make_cell<RR_W, RR_LO, RR_T, true>(2 * t, y0, x0, 0, 0, p);
  const Cell co =
      make_cell<RR_W, RR_LO, RR_T, true>(2 * t + 1, y0, x0, 0, 0, p);
  // u's axis-0 column of each cell; at the first step of a pair (B = 0)
  // col[2 - k] holds plane s-k, at the second (B = 1) col[3 - k]
  float cole[RR_COL], colo[RR_COL];
#pragma unroll
  for (int j = 0; j < RR_COL; ++j) cole[j] = colo[j] = 0.f;
  // planes L0 .. L0 + AHEAD - 1 in flight before the first step
#pragma unroll
  for (int a = 0; a < AHEAD; ++a)
    fetch_plane<RR_HALF>(ce, co, u, b, su + a * RR_PS, sb + a * RR_PS,
                         L0 + a, pa, pb, plane);
  copy_wait<AHEAD - 1>();
  __syncthreads();

  int slot = 0;                              // ring slot of plane s
  // step s; QE: the residual's plane q = s-1 is even; col[B + 2 - k] holds
  // plane s-k
  auto step = [&](auto qe_, auto b_, int s) {
    constexpr bool QE = decltype(qe_)::value;
    constexpr int B = decltype(b_)::value;
    {
      const int o = slot_back<RR_RING>(slot, -AHEAD) * RR_PS;
      fetch_plane<RR_HALF>(ce, co, u, b, su + o, sb + o, s + AHEAD, pa, pb,
                           plane);
    }
    const int o0 = slot * RR_PS, o1 = slot_back<RR_RING>(slot, 1) * RR_PS;
    // plane s has arrived
    cole[B + 2] = su[o0 + t];
    if (co.own()) colo[B + 2] = su[o0 + RR_HALF + t];
    // residual of plane q = s-1 on the tile and one more row and column,
    // summed into the restriction's axis-0 pass: per fine cell, coarse
    // plane c is (t0[0] r(2c) + t0[1] r(2c+1)) + t0[2] r(2c+2)
    // (leg3d.py:237-260)
    const int q = s - 1;
    if (q >= z0 && q <= qmax) {
      float* acur = sa + ((QE ? q / 2 - 1 : (q - 1) / 2) & 1) * R_PS;
      float* anew = sa + ((q / 2) & 1) * R_PS;
      const bool fin = q >= z0 + 2, start = q <= qmax - 2;
      auto add = [&](const Cell& c, float r) {
        if constexpr (QE) {
          if (fin) acur[c.aux] += p.t0[2] * r;
          if (start) anew[c.aux] = p.t0[0] * r;
        } else {
          acur[c.aux] += p.t0[1] * r;
        }
      };
      if (ce.tile1())
        add(ce, residual(cole[B + 0], cole[B + 1], cole[B + 2],
                         around<true, RR_W, RR_HALF>(su + o1, sb + o1, t),
                         p));
      if (co.tile1())
        add(co, residual(colo[B + 0], colo[B + 1], colo[B + 2],
                         around<false, RR_W, RR_HALF>(su + o1, sb + o1, t),
                         p));
    }
    // coarse plane c = qr/2 - 1 was finished at the last step (qr = 2c+2):
    // its axis-1 pass, then its axis-2 pass
    if constexpr (!QE) {
      const int qr = q - 1;
      constexpr int first = RR_THREADS - CT * CT;
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
    slot = next_slot<RR_RING>(slot);
  };
  // L0 is odd, so q = L0 - 1 is even: steps come in pairs (q even, q odd)
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

__global__ void __launch_bounds__(PC_THREADS, PC_BLOCKS_PER_SM)
prolong_correct3d_kernel(const float* __restrict__ u,
                         const float* __restrict__ e,
                         const float* __restrict__ omegas,
                         float* __restrict__ u_out, Transfer3 p) {
  constexpr int PER = PC_CELLS / PC_THREADS;   // cells a thread
  constexpr int ROWS = PC_THREADS / PC_T;      // rows between them
  extern __shared__ float smem[];
  float* su = smem;                          // PC_RING u planes of the tile
  float* se = su + PC_RING * PC_CELLS;       // PC_CRING coarse planes
  float* si = se + PC_CRING * PC_CS;         // 2 axis-0 passes, slot F & 1
  const int t = threadIdx.x;
  const int y0 = blockIdx.y * PC_T, x0 = blockIdx.x * PC_T;
  // y0 and x0 are even: coarse index y0/2 - 1 feeds the tile's first fine
  // index through its t[2] tap
  const int cy0 = y0 / 2 - 1, cx0 = x0 / 2 - 1;
  const int z0 = blockIdx.z * p.chunk;
  const int z1 = min(z0 + p.chunk, p.n0);
  const int nc0 = (p.n0 - 1) / 2, nc1 = (p.n1 - 1) / 2, nc2 = (p.n2 - 1) / 2;
  // the chunk's fine planes read coarse planes z0/2 - 1 .. (z1 - 1)/2
  const int cend = min((z1 - 1) / 2, nc0 - 1);
  const long plane = static_cast<long>(p.n1) * p.n2;
  const float om = omegas[p.om];
  // this thread's cells: column tx, rows ty + k * ROWS, one parity
  const int tx = t & (PC_T - 1), ty = t / PC_T;
  const bool ex = !(tx & 1), ey = !(ty & 1);
  const float wx0 = ex ? p.t2[2] : p.t2[1], wy0 = ey ? p.t1[2] : p.t1[1];
  int g[PER];
  bool in[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int gy = y0 + ty + k * ROWS, gx = x0 + tx;
    in[k] = gy < p.n1 && gx < p.n2;
    g[k] = gy * p.n2 + gx;
  }
  // the coarse window cell of this thread's first cell: fine index 2i+1+o
  // of an axis reads coarse window index i+1 (o = 0) or i, i+1 (o = -1)
  const int m0 = ((ty + 1) >> 1) * PC_CW + ((tx + 1) >> 1);
  // this thread's coarse window cell, if any
  const int ci = cy0 + t / PC_CW, cj = cx0 + t % PC_CW;
  const bool cin = t < PC_CS && ci >= 0 && ci < nc1 && cj >= 0 && cj < nc2;
  const long cg = cin ? static_cast<long>(ci) * nc2 + cj : 0;

  // start the copy of this thread's cell of coarse plane c into slot c & 3,
  // zero outside e and past the chunk; it joins the next fine plane's group
  auto fetch_coarse = [&](int c) {
    if (t >= PC_CS) return;
    const bool on = cin && c >= 0 && c <= cend;
    copy_async(se + (c & (PC_CRING - 1)) * PC_CS + t,
               e + (on ? c * static_cast<long>(nc1) * nc2 + cg : 0), on);
  };
  // fine plane P's cells into ring slot `slot` (only the chunk's planes),
  // with coarse plane (P+1)/2 when P is odd; one copy group
  auto fetch = [&](int P, int slot) {
    if (P & 1) fetch_coarse((P + 1) / 2);
    if (P < z1) {
#pragma unroll
      for (int k = 0; k < PER; ++k)
        if (in[k])
          copy_async(su + slot * PC_CELLS + t + k * PC_THREADS,
                     u + P * plane + g[k], true);
    }
    copy_commit();
  };
  // the prolongation's axis-0 pass for fine plane F over e's window (this
  // thread's cell): t0[1] e(c) on an odd F = 2c+1, t0[2] e(c-1) + t0[0]
  // e(c) on an even F = 2c (leg3d.py:313-340)
  auto inner = [&](int F) {
    if (t >= PC_CS) return;
    const int c = (F - 1) >> 1;
    float acc = 0.f;
    acc += (F & 1 ? p.t0[1] : p.t0[2]) * se[(c & (PC_CRING - 1)) * PC_CS + t];
    if (!(F & 1)) acc += p.t0[0] * se[((c + 1) & (PC_CRING - 1)) * PC_CS + t];
    si[(F & 1) * PC_CS + t] = acc;
  };

  // fine plane F reads coarse planes F/2 - 1 and F/2 (F even) or (F-1)/2
  // (F odd); z0 is even
  fetch_coarse(z0 / 2 - 1);
  fetch_coarse(z0 / 2);
#pragma unroll
  for (int a = 0; a < PC_AHEAD; ++a) fetch(z0 + a, a);
  copy_wait<PC_AHEAD - 1>();
  __syncthreads();
  inner(z0);
  __syncthreads();

  int slot = 0;                              // ring slot of plane s
  for (int s = z0; s < z1; ++s) {
    fetch(s + PC_AHEAD, slot_back<PC_RING>(slot, -PC_AHEAD));
    // plane s has arrived: u + omega * P(e), the axis-1 pass, then the
    // axis-2 pass over the axis-0 pass formed at the last step
    const float* pi = si + (s & 1) * PC_CS;
    const float* us = su + slot * PC_CELLS + t;
    float* out = u_out + s * plane;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if (!in[k]) continue;
      const int m = m0 + k * (ROWS / 2) * PC_CW;
      auto mid = [&](int j) {
        float acc = 0.f;
        acc += wy0 * pi[j];
        if (ey) acc += p.t1[0] * pi[j + PC_CW];
        return acc;
      };
      float corr = 0.f;
      corr += wx0 * mid(m);
      if (ex) corr += p.t2[0] * mid(m + 1);
      out[g[k]] = us[k * PC_THREADS] + om * corr;
    }
    // the axis-0 pass of plane s+1: its coarse planes are in
    if (s + 1 < z1) inner(s + 1);
    // plane s+1 is in; plane s+AHEAD may still be in flight
    copy_wait<PC_AHEAD - 1>();
    __syncthreads();
    slot = next_slot<PC_RING>(slot);
  }
  copy_wait<0>();
}

Transfer3 make_transfer(const double* coeffs, int om, int n0, int n1,
                        int n2) {
  Transfer3 p;
  p.c = static_cast<float>(coeffs[0]);
  p.cxm = static_cast<float>(coeffs[1]);
  p.cxp = static_cast<float>(coeffs[2]);
  p.cym = static_cast<float>(coeffs[3]);
  p.cyp = static_cast<float>(coeffs[4]);
  p.czm = static_cast<float>(coeffs[5]);
  p.czp = static_cast<float>(coeffs[6]);
  for (int k = 0; k < 3; ++k) {
    p.t0[k] = static_cast<float>(coeffs[7 + k]);
    p.t1[k] = static_cast<float>(coeffs[10 + k]);
    p.t2[k] = static_cast<float>(coeffs[13 + k]);
  }
  p.om = om;
  p.n0 = n0;
  p.n1 = n1;
  p.n2 = n2;
  p.chunk = 1;
  return p;
}

bool bad_shape(int n0, int n1, int n2) {
  return n0 < 3 || n1 < 3 || n2 < 3 || !(n0 & 1) || !(n1 & 1) || !(n2 & 1) ||
         n0 > 65535;
}

}  // namespace

// coeffs: 7 stencil values (center, -x, +x, -y, +y, -z, +z), then 3 taps
// for each of axes 0, 1, 2.  Writes rc ((n0-1)/2, (n1-1)/2, (n2-1)/2) =
// R (b - A u); returns the launch's cudaError_t.
extern "C" int es_residual_restrict_3d(const float* u, const float* b,
                                       const double* coeffs, float* rc,
                                       int n0, int n1, int n2, void* stream) {
  if (bad_shape(n0, n1, n2)) return cudaErrorInvalidValue;
  static bool opted[MAX_DEVICES];
  cudaError_t err = opt_in_smem(residual_restrict3d_kernel, RR_SMEM, opted);
  if (err != cudaSuccess) return err;
  Transfer3 p = make_transfer(coeffs, 0, n0, n1, n2);
  const dim3 grid = pipeline_blocks(n0, n1, n2, RR_T, RR_BLOCKS_PER_SM,
                                    RR_MIN_CHUNK, &p.chunk, &err);
  if (err != cudaSuccess) return err;
  residual_restrict3d_kernel<<<grid, RR_THREADS, RR_SMEM,
                               static_cast<cudaStream_t>(stream)>>>(u, b, rc,
                                                                    p);
  return cudaGetLastError();
}

// coeffs as above (the stencil values are not read).  om_id: index of the
// coarse-grid-correction factor in omegas.  Writes u + omega * P(e).
extern "C" int es_prolong_correct_3d(const float* u, const float* e,
                                     const float* omegas, int om_id,
                                     const double* coeffs, float* u_out,
                                     int n0, int n1, int n2, void* stream) {
  if (bad_shape(n0, n1, n2)) return cudaErrorInvalidValue;
  Transfer3 p = make_transfer(coeffs, om_id, n0, n1, n2);
  cudaError_t err = cudaSuccess;
  const dim3 grid = pipeline_blocks(n0, n1, n2, PC_T, PC_WAVE, PC_MIN_CHUNK,
                                    &p.chunk, &err);
  if (err != cudaSuccess) return err;
  prolong_correct3d_kernel<<<grid, PC_THREADS, PC_SMEM,
                             static_cast<cudaStream_t>(stream)>>>(u, e, omegas,
                                                                  u_out, p);
  return cudaGetLastError();
}

// What the card makes of es_residual_restrict_3d's kernel: the 11 values of
// pipeline_info (csrc/pipeline3d.cuh).
extern "C" int es_residual_restrict_3d_info(int* info) {
  return pipeline_info(
      reinterpret_cast<const void*>(residual_restrict3d_kernel), RR_T, RR_LO,
      RR_HI, RR_WARM, RR_MIN_CHUNK, RR_THREADS, RR_SMEM, info);
}

// What the card makes of es_prolong_correct_3d's kernel: the 11 values of
// pipeline_info, with no halo and no warm-up (the prolongation is
// pointwise).
extern "C" int es_prolong_correct_3d_info(int* info) {
  return pipeline_info(
      reinterpret_cast<const void*>(prolong_correct3d_kernel), PC_T, 0, 0, 0,
      PC_MIN_CHUNK, PC_THREADS, PC_SMEM, info);
}
