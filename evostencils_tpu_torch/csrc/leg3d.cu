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
// es_residual_restrict_3d_info reports the schedule with the card's
// occupancy; ops/kernels/leg3d.py states its constants, and
// tests/test_torch_wavefront_tiles.py emulates it in float64.
// es_prolong_correct_3d: one thread a fine point; it reads its (at most 8)
// coarse values through the cache; e is an eighth of u.
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
constexpr int PC_BX = 32, PC_BY = 8;

static_assert(RR_W % 2 == 1, "odd window rows");
static_assert(RR_T % 2 == 0 && RR_WARM % 2 == 1,
              "tiles and chunks start at even indices, walks at odd steps");
static_assert(CT * CT <= RR_THREADS, "one thread a coarse tile point");

struct Transfer3 {
  // 7-point stencil: center, then the neighbours -x, +x, -y, +y, -z, +z
  // (x = axis 0, y = axis 1, z = axis 2)
  float c, cxm, cxp, cym, cyp, czm, czp;
  float t0[3], t1[3], t2[3];    // transfer taps per axis
  int om;                       // index into the relaxation-factor vector
  int n0, n1, n2;
  int chunk;                    // fine planes per block (restriction; even)
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

// Prolongation weights along one axis: fine interior index g takes
// t[1] * e[(g-1)/2] when odd, t[2] * e[g/2-1] + t[0] * e[g/2] when even;
// coarse indices outside [0, nc) are dropped (they hold 0).  Returns the
// count of coarse indices.
__device__ __forceinline__ int prolong_taps(int g, int nc, const float* t,
                                            int* ci, float* w) {
  if (g & 1) {
    ci[0] = (g - 1) / 2;
    w[0] = t[1];
    return 1;
  }
  int n = 0;
  if (g / 2 - 1 >= 0) {
    ci[n] = g / 2 - 1;
    w[n++] = t[2];
  }
  if (g / 2 < nc) {
    ci[n] = g / 2;
    w[n++] = t[0];
  }
  return n;
}

__global__ void __launch_bounds__(PC_BX * PC_BY)
prolong_correct3d_kernel(const float* __restrict__ u,
                         const float* __restrict__ e,
                         const float* __restrict__ omegas,
                         float* __restrict__ u_out, Transfer3 p) {
  const int g2 = blockIdx.x * PC_BX + threadIdx.x;
  const int g1 = blockIdx.y * PC_BY + threadIdx.y;
  const int g0 = blockIdx.z;
  if (g1 >= p.n1 || g2 >= p.n2) return;
  const int nc0 = (p.n0 - 1) / 2, nc1 = (p.n1 - 1) / 2, nc2 = (p.n2 - 1) / 2;
  int c0[2], c1[2], c2[2];
  float w0[2], w1[2], w2[2];
  const int k0 = prolong_taps(g0, nc0, p.t0, c0, w0);
  const int k1 = prolong_taps(g1, nc1, p.t1, c1, w1);
  const int k2 = prolong_taps(g2, nc2, p.t2, c2, w2);
  // axis 0 innermost (first), then axis 1, then axis 2
  float corr = 0.f;
  for (int m = 0; m < k2; ++m) {
    float mid = 0.f;
    for (int l = 0; l < k1; ++l) {
      float inner = 0.f;
      for (int k = 0; k < k0; ++k)
        inner += w0[k] * e[(static_cast<long>(c0[k]) * nc1 + c1[l]) * nc2 +
                           c2[m]];
      mid += w1[l] * inner;
    }
    corr += w2[m] * mid;
  }
  const long g = (static_cast<long>(g0) * p.n1 + g1) * p.n2 + g2;
  u_out[g] = u[g] + omegas[p.om] * corr;
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
  const Transfer3 p = make_transfer(coeffs, om_id, n0, n1, n2);
  const dim3 grid((n2 + PC_BX - 1) / PC_BX, (n1 + PC_BY - 1) / PC_BY, n0);
  prolong_correct3d_kernel<<<grid, dim3(PC_BX, PC_BY), 0,
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
