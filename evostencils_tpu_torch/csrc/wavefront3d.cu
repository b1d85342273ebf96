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
// So every intermediate half-sweep, the residual and the transfers stay in
// shared memory, and a leg costs one pass over u and b, plus the halo that
// neighbouring blocks read again.
//
// Design: 2.5-D blocking.  The TPU kernel walks axis 0 in order on one
// core, with whole (n1, n2) planes and a lag of one plane per pipeline
// stage.  Here each block owns a T1 x T2 tile of the (axis-1, axis-2)
// plane, loads it with an in-plane halo, and walks a chunk of axis 0 plane
// by plane with the same one-plane lag per stage: at the step that loads
// plane L, the down-leg runs red-1 on plane L-1, black-1 on L-2, red-2 on
// L-3, black-2 on L-4 (whose final u it stores) and the residual on L-5.
// All stages update one ring of planes in place: in a half-sweep every
// neighbour of an updated cell has the other colour, and the lag makes
// every stage read exactly the values that the sequential order gives.
// The in-plane halo is recomputed by neighbouring tiles.  Window-edge
// cells see zeros in place of their out-of-window neighbours; the error
// moves inward one cell per half-sweep, so after 4 half-sweeps, the
// residual (one more ring) and the restriction's 2i+2 sample past the
// tile, the down-leg needs an in-plane halo of 2S+2 = 6; the up-leg's
// prolongation is pointwise and its two half-sweeps need 2.
// Axis 0 is cut into chunks so that enough blocks run; a chunk starting at
// plane z0 begins its pipeline 5 planes early (2 for the up-leg), treating
// the planes before as zero: the same error analysis, along axis 0.
// Tiles and chunks start at even interior indices on every axis, so every
// coarse point's restriction window and every prolongation stencil lies in
// one block.  Interior index i is node i+1 on every axis, so red (even node
// sum) is an ODD interior-index sum in 3D (wavefront3d.py:98).  Cells
// outside the grid hold 0 and are never updated.  Relaxation factors are
// read from the device vector by index, so no launch waits on the host.
//
// Per block: the down-leg keeps 7 u planes and 6 b planes of 44 x 44 and 3
// residual planes of 33 x 33 in shared memory (113,740 bytes: two blocks
// per SM); the up-leg 4 u planes and 3 b planes of 36 x 36 and 2 coarse
// planes of 19 x 19 (39,176 bytes).

#include <cuda_runtime.h>

#include "walk3d.cuh"

namespace {

constexpr int T1 = 32, T2 = 32;               // in-plane tile (axis 1, 2)
constexpr int DH = 6, UH = 2;                 // in-plane halo, down / up
constexpr int DW1 = T1 + 2 * DH, DW2 = T2 + 2 * DH;
constexpr int UW1 = T1 + 2 * UH, UW2 = T2 + 2 * UH;
constexpr int D_LAG = 5, U_LAG = 2;           // axis-0 warm-up planes
constexpr int D_URING = 7, D_BRING = 6, D_RRING = 3;
constexpr int U_URING = 4, U_BRING = 3;
constexpr int RT1 = T1 + 1, RT2 = T2 + 1;     // residual region per plane
constexpr int CW1 = UW1 / 2 + 1, CW2 = UW2 / 2 + 1;  // coarse window
constexpr int DOWN_THREADS = 512, UP_THREADS = 256;
constexpr int DOWN_BLOCKS_PER_SM = 2, UP_BLOCKS_PER_SM = 4;
constexpr int DOWN_SMEM =
    ((D_URING + D_BRING) * DW1 * DW2 + D_RRING * RT1 * RT2) * sizeof(float);
constexpr int UP_SMEM =
    ((U_URING + U_BRING) * UW1 * UW2 + 2 * CW1 * CW2) * sizeof(float);

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
  constexpr int PLANE = DW1 * DW2;
  constexpr int RPLANE = RT1 * RT2;
  extern __shared__ float smem[];
  float* su = smem;                          // D_URING u planes
  float* sb = su + D_URING * PLANE;          // D_BRING b planes
  float* sr = sb + D_BRING * PLANE;          // D_RRING residual planes
  const int y0 = blockIdx.y * T1 - DH, x0 = blockIdx.x * T2 - DH;
  const int z0 = blockIdx.z * p.chunk;
  const int z1 = min(z0 + p.chunk, p.n0);    // planes [z0, z1) are stored
  const int qmax = min(z0 + p.chunk, p.n0 - 1);  // last residual plane
  const int L0 = z0 - D_LAG;
  const int nc0 = (p.n0 - 1) / 2, nc1 = (p.n1 - 1) / 2, nc2 = (p.n2 - 1) / 2;
  const float om[2] = {omegas[p.om0], omegas[p.om1]};

  // planes before L0 are never loaded and read as zero
  for (int i = threadIdx.x; i < D_URING * PLANE; i += blockDim.x) su[i] = 0.f;

  auto uplane = [&](int pl) { return su + ring(pl, L0, D_URING) * PLANE; };
  auto bplane = [&](int pl) { return sb + ring(pl, L0, D_BRING) * PLANE; };
  auto rplane = [&](int q) { return sr + ring(q, z0, D_RRING) * RPLANE; };

  for (int L = L0; L <= qmax + D_LAG; ++L) {
    __syncthreads();
    load_plane<DW1, DW2>(u, b, uplane(L), bplane(L), p, L, y0, x0);
    // stage k (1..4) sweeps plane L - k: red, black with omega_1, then
    // red, black with omega_2
    for (int k = 1; k <= 4; ++k) {
      __syncthreads();
      const int pl = L - k;
      if (pl < L0 || pl < 0 || pl >= p.n0) continue;
      half_sweep<DW1, DW2>(uplane(pl), uplane(pl - 1), uplane(pl + 1),
                           bplane(pl), p, om[(k - 1) / 2], pl, y0, x0,
                           k & 1);
    }
    __syncthreads();
    const int pf = L - 4;                    // final u
    if (pf >= z0 && pf < z1)
      store_plane<T1, T2, DW2, DH>(uplane(pf), u_out, p, pf, y0, x0);

    // residual of plane q on the tile and one more row and column (the
    // restriction reads fine index 2i+2 past the tile)
    const int q = L - D_LAG;
    if (q < z0 || q > qmax) continue;
    {
      const float* cur = uplane(q);
      const float* lo = uplane(q - 1);
      const float* hi = uplane(q + 1);
      const float* bb = bplane(q);
      float* r = rplane(q);
      for (int idx = threadIdx.x; idx < RPLANE; idx += blockDim.x) {
        const int i = idx / RT2, j = idx - i * RT2;
        const int gy = y0 + DH + i, gx = x0 + DH + j;
        const int w = (DH + i) * DW2 + DH + j;
        float res = 0.f;
        if (gy < p.n1 && gx < p.n2) {
          float au = p.c * cur[w];
          au += p.cxm * lo[w];
          au += p.cxp * hi[w];
          au += p.cym * cur[w - DW2];
          au += p.cyp * cur[w + DW2];
          au += p.czm * cur[w - 1];
          au += p.czp * cur[w + 1];
          res = bb[w] - au;
        }
        r[idx] = res;
      }
    }
    // coarse plane c reads fine planes 2c, 2c+1, 2c+2: axis 0 first, then
    // axis 1, then axis 2 (wavefront3d.py:164-197)
    if ((q & 1) || q < z0 + 2) continue;
    const int c = q / 2 - 1;
    if (c >= nc0) continue;
    __syncthreads();
    const float* r0 = rplane(q - 2);
    const float* r1 = rplane(q - 1);
    const float* r2 = rplane(q);
    constexpr int CT1 = T1 / 2, CT2 = T2 / 2;
    for (int idx = threadIdx.x; idx < CT1 * CT2; idx += blockDim.x) {
      const int i = idx / CT2, j = idx - i * CT2;
      const int ci = blockIdx.y * CT1 + i, cj = blockIdx.x * CT2 + j;
      if (ci >= nc1 || cj >= nc2) continue;
      float acc = 0.f;
      for (int d = 0; d < 3; ++d) {
        float rows = 0.f;
        for (int a = 0; a < 3; ++a) {
          const int k = (2 * i + a) * RT2 + 2 * j + d;
          float planes = p.t0[0] * r0[k];
          planes += p.t0[1] * r1[k];
          planes += p.t0[2] * r2[k];
          rows += p.t1[a] * planes;
        }
        acc += p.t2[d] * rows;
      }
      rc[(static_cast<long>(c) * nc1 + ci) * nc2 + cj] = acc;
    }
  }
}

// Prolongation weights along one axis: fine interior index g takes
// t[1] * e[(g-1)/2] when odd, t[2] * e[g/2-1] + t[0] * e[g/2] when even
// (transfer.py:896-903).  Returns the count of coarse indices.
__device__ __forceinline__ int prolong_taps(int g, const float* t, int* ci,
                                            float* w) {
  if (g & 1) {
    ci[0] = (g - 1) / 2;
    w[0] = t[1];
    return 1;
  }
  ci[0] = g / 2 - 1;
  w[0] = t[2];
  ci[1] = g / 2;
  w[1] = t[0];
  return 2;
}

__global__ void __launch_bounds__(UP_THREADS, UP_BLOCKS_PER_SM)
upleg3d_kernel(const float* __restrict__ u, const float* __restrict__ e,
               const float* __restrict__ b, const float* __restrict__ omegas,
               float* __restrict__ u_out, Leg3 p) {
  constexpr int PLANE = UW1 * UW2;
  constexpr int CPLANE = CW1 * CW2;
  extern __shared__ float smem[];
  float* su = smem;                          // U_URING u planes
  float* sb = su + U_URING * PLANE;          // U_BRING b planes
  float* se = sb + U_BRING * PLANE;          // 2 coarse planes, slot c & 1
  const int y0 = blockIdx.y * T1 - UH, x0 = blockIdx.x * T2 - UH;
  // y0 and x0 are even: coarse index y0/2 - 1 feeds the window's first
  // (even) fine index through its t[2] tap
  const int cy0 = y0 / 2 - 1, cx0 = x0 / 2 - 1;
  const int z0 = blockIdx.z * p.chunk;
  const int z1 = min(z0 + p.chunk, p.n0);
  const int L0 = z0 - U_LAG;
  const int nc0 = (p.n0 - 1) / 2, nc1 = (p.n1 - 1) / 2, nc2 = (p.n2 - 1) / 2;
  const float om_c = omegas[p.om0], om_s = omegas[p.om1];

  for (int i = threadIdx.x; i < U_URING * PLANE; i += blockDim.x) su[i] = 0.f;

  auto uplane = [&](int pl) { return su + ring(pl, L0, U_URING) * PLANE; };
  auto bplane = [&](int pl) { return sb + ring(pl, L0, U_BRING) * PLANE; };
  auto load_coarse = [&](int c) {
    float* dst = se + (c & 1) * CPLANE;
    const bool plane_in = c >= 0 && c < nc0;
    for (int idx = threadIdx.x; idx < CPLANE; idx += blockDim.x) {
      const int i = idx / CW2, j = idx - i * CW2;
      const int ci = cy0 + i, cj = cx0 + j;
      const bool in = plane_in && ci >= 0 && ci < nc1 && cj >= 0 && cj < nc2;
      dst[idx] = in ? e[(static_cast<long>(c) * nc1 + ci) * nc2 + cj] : 0.f;
    }
  };

  for (int L = L0; L <= z1 - 1 + U_LAG; ++L) {
    __syncthreads();
    // fine plane L reads coarse planes L/2 - 1 and L/2 (L even) or
    // (L-1)/2 (L odd); L0 is even
    if (L == L0) load_coarse(L / 2 - 1);
    if (!(L & 1)) load_coarse(L / 2);
    __syncthreads();

    // load plane L and add omega_c * P(e): axis 0 first, then axis 1,
    // then axis 2 (wavefront3d.py:321-343)
    {
      float* du = uplane(L);
      float* db = bplane(L);
      const bool plane_in = L >= 0 && L < p.n0;
      int cp[2], cr[2], cc[2];
      float wp[2], wr[2], wc[2];
      const int np_ = prolong_taps(L, p.t0, cp, wp);
      for (int idx = threadIdx.x; idx < PLANE; idx += blockDim.x) {
        const int wy = idx / UW2, wx = idx - wy * UW2;
        const int gy = y0 + wy, gx = x0 + wx;
        const bool in =
            plane_in && gy >= 0 && gy < p.n1 && gx >= 0 && gx < p.n2;
        float v = 0.f, bv = 0.f;
        if (in) {
          const long g = (static_cast<long>(L) * p.n1 + gy) * p.n2 + gx;
          v = u[g];
          bv = b[g];
          const int nr = prolong_taps(gy, p.t1, cr, wr);
          const int nc = prolong_taps(gx, p.t2, cc, wc);
          float corr = 0.f;
          for (int m = 0; m < nc; ++m) {
            float mid = 0.f;
            for (int l = 0; l < nr; ++l) {
              float inner = 0.f;
              for (int k = 0; k < np_; ++k)
                inner += wp[k] * se[(cp[k] & 1) * CPLANE +
                                    (cr[l] - cy0) * CW2 + cc[m] - cx0];
              mid += wr[l] * inner;
            }
            corr += wc[m] * mid;
          }
          v += om_c * corr;
        }
        du[idx] = v;
        db[idx] = bv;
      }
    }
    // red on plane L-1, black on plane L-2
    for (int k = 1; k <= 2; ++k) {
      __syncthreads();
      const int pl = L - k;
      if (pl < L0 || pl < 0 || pl >= p.n0) continue;
      half_sweep<UW1, UW2>(uplane(pl), uplane(pl - 1), uplane(pl + 1),
                           bplane(pl), p, om_s, pl, y0, x0, k & 1);
    }
    __syncthreads();
    const int pf = L - 2;
    if (pf >= z0 && pf < z1)
      store_plane<T1, T2, UW2, UH>(uplane(pf), u_out, p, pf, y0, x0);
  }
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

// Blocks over (axis 2, axis 1) tiles and axis-0 chunks: as many even-sized
// chunks as fill about one wave of `per_sm` resident blocks on every SM,
// but no chunk under 8 planes.
dim3 blocks_for(Leg3& p, int per_sm, cudaError_t* err) {
  int device = 0, sms = 0;
  *err = cudaGetDevice(&device);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device);
  const int tiles1 = (p.n1 + T1 - 1) / T1, tiles2 = (p.n2 + T2 - 1) / T2;
  int chunks = (sms * per_sm) / (tiles1 * tiles2);
  chunks = chunks < 1 ? 1 : chunks;
  const int max_chunks = (p.n0 + 7) / 8;
  chunks = chunks > max_chunks ? max_chunks : chunks;
  int chunk = (p.n0 + chunks - 1) / chunks;
  chunk += chunk & 1;
  p.chunk = chunk;
  return dim3(tiles2, tiles1, (p.n0 + chunk - 1) / chunk);
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
  cudaError_t err = cudaFuncSetAttribute(
      downleg3d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DOWN_SMEM);
  if (err != cudaSuccess) return err;
  Leg3 p = make_leg(coeffs, om_ids, n0, n1, n2);
  const dim3 grid = blocks_for(p, DOWN_BLOCKS_PER_SM, &err);
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
  cudaError_t err = cudaFuncSetAttribute(
      upleg3d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, UP_SMEM);
  if (err != cudaSuccess) return err;
  Leg3 p = make_leg(coeffs, om_ids, n0, n1, n2);
  const dim3 grid = blocks_for(p, UP_BLOCKS_PER_SM, &err);
  if (err != cudaSuccess) return err;
  upleg3d_kernel<<<grid, UP_THREADS, UP_SMEM,
                   static_cast<cudaStream_t>(stream)>>>(u, e, b, omegas,
                                                        u_out, p);
  return cudaGetLastError();
}
