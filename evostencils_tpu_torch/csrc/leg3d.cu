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
// es_residual_restrict_3d: a 2.5-D walk, as the tail of the 3D down-leg in
// csrc/wavefront3d.cu.  Each block owns a 16 x 16 tile of coarse points in
// the (axis-1, axis-2) plane, i.e. fine rows and columns 2*c .. 2*c + 32 of
// r (33 of them), which need u one cell further out (35).  It walks a chunk
// of coarse planes along axis 0: at the step that loads u plane L it
// computes the residual of plane L-1 into a ring of 3 residual planes, and
// when that plane is even, the coarse plane that reads fine planes L-3,
// L-2 and L-1.  b is read straight from device memory, once.  Shared
// memory: 3 u planes of 35 x 35 and 3 residual planes of 33 x 33, 27,768
// bytes; u is read (35/32)^2 = 1.20 times in the plane.
// es_prolong_correct_3d: one thread a fine point; it reads its (at most 8)
// coarse values through the cache; e is an eighth of u.
// Coarse point c of an axis sits at fine index 2c+1 on it.  Cells outside
// the grid hold 0.  The relaxation factor is read from the device vector
// by index, so no launch waits on the host.

#include <cuda_runtime.h>

namespace {

constexpr int CT = 16;                     // coarse tile edge (axis 1, 2)
constexpr int RW = 2 * CT + 1;             // residual window edge
constexpr int UW = RW + 2;                 // u window edge
constexpr int RR_THREADS = 256, RR_BLOCKS_PER_SM = 4;
constexpr int PC_BX = 32, PC_BY = 8;

struct Transfer3 {
  // 7-point stencil: center, then the neighbours -x, +x, -y, +y, -z, +z
  // (x = axis 0, y = axis 1, z = axis 2)
  float c, cxm, cxp, cym, cyp, czm, czp;
  float t0[3], t1[3], t2[3];    // transfer taps per axis
  int om;                       // index into the relaxation-factor vector
  int n0, n1, n2;
  int chunk;                    // coarse planes per block (restriction)
};

__device__ __forceinline__ int ring3(int p, int base) {
  return (p - base + 3) % 3;
}

__global__ void __launch_bounds__(RR_THREADS, RR_BLOCKS_PER_SM)
residual_restrict3d_kernel(const float* __restrict__ u,
                           const float* __restrict__ b,
                           float* __restrict__ rc, Transfer3 p) {
  __shared__ float su[3 * UW * UW];
  __shared__ float sr[3 * RW * RW];
  const int nc0 = (p.n0 - 1) / 2, nc1 = (p.n1 - 1) / 2, nc2 = (p.n2 - 1) / 2;
  const int cy0 = blockIdx.y * CT, cx0 = blockIdx.x * CT;
  const int y0 = 2 * cy0, x0 = 2 * cx0;      // first residual row, column
  const int c0 = blockIdx.z * p.chunk;
  const int c1 = min(c0 + p.chunk, nc0);     // coarse planes [c0, c1)
  const int qlo = 2 * c0, qhi = 2 * c1;      // residual planes [qlo, qhi]

  auto uplane = [&](int pl) { return su + ring3(pl, qlo - 1) * UW * UW; };
  auto rplane = [&](int q) { return sr + ring3(q, qlo) * RW * RW; };

  for (int L = qlo - 1; L <= qhi + 1; ++L) {
    __syncthreads();
    {
      float* du = uplane(L);
      const bool plane_in = L >= 0 && L < p.n0;
      for (int idx = threadIdx.x; idx < UW * UW; idx += blockDim.x) {
        const int i = idx / UW, j = idx - i * UW;
        const int gy = y0 - 1 + i, gx = x0 - 1 + j;
        const bool in =
            plane_in && gy >= 0 && gy < p.n1 && gx >= 0 && gx < p.n2;
        du[idx] = in ? u[(static_cast<long>(L) * p.n1 + gy) * p.n2 + gx]
                     : 0.f;
      }
    }
    __syncthreads();
    const int q = L - 1;
    if (q < qlo) continue;
    {
      const float* cur = uplane(q);
      const float* lo = uplane(q - 1);
      const float* hi = uplane(q + 1);
      float* r = rplane(q);
      for (int idx = threadIdx.x; idx < RW * RW; idx += blockDim.x) {
        const int i = idx / RW, j = idx - i * RW;
        const int gy = y0 + i, gx = x0 + j;
        const int w = (i + 1) * UW + j + 1;
        float res = 0.f;
        if (gy < p.n1 && gx < p.n2) {
          float au = p.c * cur[w];
          au += p.cxm * lo[w];
          au += p.cxp * hi[w];
          au += p.cym * cur[w - UW];
          au += p.cyp * cur[w + UW];
          au += p.czm * cur[w - 1];
          au += p.czp * cur[w + 1];
          res = b[(static_cast<long>(q) * p.n1 + gy) * p.n2 + gx] - au;
        }
        r[idx] = res;
      }
    }
    // coarse plane c reads fine planes 2c, 2c+1, 2c+2: axis 0 first, then
    // axis 1, then axis 2
    if ((q & 1) || q < qlo + 2) continue;
    __syncthreads();
    const int c = q / 2 - 1;
    const float* r0 = rplane(q - 2);
    const float* r1 = rplane(q - 1);
    const float* r2 = rplane(q);
    for (int idx = threadIdx.x; idx < CT * CT; idx += blockDim.x) {
      const int i = idx / CT, j = idx - i * CT;
      const int ci = cy0 + i, cj = cx0 + j;
      if (ci >= nc1 || cj >= nc2) continue;
      float acc = 0.f;
      for (int d = 0; d < 3; ++d) {
        float rows = 0.f;
        for (int a = 0; a < 3; ++a) {
          const int k = (2 * i + a) * RW + 2 * j + d;
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
  Transfer3 p = make_transfer(coeffs, 0, n0, n1, n2);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  // as many chunks of coarse planes as fill about one wave of resident
  // blocks on every SM, but at least one coarse plane each
  const int nc0 = (n0 - 1) / 2, nc1 = (n1 - 1) / 2, nc2 = (n2 - 1) / 2;
  const int tiles1 = (nc1 + CT - 1) / CT, tiles2 = (nc2 + CT - 1) / CT;
  int chunks = (sms * RR_BLOCKS_PER_SM) / (tiles1 * tiles2);
  chunks = chunks < 1 ? 1 : (chunks > nc0 ? nc0 : chunks);
  p.chunk = (nc0 + chunks - 1) / chunks;
  const dim3 grid(tiles2, tiles1, (nc0 + p.chunk - 1) / p.chunk);
  residual_restrict3d_kernel<<<grid, RR_THREADS, 0,
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
