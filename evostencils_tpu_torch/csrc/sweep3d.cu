// Standalone smoother sweeps of a constant 7-point 3D operator for Hopper
// (sm_90a), float32.
//
// es_sweep3d replaces two TPU kernels that compute the same function:
//   evostencils_tpu/ops/pallas/rbgs3d.py fused_rbgs_sweep_3d and
//   jacobi_sweep_3d (_sweep_call_3d, _fused_rb3d_kernel), the
//   plane-blocked kernel that the JAX gate sends 127^3 and 63^3 to, and
//   evostencils_tpu/ops/pallas/leg3d.py fused_rbgs_sweep_3d2 and
//   jacobi_sweep_3d2 (_rb2ax_kernel), the two-axis-blocked kernel that
//   takes 255^3 and up, where whole planes overflow the TPU's VMEM budget.
//   Hopper has no such budget, so one kernel serves both; the wrappers
//   count its launches under the four names.
// One call is one launch: either a damped red-black Gauss-Seidel sweep
// (red, then black with the new red values) or a damped Jacobi sweep, with
// the TPU kernels' update at each updated point
//   u + omega * (dinv * b - u - off),
//   off = ((((dxm*xm + dxp*xp) + dym*ym) + dyp*yp) + dzm*zm) + dzp*zp,
// where d_k = c_k * dinv is folded on the host in double (rbgs3d.py:113-138,
// leg3d.py:156-165).  Red is an ODD sum of interior indices (interior index
// i is node i+1 on all three axes, rbgs3d.py:106-107).  Points outside the
// grid are 0 and never updated.  The relaxation factor is read from the
// device vector by index, so no launch waits on the host.
//
// What bounds it: device-memory bytes.  A sweep must read u and b once and
// write u once, 12 bytes a point: at 255^3 that is 198,976,500 bytes,
// 0.0594 ms at 3.35 TB/s.  It does about 16 flops a point.
//
// Red-black design: the 2.5-D walk of csrc/wavefront3d.cu with one sweep
// (the helpers of csrc/walk3d.cuh).
// Each block owns a 32 x 32 tile of the (axis-1, axis-2) plane, loads it
// with a 2-cell halo, and walks a chunk of axis 0 plane by plane: at the
// step that loads plane L it updates red on plane L-1, then black on plane
// L-2 (which sees the new red values of L-1 and L-3) and stores plane L-2.
// Both half-sweeps update a ring of 4 planes in place: every neighbour of
// an updated cell has the other colour.  Window-edge cells see zeros in
// place of their out-of-window neighbours; the error moves inward one cell
// per half-sweep, so a halo of 2 leaves the tile exact, and a chunk that
// starts at plane z0 begins its walk 2 planes early, treating the planes
// before as zero.  Shared memory: 4 u planes and 3 b planes of 36 x 36,
// 36,288 bytes; u and b are read (36/32)^2 = 1.27 times in the plane, plus
// 2 planes per chunk.
//
// Jacobi design: one thread a point, as es_sweep in csrc/rbgs.cu: the
// neighbours come through L1/L2, and the output goes to a buffer the
// kernel does not read, so every point sees the old u.

#include <cuda_runtime.h>

#include "walk3d.cuh"

namespace {

constexpr int T1 = 32, T2 = 32;               // in-plane tile (axis 1, 2)
constexpr int H = 2;                          // in-plane halo
constexpr int W1 = T1 + 2 * H, W2 = T2 + 2 * H;
constexpr int PLANE = W1 * W2;
constexpr int LAG = 2;                        // axis-0 warm-up planes
constexpr int URING = 4, BRING = 3;
constexpr int MIN_CHUNK = 4;                  // axis-0 planes per block
constexpr int RB_THREADS = 256, RB_BLOCKS_PER_SM = 4;
constexpr int JAC_BX = 32, JAC_BY = 8;

struct Sweep3 {
  // 1/c and the neighbour coefficients -x, +x, -y, +y, -z, +z scaled by it
  // (x = axis 0, y = axis 1, z = axis 2)
  float dinv, dxm, dxp, dym, dyp, dzm, dzp;
  int om;        // index into the relaxation-factor vector
  int n0, n1, n2;
  int chunk;     // axis-0 planes per block (red-black)
};

__global__ void __launch_bounds__(RB_THREADS, RB_BLOCKS_PER_SM)
rb_sweep3d_kernel(const float* __restrict__ u, const float* __restrict__ b,
                  const float* __restrict__ omegas, float* __restrict__ out,
                  Sweep3 p) {
  __shared__ float su[URING * PLANE];
  __shared__ float sb[BRING * PLANE];
  const int y0 = blockIdx.y * T1 - H, x0 = blockIdx.x * T2 - H;
  const int z0 = blockIdx.z * p.chunk;
  const int z1 = min(z0 + p.chunk, p.n0);    // planes [z0, z1) are stored
  const int L0 = z0 - LAG;
  const float om = omegas[p.om];

  // planes before L0 are never loaded and read as zero
  for (int i = threadIdx.x; i < URING * PLANE; i += blockDim.x) su[i] = 0.f;

  auto uplane = [&](int pl) { return su + ring(pl, L0, URING) * PLANE; };
  auto bplane = [&](int pl) { return sb + ring(pl, L0, BRING) * PLANE; };

  for (int L = L0; L <= z1 - 1 + LAG; ++L) {
    __syncthreads();
    load_plane<W1, W2>(u, b, uplane(L), bplane(L), p, L, y0, x0);
    // red on plane L-1, then black on plane L-2
    for (int k = 1; k <= 2; ++k) {
      __syncthreads();
      const int pl = L - k;
      if (pl < L0 || pl < 0 || pl >= p.n0) continue;
      half_sweep<W1, W2>(uplane(pl), uplane(pl - 1), uplane(pl + 1),
                         bplane(pl), p, om, pl, y0, x0, k & 1);
    }
    __syncthreads();
    const int pf = L - 2;
    if (pf >= z0 && pf < z1)
      store_plane<T1, T2, W2, H>(uplane(pf), out, p, pf, y0, x0);
  }
}

__global__ void __launch_bounds__(JAC_BX * JAC_BY)
jacobi_sweep3d_kernel(const float* __restrict__ u,
                      const float* __restrict__ b,
                      const float* __restrict__ omegas,
                      float* __restrict__ out, Sweep3 p) {
  const int k = blockIdx.x * JAC_BX + threadIdx.x;
  const int j = blockIdx.y * JAC_BY + threadIdx.y;
  const int i = blockIdx.z;
  if (j >= p.n1 || k >= p.n2) return;
  const long s0 = static_cast<long>(p.n1) * p.n2;
  const long g = i * s0 + static_cast<long>(j) * p.n2 + k;
  const float v = u[g];
  const float xm = i > 0 ? u[g - s0] : 0.f;
  const float xp = i < p.n0 - 1 ? u[g + s0] : 0.f;
  const float ym = j > 0 ? u[g - p.n2] : 0.f;
  const float yp = j < p.n1 - 1 ? u[g + p.n2] : 0.f;
  const float zm = k > 0 ? u[g - 1] : 0.f;
  const float zp = k < p.n2 - 1 ? u[g + 1] : 0.f;
  float off = p.dxm * xm;
  off += p.dxp * xp;
  off += p.dym * ym;
  off += p.dyp * yp;
  off += p.dzm * zm;
  off += p.dzp * zp;
  out[g] = v + omegas[p.om] * (p.dinv * b[g] - v - off);
}

Sweep3 make_sweep(const double* vals, int om, int n0, int n1, int n2) {
  Sweep3 p;
  const double dinv = 1.0 / vals[0];
  p.dinv = static_cast<float>(dinv);
  p.dxm = static_cast<float>(vals[1] * dinv);
  p.dxp = static_cast<float>(vals[2] * dinv);
  p.dym = static_cast<float>(vals[3] * dinv);
  p.dyp = static_cast<float>(vals[4] * dinv);
  p.dzm = static_cast<float>(vals[5] * dinv);
  p.dzp = static_cast<float>(vals[6] * dinv);
  p.om = om;
  p.n0 = n0;
  p.n1 = n1;
  p.n2 = n2;
  p.chunk = n0;
  return p;
}

// Red-black blocks over (axis 2, axis 1) tiles and axis-0 chunks: as many
// chunks as fill about one wave of resident blocks on every SM, but no
// chunk under MIN_CHUNK planes.
dim3 rb_blocks(Sweep3& p, cudaError_t* err) {
  int device = 0, sms = 0;
  *err = cudaGetDevice(&device);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device);
  const int tiles1 = (p.n1 + T1 - 1) / T1, tiles2 = (p.n2 + T2 - 1) / T2;
  int chunks = (sms * RB_BLOCKS_PER_SM) / (tiles1 * tiles2);
  chunks = chunks < 1 ? 1 : chunks;
  const int max_chunks = (p.n0 + MIN_CHUNK - 1) / MIN_CHUNK;
  chunks = chunks > max_chunks ? max_chunks : chunks;
  p.chunk = (p.n0 + chunks - 1) / chunks;
  return dim3(tiles2, tiles1, (p.n0 + p.chunk - 1) / p.chunk);
}

}  // namespace

// vals: 7 stencil values (center, -x, +x, -y, +y, -z, +z).  om: index of
// the relaxation factor in omegas.  red_black: 1 for a red-black sweep, 0
// for a Jacobi sweep.  Writes out (n0, n1, n2); returns the launch's
// cudaError_t.
extern "C" int es_sweep3d(const float* u, const float* b, const float* omegas,
                          int om, int red_black, const double* vals,
                          float* out, int n0, int n1, int n2, void* stream) {
  if (n0 < 1 || n1 < 1 || n2 < 1 || n0 > 65535 || vals[0] == 0.0 ||
      (red_black != 0 && red_black != 1))
    return cudaErrorInvalidValue;
  Sweep3 p = make_sweep(vals, om, n0, n1, n2);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (red_black) {
    cudaError_t err;
    const dim3 grid = rb_blocks(p, &err);
    if (err != cudaSuccess) return err;
    rb_sweep3d_kernel<<<grid, RB_THREADS, 0, s>>>(u, b, omegas, out, p);
  } else {
    const dim3 grid((n2 + JAC_BX - 1) / JAC_BX, (n1 + JAC_BY - 1) / JAC_BY,
                    n0);
    jacobi_sweep3d_kernel<<<grid, dim3(JAC_BX, JAC_BY), 0, s>>>(u, b, omegas,
                                                               out, p);
  }
  return cudaGetLastError();
}
