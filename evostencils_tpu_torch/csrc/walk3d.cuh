// Device helpers of the 2.5-D walk shared by csrc/wavefront3d.cu and
// csrc/sweep3d.cu: a block owns a T1 x T2 tile of the (axis-1, axis-2)
// plane, holds W1 x W2 windows of it (the tile and a halo) in shared
// memory, and walks axis 0 plane by plane through a ring of planes.
// P is the kernel's parameter struct; it must have the premultiplied
// 7-point coefficients dinv, dxm, dxp, dym, dyp, dzm, dzp and the grid
// shape n0, n1, n2.  Cells outside the grid hold 0 and are never updated.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int ring(int p, int base, int size) {
  return (p - base + size) % size;
}

// One half-sweep of plane pl in place: cells of interior-index parity
// `parity` (1 = red) are updated from the planes lo (pl-1) and hi (pl+1)
// and their in-plane neighbours, which all have the other colour, as
//   v + om * (dinv * b - v - off),
//   off = ((((dxm*lo + dxp*hi) + dym*ym) + dyp*yp) + dzm*zm) + dzp*zp.
template <int W1, int W2, class P>
__device__ void half_sweep(float* cur, const float* lo, const float* hi,
                           const float* bb, const P& p, float om, int pl,
                           int y0, int x0, int parity) {
  for (int idx = threadIdx.x; idx < W1 * W2; idx += blockDim.x) {
    const int wy = idx / W2, wx = idx - wy * W2;
    const int gy = y0 + wy, gx = x0 + wx;
    if (gy < 0 || gy >= p.n1 || gx < 0 || gx >= p.n2) continue;
    if (((pl + gy + gx) & 1) != parity) continue;
    const float ym = wy > 0 ? cur[idx - W2] : 0.f;
    const float yp = wy < W1 - 1 ? cur[idx + W2] : 0.f;
    const float zm = wx > 0 ? cur[idx - 1] : 0.f;
    const float zp = wx < W2 - 1 ? cur[idx + 1] : 0.f;
    float off = p.dxm * lo[idx];
    off += p.dxp * hi[idx];
    off += p.dym * ym;
    off += p.dyp * yp;
    off += p.dzm * zm;
    off += p.dzp * zp;
    const float v = cur[idx];
    cur[idx] = v + om * (p.dinv * bb[idx] - v - off);
  }
}

// Plane L of u and b into the given window planes; zero outside the grid.
template <int W1, int W2, class P>
__device__ void load_plane(const float* __restrict__ u,
                           const float* __restrict__ b, float* du, float* db,
                           const P& p, int L, int y0, int x0) {
  const bool plane_in = L >= 0 && L < p.n0;
  for (int idx = threadIdx.x; idx < W1 * W2; idx += blockDim.x) {
    const int wy = idx / W2, wx = idx - wy * W2;
    const int gy = y0 + wy, gx = x0 + wx;
    const bool in = plane_in && gy >= 0 && gy < p.n1 && gx >= 0 && gx < p.n2;
    const long g = (static_cast<long>(L) * p.n1 + gy) * p.n2 + gx;
    du[idx] = in ? u[g] : 0.f;
    db[idx] = in ? b[g] : 0.f;
  }
}

// The T1 x T2 tile of window plane `src` (halo H) into plane pl of out.
template <int T1, int T2, int W2, int H, class P>
__device__ void store_plane(const float* src, float* __restrict__ out,
                            const P& p, int pl, int y0, int x0) {
  for (int idx = threadIdx.x; idx < T1 * T2; idx += blockDim.x) {
    const int i = idx / T2, j = idx - i * T2;
    const int gy = y0 + H + i, gx = x0 + H + j;
    if (gy < p.n1 && gx < p.n2)
      out[(static_cast<long>(pl) * p.n1 + gy) * p.n2 + gx] =
          src[(H + i) * W2 + H + j];
  }
}

}  // namespace
