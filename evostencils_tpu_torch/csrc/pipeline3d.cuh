// The plane pipeline of the 3D kernels, shared by csrc/wavefront3d.cu (the
// V(2,1) legs), csrc/sweep3d.cu (the standalone red-black sweep) and
// csrc/leg3d.cu (the standalone residual restriction).
//
// A block owns a T x T tile of the (axis-1, axis-2) plane, holds a W x W
// window of it (W odd: the tile and a halo) in shared memory, and walks a
// chunk of axis 0 plane by plane.  At step s plane s arrives, planes s+1
// and s+2 of u and b are in flight (cp.async, zero-filled outside the
// grid), and the kernel's stages run on planes behind s, LAG planes apart,
// with one barrier a step.  Each thread owns two neighbouring cells of the
// window, 2t and 2t+1, and keeps their axis-0 columns of u in registers;
// a window plane is stored split, its even cells first, then its odd
// ones, so that a cell's in-plane neighbours lie in the other half and a
// warp's lanes read consecutive addresses.  With an even y0 + x0, cell w
// is red on plane P exactly when P + w is odd (interior index i is node
// i+1 on every axis: red, an even node sum, is an ODD interior-index sum in
// 3D), so a thread's two cells have one colour each on every plane.
// Cells outside the grid hold 0 and are never updated.

#pragma once

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int LAG = 2;                   // planes between a step's stages
constexpr int AHEAD = 2;                 // planes in flight past plane s
constexpr int MAX_DEVICES = 64;          // cards an opt-in flag covers

// Ring slots: the slot of plane s advances by one a step.
template <int R>
__device__ __forceinline__ int next_slot(int slot) {
  return slot + 1 == R ? 0 : slot + 1;
}

// The slot d planes before (d > 0) or after (d < 0) the plane in `slot`.
template <int R>
__device__ __forceinline__ int slot_back(int slot, int d) {
  const int k = slot - d;
  return k < 0 ? k + R : (k >= R ? k - R : k);
}

// Compile-time arguments of the step lambdas, and the pick of one of two
// objects by a compile-time flag.
template <bool V>
struct Bool {
  static constexpr bool value = V;
};
template <int V>
struct Int {
  static constexpr int value = V;
};

template <bool F, class A>
__device__ __forceinline__ A& pick(A& a, A& b) {
  if constexpr (F) return a;
  else return b;
}

// A cell's in-plane neighbours and its value of b.
struct Around {
  float ym, yp, zm, zp, b;
};

// The in-plane neighbours of thread t's even (EVEN) or odd cell in the
// split window plane pu (rows of W cells, HALF even cells first), which
// are all of the other parity, and b's value at the cell in plane pb.
template <bool EVEN, int W, int HALF>
__device__ __forceinline__ Around around(const float* pu, const float* pb,
                                         int t) {
  if constexpr (EVEN) {
    const float* q = pu + HALF + t;          // cell 2t+1
    return {q[-(W + 1) / 2], q[(W - 1) / 2], q[-1], q[0], pb[t]};
  } else {
    const float* q = pu + t;                 // cell 2t
    return {q[-(W - 1) / 2], q[(W + 1) / 2], q[0], q[1], pb[HALF + t]};
  }
}

// One cell's damped update in the TPU kernels' premultiplied form,
//   v + om * (dinv * b - v - off),
//   off = ((((dxm*lo + dxp*hi) + dym*ym) + dyp*yp) + dzm*zm) + dzp*zp,
// with lo, v, hi the cell's axis-0 column and ym .. zp its in-plane
// neighbours; P holds dinv and the d_k = c_k * dinv.
template <class P>
__device__ __forceinline__ float relax(float lo, float v, float hi,
                                       const Around& n, float om,
                                       const P& p) {
  float off = p.dxm * lo;
  off += p.dxp * hi;
  off += p.dym * n.ym;
  off += p.dyp * n.yp;
  off += p.dzm * n.zm;
  off += p.dzp * n.zp;
  return v + om * (p.dinv * n.b - v - off);
}

// A cell's residual b - A u, A u summed
// c*v + cxm*lo + cxp*hi + cym*ym + cyp*yp + czm*zm + czp*zp left to right
// (leg3d.py:125-131).
template <class P>
__device__ __forceinline__ float residual(float lo, float v, float hi,
                                          const Around& n, const P& p) {
  float au = p.c * v;
  au += p.cxm * lo;
  au += p.cxp * hi;
  au += p.cym * n.ym;
  au += p.cyp * n.yp;
  au += p.czm * n.zm;
  au += p.czp * n.zp;
  return n.b - au;
}

// A window cell a thread owns: its offset g in a grid plane, an extra
// index (a restricting kernel's residual cell, the up-leg's coarse window
// cell), and packed: its distance to the window edge (bits 0-3, capped at
// 15), whether it lies in the grid (bit 5), in the window (bit 6), in the
// tile (bit 7) and in the tile and one more row and column (bit 8), and
// whether its axis-1 and axis-2 indices are even (bits 9, 10).
struct Cell {
  int g, aux, meta;
  __device__ int dist() const { return meta & 15; }
  __device__ bool grid() const { return meta & 32; }
  __device__ bool own() const { return meta & 64; }
  __device__ bool tile() const { return meta & 128; }
  __device__ bool tile1() const { return meta & 256; }
  __device__ bool even_y() const { return meta & 512; }
  __device__ bool even_x() const { return meta & 1024; }
};

// Window cell w of a W x W window at (y0, x0) whose T x T tile starts LO
// cells in.  aux: with RES, the cell's index in the (T+1) x (T+1) residual
// region at the tile's start; else its index in the up-leg's coarse window
// of (W+1)/2 + 1 cells a row, which starts at (cy0, cx0).
template <int W, int LO, int T, bool RES, class P>
__device__ __forceinline__ Cell make_cell(int w, int y0, int x0, int cy0,
                                          int cx0, const P& p) {
  constexpr int CW = (W + 1) / 2 + 1;
  const int wy = w / W, wx = w - wy * W;
  const int gy = y0 + wy, gx = x0 + wx;
  const int ty = wy - LO, tx = wx - LO;
  const bool own = w < W * W;
  const bool grid = own && gy >= 0 && gy < p.n1 && gx >= 0 && gx < p.n2;
  const bool tile = grid && ty >= 0 && ty < T && tx >= 0 && tx < T;
  const bool tile1 = grid && ty >= 0 && ty <= T && tx >= 0 && tx <= T;
  const int dist =
      own ? min(min(min(wy, W - 1 - wy), min(wx, W - 1 - wx)), 15) : 0;
  const int aux = RES ? ty * (T + 1) + tx
                      : (((gy - 1) >> 1) - cy0) * CW + ((gx - 1) >> 1) - cx0;
  return {gy * p.n2 + gx, aux,
          dist | grid << 5 | own << 6 | tile << 7 | tile1 << 8 |
              !(gy & 1) << 9 | !(gx & 1) << 10};
}

// Start the copies of plane pl's window of u and b (split planes of HALF
// even cells, then the odd ones) into du and db: thread t's cells 2t and
// 2t+1, zero outside the grid and outside [pa, pb].
template <int HALF>
__device__ __forceinline__ void fetch_plane(const Cell& ce, const Cell& co,
                                            const float* __restrict__ u,
                                            const float* __restrict__ b,
                                            float* du, float* db, int pl,
                                            int pa, int pb, long plane) {
  const int t = threadIdx.x;
  const bool plane_in = pl >= pa && pl <= pb;
  const long base = plane_in ? pl * plane : 0;
  bool in = plane_in && ce.grid();
  long g = in ? base + ce.g : 0;
  copy_async(du + t, u + g, in);
  copy_async(db + t, b + g, in);
  if (co.own()) {
    in = plane_in && co.grid();
    g = in ? base + co.g : 0;
    copy_async(du + HALF + t, u + g, in);
    copy_async(db + HALF + t, b + g, in);
  }
  copy_commit();
}

// After the second step of a pair, a column's planes move down two slots.
template <int N>
__device__ __forceinline__ void shift2(float (&c)[N]) {
#pragma unroll
  for (int j = 0; j + 2 < N; ++j) c[j] = c[j + 2];
}

// Blocks over (axis 2, axis 1) tiles of edge `tile` and axis-0 chunks: as
// many even-sized chunks as fill about one wave of `per_sm` resident
// blocks on every SM, but no chunk under `min_chunk` planes
// (ops/kernels/wavefront3d.py chunk_rule mirrors this rule).  Sets *chunk.
inline dim3 pipeline_blocks(int n0, int n1, int n2, int tile, int per_sm,
                            int min_chunk, int* chunk, cudaError_t* err) {
  int device = 0, sms = 0;
  *err = cudaGetDevice(&device);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device);
  const int tiles1 = (n1 + tile - 1) / tile, tiles2 = (n2 + tile - 1) / tile;
  int chunks = (sms * per_sm) / (tiles1 * tiles2);
  chunks = chunks < 1 ? 1 : chunks;
  const int max_chunks = (n0 + min_chunk - 1) / min_chunk;
  chunks = chunks > max_chunks ? max_chunks : chunks;
  int c = (n0 + chunks - 1) / chunks;
  c += c & 1;
  *chunk = c;
  return dim3(tiles2, tiles1, (n0 + c - 1) / c);
}

// The opt-in to more than 48 KB of dynamic shared memory, made once per
// process and card for a kernel: `done` holds that kernel's flags.
template <class K>
cudaError_t opt_in_smem(K kernel, int bytes, bool (&done)[MAX_DEVICES]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || bytes <= 48 * 1024) return err;
  if (device < MAX_DEVICES && done[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && device < MAX_DEVICES) done[device] = true;
  return err;
}

// What the card makes of a pipeline kernel: info receives the tile edge,
// the window cells before and after the tile, the axis-0 warm-up, the lag
// per stage, the fewest planes a chunk holds, threads per block, resident
// blocks per SM, registers and local memory (spills) per thread, and
// dynamic shared memory per block (11 ints; ops/kernels/wavefront3d.py
// INFO_KEYS names them).
inline cudaError_t pipeline_info(const void* kernel, int tile, int lo,
                                 int hi, int warm, int min_chunk,
                                 int threads, int smem, int* info) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const int values[] = {tile,        lo,
                        hi,          warm,
                        LAG,         min_chunk,
                        threads,     blocks,
                        attr.numRegs, static_cast<int>(attr.localSizeBytes),
                        smem};
  for (int k = 0; k < 11; ++k) info[k] = values[k];
  return cudaSuccess;
}

}  // namespace
