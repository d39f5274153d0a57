// K18 project_3d and K19 backproject_3d: the exact 3-D Siddon projector of a
// continuous volume and its adjoint.
//
// K18 replaces dexct_tpu/ops/conebeam.py:project_volume_3d, the TPU program
// that scans the bounded Nx+Ny+Nz+2-step DDA over geometry only, emitting a
// [n_steps, n_rays] table of (cell index, segment length), and contracts it
// with the volume in one gather-weighted sum (so that jax.linear_transpose
// can transpose it).  K19 replaces that transpose, which XLA lowers to
// scatter-adds of the same table: the adjoint backprojector of
// cone_cg_recon and cone_pwls_recon.
//
// K18: one thread per ray walks only its own steps (the loop ends at t_out
// instead of running the fixed trip, and the [n_steps, n_rays] table of the
// TPU program, 6.4 GB at the cone protocol, never exists), keeps its sum in
// a register, adds __fmul_rn(seg, v) with __fadd_rn step after step -- the
// plain version's operations in its order, so its bits -- and writes it
// once.  What bounds it: the instructions of a step (469.5M steps at the
// cone protocol; the volume, 32 x 256 x 256 floats, 8.4 MB, stays in the
// 50 MB L2).  So a step is lean: the cell is the sum of three 32-bit
// offsets (index x stride), each moved and clamped in one add-min-max, the
// choice of axis is predicated, the max with t is taken only while a
// crossing lies behind t (the first steps), and the exit is tested once
// every 16 steps (steps past t_out add +0): 309 instructions per 16 steps
// against the 64-bit walk's 42 a step.  The gathers: a warp's 32
// neighbouring channels enter the grid through one face and, step for
// step, lie spread along it; so each warp reads the volume in the layout
// whose fast axis runs along that face -- as it is, [nz, ny, nx], for rays
// entering through a y face, its copy with x and y swapped, [nz, nx, ny]
// (swap_xy_kernel, each call), through an x face -- by a vote of its rays.
// The walk (walk32_run, step32), its set-up, the vote and the swap are
// siddon_walk_3d.cuh's, shared with K10 (K19's build walks use walk_step).
//
// K19 was the same walk with a float32 atomicAdd of seg * y[ray] into the
// volume per step: 4.1 ms against K18's 0.91 ms on the same walk at the
// cone protocol (H100, 700 W), the atomics alone costing 4.5x, and its
// sums taken in no fixed order.  It is now a gather over the walk
// transposed:
//
// - The table (built once per rays, grid and n_steps by the three build
//   kernels below, and cached by the iterative loops): the walk's nonzero
//   (ray, segment) entries grouped by cell, each cell's entries in (step,
//   ray) order -- the order in which the plain version's index_add_ adds
//   them, one step after another -- as 8-byte records in a sliced ELLPACK
//   of 32 cells a slice: entry j of cell c at offset[c / 32] + 32 j +
//   c % 32, so that entry j of 32 neighbouring cells is 256 contiguous
//   bytes, each slice padded to its longest run (14 % at the cone
//   protocol).  The build: a counting walk (integer atomics; their totals
//   do not depend on their order), the slices' offsets (a scan in the
//   wrapper, which reads the table's size back), a filling walk into the
//   table itself (a cursor per cell, so in no fixed order; bounded by its
//   scattered stores, it takes the rays detector row by row) and a sort of
//   each cell's run in place, by its (step, ray) key, a warp a cell in
//   shared memory.  ~46 ms and 4.3 GB at the cone protocol.
// - The gather: one thread per cell sums __fmul_rn(seg, y[ray]) with
//   __fadd_rn over its entries in table order from 0, and writes its cell
//   once: no atomics, no zero fill, and the same operations in the same
//   order as the plain version, so the same bits.
//
// What bounds the gather: bytes.  It reads the table once a call (8 bytes a
// slot: 4.3 GB at the cone protocol, 1.29 ms at 3.35 TB/s, the floor of
// this design, which it reaches within ~20 %; read with streaming loads so
// that y, 5.9 MB, keeps its place in L2), and y[ray] per entry from L2.
// The function's own bound stays K18's: the bytes of y, the rays and the
// volume, and the walk's operations (the table is this design's
// intermediate, not the function's input).

#include <cuda_runtime.h>

#include "siddon_walk_3d.cuh"

namespace {

using dexct_walk3d::Grid;
using dexct_walk3d::kExitEvery;
using dexct_walk3d::Walk;
using dexct_walk3d::Walk32;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    project_3d_kernel(const float* __restrict__ vol,
                      const float* __restrict__ vol_yx,
                      const float* __restrict__ src,
                      const float* __restrict__ dirs,
                      float* __restrict__ out, long long n_rays, Grid g,
                      int n_steps) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const bool live = r < n_rays;
  const long long q = live ? r : 0;
  const float px = src[3 * q], py = src[3 * q + 1], pz = src[3 * q + 2];
  const float ux = dirs[3 * q], uy = dirs[3 * q + 1], uz = dirs[3 * q + 2];
  const Walk w0 = dexct_walk3d::walk_start(g, px, py, pz, ux, uy, uz);
  const bool x_face = dexct_walk3d::enters_by_x(g, px, py, ux, uy);
  const unsigned lanes = __ballot_sync(0xffffffffu, live);
  const unsigned votes = __ballot_sync(0xffffffffu, live && x_face);
  if (!live) return;
  const bool swapped = 2 * __popc(votes) > __popc(lanes);
  const float* v = swapped ? vol_yx : vol;
  Walk32 w = swapped ? dexct_walk3d::walk32(w0, g, g.ny, 1)
                     : dexct_walk3d::walk32(w0, g, 1, g.nx);
  // a product, then a sum, each rounded: the plain version's operations
  float acc = 0.0f;
  auto gather = [&](float seg, int o) {
    acc = __fadd_rn(acc, __fmul_rn(seg, __ldg(v + o)));
  };
  dexct_walk3d::walk32_run<kExitEvery>(w, n_steps, gather);
  out[r] = acc;
}

// The build's walks, one thread per ray of the block: kFill false counts
// each cell's nonzero segments into count; kFill true writes each as one
// 8-byte record (key, seg bits) into its cell's column of the table, at
// the next free entry (the cursor count, zeroed), key = step * n_rays +
// ray (< 2^32 - 1: the wrapper splits the views until it fits).  What
// bounds the filling walk is its scattered 8-byte stores, each a partial
// write of a line; so the threads take the rays [views, rows, cols] row
// by row (view, then column, within a row): the rays in flight then come
// from a few detector rows, which cross a band of slices, and the lines
// being filled fit the L2 better.  Zero-length segments (ties of two
// crossings) add +-0 in the plain version, which leaves every sum as it
// is, so they are left out.
template <bool kFill>
__global__ void transpose_walk_kernel(const float* __restrict__ src,
                                      const float* __restrict__ dirs,
                                      int* __restrict__ count,
                                      const long long* __restrict__ offset,
                                      int2* __restrict__ rec,
                                      long long n_rays, int rows, int cols,
                                      Grid g, int n_steps) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= n_rays) return;
  const long long per_row = n_rays / rows, row = t / per_row;
  const long long rem = t - row * per_row;
  const long long r = (rem / cols * rows + row) * cols + rem % cols;
  Walk w = dexct_walk3d::walk_start(g, src[3 * r], src[3 * r + 1],
                                    src[3 * r + 2], dirs[3 * r],
                                    dirs[3 * r + 1], dirs[3 * r + 2]);
  // kFill: each record is stored one nonzero step late, so that its
  // cursor's atomic returns while the walk takes the next step
  long long at = -1;
  int pj = 0;
  int2 pend = make_int2(0, 0);
  for (int k = 0; k < n_steps && w.t < w.t_out; ++k) {
    long long cell;
    const float seg = dexct_walk3d::walk_step(w, g, cell);
    if (seg == 0.0f) continue;
    if (kFill) {
      const int j = atomicAdd(count + cell, 1);
      if (at >= 0) rec[at + 32LL * pj] = pend;
      at = offset[cell >> 5] + (cell & 31);
      pj = j;
      pend = make_int2((int)(unsigned)((unsigned long long)k * n_rays + r),
                       __float_as_int(seg));
    } else {
      atomicAdd(count + cell, 1);
    }
  }
  if (kFill && at >= 0) rec[at + 32LL * pj] = pend;
}

// The sort, in place: a block of kw warps takes kw neighbouring cells of
// one slice, loads their columns into shared memory (cap records a warp,
// cap the longest run), and each warp puts its cell's records in key
// order: each chunk of 32 is sorted across the lanes (a bitonic network of
// shuffles), then a record's rank is its place in its chunk plus, for
// every other chunk, the count of smaller keys there (a binary search).
// Keys are unique.  Each record goes back to the entry of its rank as
// (ray r0 + key % n_rays, seg bits); the slice's padding entries of the
// cell get (0, 0).
__global__ void transpose_sort_kernel(const int* __restrict__ length,
                                      const long long* __restrict__ offset,
                                      int2* __restrict__ rec, int cap,
                                      long long r0, long long n_rays) {
  extern __shared__ int2 col_all[];
  const int kw = blockDim.x >> 5, w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long c0 = (long long)blockIdx.x * kw;  // kw divides 32
  const long long s = c0 >> 5;
  const long long first = offset[s] + (c0 & 31);
  const int longest = (int)((offset[s + 1] - offset[s]) >> 5);
  for (int i = threadIdx.x; i < kw * longest; i += blockDim.x) {
    const int j = i / kw, v = i % kw;
    if (j < length[c0 + v]) col_all[v * cap + j] = rec[first + 32LL * j + v];
  }
  __syncthreads();
  int2* col = col_all + w * cap;
  const int n = length[c0 + w];
  for (int i0 = 0; i0 < n; i0 += 32) {
    const bool has = i0 + lane < n;
    int2 e = has ? col[i0 + lane] : make_int2(-1, 0);
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const int ok = __shfl_xor_sync(0xffffffffu, e.x, stride);
        const int ov = __shfl_xor_sync(0xffffffffu, e.y, stride);
        const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
        if (keep_min ? (unsigned)ok < (unsigned)e.x
                     : (unsigned)ok > (unsigned)e.x)
          e = make_int2(ok, ov);
      }
    }
    if (has) col[i0 + lane] = e;
  }
  __syncwarp();
  const long long base = first + w;
  for (int i = lane; i < n; i += 32) {
    const int2 e = col[i];
    const unsigned key = (unsigned)e.x;
    const int i0 = i & ~31;
    int rank = i - i0;
    for (int j0 = 0; j0 < n; j0 += 32) {
      if (j0 == i0) continue;
      int lo = 0, hi = min(32, n - j0);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if ((unsigned)col[j0 + mid].x < key) lo = mid + 1; else hi = mid;
      }
      rank += lo;
    }
    rec[base + 32LL * rank] =
        make_int2((int)(r0 + (long long)(key % (unsigned long long)n_rays)),
                  e.y);
  }
  for (int j = n + lane; j < longest; j += 32)
    rec[base + 32LL * j] = make_int2(0, 0);
}

// K19: one thread per cell, its entries summed in table order.
constexpr int kUnroll = 8;

__global__ void backproject_3d_gather_kernel(
    const float* __restrict__ y, const int* __restrict__ length,
    const long long* __restrict__ offset, const int2* __restrict__ rec,
    float* __restrict__ vol, long long n_cells, int accumulate) {
  const long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (c >= n_cells) return;
  const int n = length[c];
  const int2* rp = rec + offset[c >> 5] + (c & 31);
  float acc = 0.0f;
  int j = 0;
  for (; j + kUnroll <= n; j += kUnroll) {
    int2 e[kUnroll];
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) e[u] = __ldcs(rp + 32LL * (j + u));
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(y + e[u].x);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      acc = __fadd_rn(acc, __fmul_rn(__int_as_float(e[u].y), v[u]));
  }
  for (; j < n; ++j) {
    const int2 e = __ldcs(rp + 32LL * j);
    acc = __fadd_rn(acc, __fmul_rn(__int_as_float(e.y), __ldg(y + e.x)));
  }
  vol[c] = accumulate ? __fadd_rn(vol[c], acc) : acc;
}

}  // namespace

// vol [nz, ny, nx] -> out [nz, nx, ny]
extern "C" int dexct_swap_xy(const void* vol, void* out, int nx, int ny,
                             int nz, void* stream) {
  return (int)dexct_walk3d::launch_swap_xy(
      static_cast<const float*>(vol), static_cast<float*>(out), nx, ny, nz,
      static_cast<cudaStream_t>(stream));
}

// vol [nz, ny, nx], vol_yx its copy [nz, nx, ny] (dexct_swap_xy), src/dirs
// [n_rays, 3] -> out [n_rays]
extern "C" int dexct_project_3d(const void* vol, const void* vol_yx,
                                const void* src, const void* dirs, void* out,
                                long long n_rays, int nx, int ny, int nz,
                                float x0, float y0, float z0, float x1,
                                float y1, float z1, float dx, float dy,
                                float dz, float eps, int n_steps,
                                void* stream) {
  if (n_rays <= 0) return (int)cudaGetLastError();
  const Grid g{nx, ny, nz, x0, y0, z0, x1, y1, z1, dx, dy, dz, eps};
  const long long blocks = (n_rays + kThreads - 1) / kThreads;
  project_3d_kernel<<<(unsigned)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vol), static_cast<const float*>(vol_yx),
      static_cast<const float*>(src), static_cast<const float*>(dirs),
      static_cast<float*>(out), n_rays, g, n_steps);
  return (int)cudaGetLastError();
}

// The build's walks over src/dirs [views, rows, cols, 3] (n_rays in all):
// fill 0 counts into count [cells] (zeroed by the caller; offset, rec
// unused); fill 1 writes the records rec [slots] (key, seg bits) into the
// columns of the slices at offset [cells / 32 + 1] through the cursors
// count [cells] (zeroed).
extern "C" int dexct_cone_transpose_walk(
    const void* src, const void* dirs, void* count, const void* offset,
    void* rec, long long n_rays, int rows, int cols, int nx, int ny, int nz,
    float x0, float y0, float z0, float x1, float y1, float z1, float dx,
    float dy, float dz, float eps, int n_steps, int fill, void* stream) {
  if (n_rays <= 0) return (int)cudaGetLastError();
  if (rows <= 0 || cols <= 0 || n_rays % ((long long)rows * cols) != 0)
    return (int)cudaErrorInvalidValue;
  const Grid g{nx, ny, nz, x0, y0, z0, x1, y1, z1, dx, dy, dz, eps};
  const unsigned blocks = (unsigned)((n_rays + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(src);
  const float* d = static_cast<const float*>(dirs);
  int* cnt = static_cast<int*>(count);
  const long long* off = static_cast<const long long*>(offset);
  if (fill) {
    transpose_walk_kernel<true><<<blocks, kThreads, 0, st>>>(
        s, d, cnt, off, static_cast<int2*>(rec), n_rays, rows, cols, g,
        n_steps);
  } else {
    transpose_walk_kernel<false><<<blocks, kThreads, 0, st>>>(
        s, d, cnt, off, nullptr, n_rays, rows, cols, g, n_steps);
  }
  return (int)cudaGetLastError();
}

// length [cells], offset [cells / 32 + 1], rec [slots] sorted in place
// (cells a multiple of 32; longest the longest run, at most
// kMaxShared / 8 records)
constexpr int kMaxShared = 232448;

extern "C" int dexct_cone_transpose_sort(const void* length,
                                         const void* offset, void* rec,
                                         long long n_cells, int longest,
                                         long long r0, long long n_rays,
                                         void* stream) {
  if (n_cells <= 0) return (int)cudaGetLastError();
  const int cap = longest > 0 ? longest : 1;
  if ((long long)cap * 8 > kMaxShared) return (int)cudaErrorInvalidValue;
  // several blocks an SM, so that one block's loads overlap another's sort
  int kw = 8;
  while (kw > 1 && (long long)kw * cap * 8 > kMaxShared) kw >>= 1;
  const size_t smem = (size_t)kw * cap * 8;
  cudaError_t err = cudaFuncSetAttribute(
      transpose_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  transpose_sort_kernel<<<(unsigned)(n_cells / kw), kw * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(length), static_cast<const long long*>(offset),
      static_cast<int2*>(rec), cap, r0, n_rays);
  return (int)cudaGetLastError();
}

// y [rays], the table (length [cells rounded up to 32], offset, rec
// [slots] of (ray, seg bits)) -> vol [n_cells] = A^T y (accumulate 0), or
// vol += A^T y (accumulate 1)
extern "C" int dexct_backproject_3d(const void* y, const void* length,
                                    const void* offset, const void* rec,
                                    void* vol, long long n_cells,
                                    int accumulate, void* stream) {
  if (n_cells <= 0) return (int)cudaGetLastError();
  const long long blocks = (n_cells + kThreads - 1) / kThreads;
  backproject_3d_gather_kernel<<<(unsigned)blocks, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const int*>(length),
      static_cast<const long long*>(offset), static_cast<const int2*>(rec),
      static_cast<float*>(vol), n_cells, accumulate);
  return (int)cudaGetLastError();
}
