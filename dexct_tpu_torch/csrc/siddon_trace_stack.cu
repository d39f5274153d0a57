// K17 siddon_trace_stack: exact per-material Siddon paths of 2-D rays
// through every slice of a label stack, in one walk per ray.
//
// Replaces the TPU program dexct_tpu/ops/siddon_fast.py:_trace_dominant_grp
// with n_slices=2, which dexct_tpu/pipeline/zstack.py:_inject_pair_paths
// runs outside the per-slice vmap: it packs the 3-bit labels of two slices
// into one 16-row gather window, because a TPU pays per gather, and decodes
// both slices from each fetched window.  The paths of a ray depend on the
// slice only through the labels of the cells it crosses; the cells and the
// segment lengths are the same in every slice.
//
// What bounds it on the card: as for K1, one dependent label load per
// traversal step (latency; the labels stay in L1/L2) plus the walk's ~15
// float operations, and here also Z x M selects and adds per step.  Design:
// one thread per ray walks the DDA once (K1's setup, tie rule and FMA-free
// operations, siddon_walk.cuh) for a chunk of Z slices.  The labels are
// repacked z-minor, [n_chunks, Ny, Nx, Z] uint8, so one step reads all Z
// labels of its cell in one 1-, 2-, 4- or 8-byte load; the Z x M sums live
// in registers (M and Z are template parameters, Z x M <= 64, so the
// accumulators are never indexed dynamically); blockIdx.y runs over the
// slice chunks of a larger stack.  Padding slices carry label 255, which
// no material takes.  The output is slice-major [Nz, n_rays, n_out], so
// each slice's paths are contiguous for K2.  Each slice of the output is
// bitwise equal to K1 on that slice: the same segments are added to the
// same sums in the same order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "siddon_walk.cuh"

namespace {

using namespace dexct_walk;

// the Z labels of cell c, slice z in byte z (little-endian)
template <int Z>
__device__ __forceinline__ unsigned long long load_cell(const uint8_t* p,
                                                        long long c);
template <>
__device__ __forceinline__ unsigned long long load_cell<1>(const uint8_t* p,
                                                           long long c) {
  return __ldg(p + c);
}
template <>
__device__ __forceinline__ unsigned long long load_cell<2>(const uint8_t* p,
                                                           long long c) {
  return __ldg(reinterpret_cast<const unsigned short*>(p) + c);
}
template <>
__device__ __forceinline__ unsigned long long load_cell<4>(const uint8_t* p,
                                                           long long c) {
  return __ldg(reinterpret_cast<const unsigned int*>(p) + c);
}
template <>
__device__ __forceinline__ unsigned long long load_cell<8>(const uint8_t* p,
                                                           long long c) {
  return __ldg(reinterpret_cast<const unsigned long long*>(p) + c);
}

template <int M, int Z>
__global__ void siddon_trace_stack_kernel(
    const uint8_t* __restrict__ labels, const float* __restrict__ src,
    const float* __restrict__ dirs, float* __restrict__ out,
    long long n_rays, int nx, int ny, int nz, int n_out, float x0, float y0,
    float x1, float y1, float dx, float dy, float eps, int n_steps) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const int chunk = blockIdx.y;
  const uint8_t* lab = labels + (size_t)chunk * nx * ny * Z;
  const float px = src[2 * r], py = src[2 * r + 1];
  const float ux = dirs[2 * r], uy = dirs[2 * r + 1];

  Walk w = walk_init(px, py, ux, uy, nx, ny, x0, y0, x1, y1, dx, dy, eps);

  float acc[Z][M];
#pragma unroll
  for (int z = 0; z < Z; ++z)
#pragma unroll
    for (int m = 0; m < M; ++m) acc[z][m] = 0.0f;

  for (int k = 0; k < n_steps && w.t < w.t_out; ++k) {
    const float t_next = walk_next(w);
    const float seg = __fsub_rn(t_next, w.t);
    const unsigned long long cell =
        load_cell<Z>(lab, (long long)(w.iy * nx + w.ix));
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      const int l = (int)((cell >> (8 * z)) & 0xffu);
#pragma unroll
      for (int m = 0; m < M; ++m) acc[z][m] += (l == m) ? seg : 0.0f;
    }
    walk_advance(w, t_next, nx, ny);
  }
#pragma unroll
  for (int z = 0; z < Z; ++z) {
    const int zg = chunk * Z + z;
    if (zg < nz) {
      float* o = out + ((size_t)zg * n_rays + r) * n_out;
#pragma unroll
      for (int m = 0; m < M; ++m)
        if (m < n_out) o[m] = acc[z][m];
    }
  }
}

template <int M, int Z>
int launch(const void* labels, const void* src, const void* dirs, void* out,
           long long n_rays, int nx, int ny, int nz, int n_out, float x0,
           float y0, float x1, float y1, float dx, float dy, float eps,
           int n_steps, void* stream) {
  const int threads = 256;
  const long long blocks = (n_rays + threads - 1) / threads;
  const dim3 grid((unsigned)blocks, (unsigned)((nz + Z - 1) / Z));
  siddon_trace_stack_kernel<M, Z>
      <<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(labels),
          static_cast<const float*>(src), static_cast<const float*>(dirs),
          static_cast<float*>(out), n_rays, nx, ny, nz, n_out, x0, y0, x1,
          y1, dx, dy, eps, n_steps);
  return (int)cudaGetLastError();
}

template <int M>
int launch_m(int z_chunk, const void* labels, const void* src,
             const void* dirs, void* out, long long n_rays, int nx, int ny,
             int nz, int n_out, float x0, float y0, float x1, float y1,
             float dx, float dy, float eps, int n_steps, void* stream) {
#define DEXCT_Z(ZZ)                                                        \
  return launch<M, ZZ>(labels, src, dirs, out, n_rays, nx, ny, nz, n_out, \
                       x0, y0, x1, y1, dx, dy, eps, n_steps, stream)
  switch (z_chunk) {
    case 1: DEXCT_Z(1);
    case 2: DEXCT_Z(2);
    case 4:
      if constexpr (4 * M <= 64) { DEXCT_Z(4); }
      break;
    case 8:
      if constexpr (8 * M <= 64) { DEXCT_Z(8); }
      break;
    default:
      break;
  }
#undef DEXCT_Z
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// labels [ceil(nz / z_chunk), ny, nx, z_chunk] uint8 (z-minor); src, dirs
// [n_rays, 2]; out [nz, n_rays, n_materials]
extern "C" int dexct_siddon_trace_stack(
    const void* labels, const void* src, const void* dirs, void* out,
    long long n_rays, int nx, int ny, int nz, int n_materials, int z_chunk,
    float x0, float y0, float x1, float y1, float dx, float dy, float eps,
    int n_steps, void* stream) {
  if (n_rays <= 0 || nz <= 0) return (int)cudaGetLastError();
  if ((nz + z_chunk - 1) / z_chunk > 65535) return (int)cudaErrorInvalidValue;
#define DEXCT_M(MM)                                                          \
  return launch_m<MM>(z_chunk, labels, src, dirs, out, n_rays, nx, ny, nz,  \
                      n_materials, x0, y0, x1, y1, dx, dy, eps, n_steps,    \
                      stream)
  switch (n_materials) {
    case 1: DEXCT_M(1);
    case 2: DEXCT_M(2);
    case 3: DEXCT_M(3);
    case 4: DEXCT_M(4);
    case 5: DEXCT_M(5);
    case 6: DEXCT_M(6);
    case 7: DEXCT_M(7);
    case 8: DEXCT_M(8);
    default:
      if (n_materials <= 16) DEXCT_M(16);
      if (n_materials <= 32) DEXCT_M(32);
      return (int)cudaErrorInvalidValue;
  }
#undef DEXCT_M
}
