// K10 siddon_trace_3d: exact per-material Siddon path lengths of 3-D rays.
//
// Replaces the TPU programs of dexct_tpu/ops/conebeam.py that the fused cone
// pipeline traces with: _trace_cone_dominant (a dominant-axis walk over
// 3-bit packed per-z-layer label windows in ray-plan order) and its bundled
// form (one shared-window gather for 8 adjacent channels), and the plain
// fixed-trip trace_paths_3d (an Nx+Ny+Nz+2-step lax.scan).  They compute
// the same numbers; the packed forms exist because a TPU pays per gather.
//
// What bounds it on the card: one dependent label load per traversal step
// (latency: the uint8 volume, 3 MB for 256 x 256 x 48, stays in L2) plus
// ~20 float ops; the total work is the number of voxels the rays cross.
// Design: one thread per ray walks only its own steps (the loop ends at
// t_out instead of running the fixed trip), labels are uint8 read through
// the read-only cache, the M per-material sums live in registers (M is a
// template parameter, a label adds its segment through an unrolled select),
// and the output is written in natural [V, R, C, M] order, so the TPU
// path's inverse ray-plan permute is gone.  Neighbouring threads are
// neighbouring channels of one detector row, whose walks are alike.
//
// The ray set-up and step are siddon_walk_3d.cuh's (shared with K18 and
// K19): trace_paths_3d's axis_setup / cell_and_crossing in float32
// operation by operation.  Stopping at t_out is exact: from there on every
// segment of the fixed-trip walk is 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "siddon_walk_3d.cuh"

namespace {

using dexct_walk3d::Grid;
using dexct_walk3d::Walk;

template <int M>
__global__ void siddon_trace_3d_kernel(
    const uint8_t* __restrict__ labels, const float* __restrict__ src,
    const float* __restrict__ dirs, float* __restrict__ out, long long n_rays,
    int n_out, Grid g, int n_steps) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  Walk w = dexct_walk3d::walk_start(g, src[3 * r], src[3 * r + 1],
                                    src[3 * r + 2], dirs[3 * r],
                                    dirs[3 * r + 1], dirs[3 * r + 2]);
  float acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.0f;

  for (int k = 0; k < n_steps && w.t < w.t_out; ++k) {
    long long cell;
    const float seg = dexct_walk3d::walk_step(w, g, cell);
    const int lab = __ldg(labels + cell);
#pragma unroll
    for (int m = 0; m < M; ++m) acc[m] += (lab == m) ? seg : 0.0f;
  }
  float* o = out + r * n_out;
#pragma unroll
  for (int m = 0; m < M; ++m)  // unrolled: acc[] never leaves registers
    if (m < n_out) o[m] = acc[m];
}

template <int M>
void launch(const uint8_t* labels, const float* src, const float* dirs,
            float* out, long long n_rays, int n_out, const Grid& g,
            int n_steps, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (n_rays + threads - 1) / threads;
  siddon_trace_3d_kernel<M><<<(unsigned)blocks, threads, 0, stream>>>(
      labels, src, dirs, out, n_rays, n_out, g, n_steps);
}

}  // namespace

extern "C" int dexct_siddon_trace_3d(
    const void* labels, const void* src, const void* dirs, void* out,
    long long n_rays, int nx, int ny, int nz, int n_materials, float x0,
    float y0, float z0, float x1, float y1, float z1, float dx, float dy,
    float dz, float eps, int n_steps, void* stream) {
  const uint8_t* l = static_cast<const uint8_t*>(labels);
  const float* s = static_cast<const float*>(src);
  const float* d = static_cast<const float*>(dirs);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_rays <= 0) return (int)cudaGetLastError();
  const Grid g{nx, ny, nz, x0, y0, z0, x1, y1, z1, dx, dy, dz, eps};
#define DEXCT_CASE(MM) \
  launch<MM>(l, s, d, o, n_rays, n_materials, g, n_steps, st)
  switch (n_materials) {
    case 1: DEXCT_CASE(1); break;
    case 2: DEXCT_CASE(2); break;
    case 3: DEXCT_CASE(3); break;
    case 4: DEXCT_CASE(4); break;
    case 5: DEXCT_CASE(5); break;
    case 6: DEXCT_CASE(6); break;
    case 7: DEXCT_CASE(7); break;
    case 8: DEXCT_CASE(8); break;
    default:
      if (n_materials <= 16) {
        DEXCT_CASE(16);
      } else if (n_materials <= 32) {
        DEXCT_CASE(32);
      } else {
        return (int)cudaErrorInvalidValue;
      }
  }
#undef DEXCT_CASE
  return (int)cudaGetLastError();
}
