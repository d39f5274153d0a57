// K1 siddon_trace: exact per-material Siddon path lengths of 2-D rays.
//
// Replaces the TPU programs dexct_tpu/ops/siddon.py:trace_paths (a
// fixed-trip lax.scan DDA of nx+ny+1 steps over all rays) and
// dexct_tpu/ops/siddon_fast.py:_trace_dominant_grp (3-bit packed-label
// 16-row windows in ray-plan order).  Both compute the same numbers; the
// TPU forms exist because a TPU has no per-lane control flow and pays per
// gather.
//
// What bounds it on the card: one dependent label load per traversal
// step (latency, not bandwidth: the label grid is 64 KiB at 256^2 and
// stays in L1/L2) plus ~15 float ops; the total work is the number of
// cells the rays actually cross.  Design: one thread per ray walks only
// the steps its ray takes (the loop ends at t_out instead of running
// nx+ny+1 trips), labels are uint8 read through the read-only cache
// (__ldg), the M per-material sums live in registers (M is a template
// parameter; a label adds its segment through an unrolled select so the
// accumulators are never indexed dynamically), and the output is written
// in natural [V, C, M] order, so the TPU path's inverse ray-plan permute
// is gone.  Neighbouring threads are neighbouring channels of one view,
// whose walks have similar lengths and touch neighbouring cells.
//
// The ray setup (siddon_walk.cuh, shared with K17) reproduces
// dexct_tpu/ops/siddon.py:_ray_setup in float32 operation by operation
// (no fused multiply-add, via the _rn intrinsics):
// the entry nudge eps = 1e-6 (dx + dy), the index clamps, the +-1e30
// bounds of axis-parallel rays with |d| <= 1e-12, the tie rule
// take_x = tnx <= tny and t_next clamped into [t, t_out].  Stopping at
// t_out is exact: from there on every segment of the fixed-trip walk is 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "siddon_walk.cuh"

namespace {

using namespace dexct_walk;

template <int M>
__global__ void siddon_trace_kernel(const uint8_t* __restrict__ labels,
                                    const float* __restrict__ src,
                                    const float* __restrict__ dirs,
                                    float* __restrict__ out, long long n_rays,
                                    int nx, int ny, int n_out, float x0,
                                    float y0, float x1, float y1, float dx,
                                    float dy, float eps, int n_steps) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float px = src[2 * r], py = src[2 * r + 1];
  const float ux = dirs[2 * r], uy = dirs[2 * r + 1];

  Walk w = walk_init(px, py, ux, uy, nx, ny, x0, y0, x1, y1, dx, dy, eps);

  float acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.0f;

  for (int k = 0; k < n_steps && w.t < w.t_out; ++k) {
    const float t_next = walk_next(w);
    const float seg = __fsub_rn(t_next, w.t);
    const int lab = __ldg(labels + (w.iy * nx + w.ix));
#pragma unroll
    for (int m = 0; m < M; ++m) acc[m] += (lab == m) ? seg : 0.0f;
    walk_advance(w, t_next, nx, ny);
  }
  float* o = out + r * n_out;
#pragma unroll
  for (int m = 0; m < M; ++m)  // unrolled: acc[] never leaves registers
    if (m < n_out) o[m] = acc[m];
}

template <int M>
void launch(const uint8_t* labels, const float* src, const float* dirs,
            float* out, long long n_rays, int nx, int ny, int n_out,
            float x0, float y0, float x1, float y1, float dx, float dy,
            float eps, int n_steps, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (n_rays + threads - 1) / threads;
  siddon_trace_kernel<M><<<(unsigned)blocks, threads, 0, stream>>>(
      labels, src, dirs, out, n_rays, nx, ny, n_out, x0, y0, x1, y1, dx,
      dy, eps, n_steps);
}

}  // namespace

extern "C" int dexct_siddon_trace(const void* labels, const void* src,
                                  const void* dirs, void* out,
                                  long long n_rays, int nx, int ny,
                                  int n_materials, float x0, float y0,
                                  float x1, float y1, float dx, float dy,
                                  float eps, int n_steps, void* stream) {
  const uint8_t* l = static_cast<const uint8_t*>(labels);
  const float* s = static_cast<const float*>(src);
  const float* d = static_cast<const float*>(dirs);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_rays <= 0) return (int)cudaGetLastError();
#define DEXCT_CASE(MM)                                                      \
  launch<MM>(l, s, d, o, n_rays, nx, ny, n_materials, x0, y0, x1, y1, dx, \
             dy, eps, n_steps, st)
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
