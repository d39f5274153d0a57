// K6 parallel_backproject: parallel-beam backprojection of K images over
// the pixels of the scan's FOV disc.
//
// Replaces the TPU programs dexct_tpu/ops/fbp_fast.py:
// parallel_backproject_multi (a lax.scan over 64-view blocks whose body
// gathers one packed row of all 2K taps per (view, in-disc pixel)) and the
// symmetry-packed forms the single-device pipeline reaches
// (parallel_backproject_sym8 + parallel_backproject_sym, _sym2, _sym8_qs).
// Those packs exist to cut the TPU's gather COUNT (one 16K-float row serves
// eight (pixel, view) pairs); they compute the same image.
//
// What bounds it on the card: per (pixel, view) ~10 float ops and one row
// of 2K floats of the packed tap table (16.8 MB at 4 x 512 x 1024, resident
// in L2).  1.06e8 in-disc pixel-views at the reference protocol (512 views,
// 79% of 512^2 pixels), so the 32-byte row fetches from L2 (3.4 GB in all,
// less where neighbouring pixels share rows), not the arithmetic, are
// expected to bound it.  Design, as K4: one thread per output pixel
// loops over all views and keeps the K sums in registers, so the output is
// written once with no atomics; cos/sin of the view angles come from shared
// memory; 16 x 16 pixel blocks keep a warp's channel coordinates within a
// few channels, so its row fetches share lines.  Pixels outside the disc
// (the host's float64 mask, as the JAX program builds it) skip the loop
// and write 0.
//
// Per view, as the JAX program: c = (X cos t + Y sin t - t0) / dt,
// c0 = clamp(floor(c), 0, nt-2), f = clamp(c - c0, 0, 1), and the view
// counts only where 0 <= c <= nt-1.  The sum is multiplied by dtheta.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 1024;

template <int K>
__global__ void parallel_backproject_kernel(
    const float* __restrict__ packed, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, const unsigned char* __restrict__ mask,
    float* __restrict__ out, int n_theta, int nt, int N, float px,
    float half, float t0, float dt, float dtheta) {
  __shared__ float s_cos[kChunk];
  __shared__ float s_sin[kChunk];
  const int ix = blockIdx.x * blockDim.x + threadIdx.x;
  const int iy = blockIdx.y * blockDim.y + threadIdx.y;
  const size_t pix = (size_t)iy * N + ix;
  const bool valid =
      ix < N && iy < N && (mask == nullptr || mask[pix] != 0);
  // pixel centres in the JAX program's operation order
  const float X = __fmul_rn(__fsub_rn(__fadd_rn((float)ix, 0.5f), half), px);
  const float Y = __fmul_rn(__fsub_rn(__fadd_rn((float)iy, 0.5f), half), px);
  const float c_max = (float)(nt - 1);
  const float c0_max = (float)(nt - 2);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0f;

  for (int v0 = 0; v0 < n_theta; v0 += kChunk) {
    const int nv = min(kChunk, n_theta - v0);
    __syncthreads();
    for (int i = tid; i < nv; i += nthreads) {
      s_cos[i] = cos_t[v0 + i];
      s_sin[i] = sin_t[v0 + i];
    }
    __syncthreads();
    if (!valid) continue;
    for (int j = 0; j < nv; ++j) {
      // no fused multiply-add: the edge tests below must flip where the
      // reference's do
      const float c = __fdiv_rn(
          __fsub_rn(__fadd_rn(__fmul_rn(X, s_cos[j]), __fmul_rn(Y, s_sin[j])),
                    t0),
          dt);
      if (!(c >= 0.0f && c <= c_max)) continue;  // off the detector
      const float c0 = fminf(fmaxf(floorf(c), 0.0f), c0_max);
      const float f = fminf(fmaxf(c - c0, 0.0f), 1.0f);
      const float* row =
          packed + ((size_t)(v0 + j) * nt + (size_t)c0) * (2 * K);
#pragma unroll
      for (int k = 0; k < K; ++k)
        acc[k] += __ldg(row + k) * (1.0f - f) + __ldg(row + K + k) * f;
    }
  }
  if (ix >= N || iy >= N) return;
  const size_t plane = (size_t)N * N;
#pragma unroll
  for (int k = 0; k < K; ++k)
    out[k * plane + pix] = valid ? acc[k] * dtheta : 0.0f;
}

template <int K>
void launch(const float* packed, const float* cos_t, const float* sin_t,
            const unsigned char* mask, float* out, int n_theta, int nt,
            int N, float px, float half, float t0, float dt, float dtheta,
            cudaStream_t stream) {
  const dim3 threads(16, 16);
  const dim3 blocks((N + 15) / 16, (N + 15) / 16);
  parallel_backproject_kernel<K><<<blocks, threads, 0, stream>>>(
      packed, cos_t, sin_t, mask, out, n_theta, nt, N, px, half, t0, dt,
      dtheta);
}

}  // namespace

// packed [n_theta * nt, 2K]; cos_t, sin_t [n_theta]; mask [N * N] uint8 or
// null (every pixel); out [K, N, N]
extern "C" int dexct_parallel_backproject(
    const void* packed, const void* cos_t, const void* sin_t,
    const void* mask, void* out, int n_images, int n_theta, int nt, int N,
    float px, float half, float t0, float dt, float dtheta, void* stream) {
  const float* p = static_cast<const float*>(packed);
  const float* ct = static_cast<const float*>(cos_t);
  const float* st = static_cast<const float*>(sin_t);
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0) return (int)cudaGetLastError();
#define DEXCT_CASE(KK) \
  launch<KK>(p, ct, st, m, o, n_theta, nt, N, px, half, t0, dt, dtheta, s)
  switch (n_images) {
    case 1: DEXCT_CASE(1); break;
    case 2: DEXCT_CASE(2); break;
    case 3: DEXCT_CASE(3); break;
    case 4: DEXCT_CASE(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef DEXCT_CASE
  return (int)cudaGetLastError();
}
