// K4 fan_backproject: equiangular fan-beam backprojection of K images.
//
// Replaces the TPU programs dexct_tpu/ops/fbp_fast.py:fan_backproject_multi
// (a lax.scan over 32-view blocks whose body gathers one packed row of all
// 2K taps per (view, pixel)) and dexct_tpu/ops/fbp.py:fan_backproject (the
// one-image form, K = 1 here).
//
// What bounds it on the card: per (pixel, view) one atan2, one reciprocal
// and ~20 other float ops, plus one row of 2K floats of the packed tap
// table (25.6 MB at 4 x 1000 x 800, resident in L2).  N^2 x V = 2.6e8
// pixel-views at the reference protocol, so arithmetic dominates.  Design:
// one thread per output pixel loops over all views and keeps the K sums
// in registers, so the output [K, N, N] is written once with no atomics;
// cos/sin of the view angles come from shared memory (staged in chunks of
// kChunk views); the packed table pack_filtered([K, V, C]) -> [V*C, 2K]
// lets one row fetch serve both linear-interpolation taps of all K images.
// Neighbouring threads are neighbouring pixels, whose channel coordinates
// differ by a fraction of a channel, so their row fetches share lines.
//
// Per view, as the JAX program: vr = X cos b + Y sin b - sid,
// vt = -X sin b + Y cos b, gamma = atan2(-vt, -vr),
// c = gamma / dgamma - 0.5 + C/2, c0 = clamp(floor(c), 0, C-2),
// f = clamp(c - c0, 0, 1), inside = 0 <= c <= C-1, weight 1/(vr^2 + vt^2);
// the packed row at c0 holds q[c0] and q[c0+1] (pack_filtered's
// last-channel rule repeats q[C-1] only at c = C-1, which c0 never
// reaches).  The sum is multiplied by dbeta at the end.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 1024;

template <int K>
__global__ void fan_backproject_kernel(const float* __restrict__ packed,
                                       const float* __restrict__ cos_b,
                                       const float* __restrict__ sin_b,
                                       float* __restrict__ out, int V, int C,
                                       int N, float px, float half, float sid,
                                       float dgamma, float dbeta) {
  __shared__ float s_cos[kChunk];
  __shared__ float s_sin[kChunk];
  const int ix = blockIdx.x * blockDim.x + threadIdx.x;
  const int iy = blockIdx.y * blockDim.y + threadIdx.y;
  const bool valid = ix < N && iy < N;
  const float X = ((float)ix + 0.5f - half) * px;
  const float Y = ((float)iy + 0.5f - half) * px;
  const float c_shift = 0.5f * (float)C;
  const float c_max = (float)(C - 1);
  const float c0_max = (float)(C - 2);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0f;

  for (int v0 = 0; v0 < V; v0 += kChunk) {
    const int nv = min(kChunk, V - v0);
    __syncthreads();
    for (int i = tid; i < nv; i += nthreads) {
      s_cos[i] = cos_b[v0 + i];
      s_sin[i] = sin_b[v0 + i];
    }
    __syncthreads();
    if (!valid) continue;
    for (int j = 0; j < nv; ++j) {
      const float cb = s_cos[j], sb = s_sin[j];
      // the channel coordinate in the JAX program's operation order, with
      // no fused multiply-add: the hard fan-edge test below must flip
      // where the reference's does
      const float vr = __fsub_rn(__fadd_rn(__fmul_rn(X, cb), __fmul_rn(Y, sb)),
                                 sid);
      const float vt = __fadd_rn(__fmul_rn(-X, sb), __fmul_rn(Y, cb));
      const float c = __fadd_rn(
          __fsub_rn(__fdiv_rn(atan2f(-vt, -vr), dgamma), 0.5f), c_shift);
      if (!(c >= 0.0f && c <= c_max)) continue;  // outside the fan
      const float c0 = fminf(fmaxf(floorf(c), 0.0f), c0_max);
      const float f = fminf(fmaxf(c - c0, 0.0f), 1.0f);
      const float w = __fdiv_rn(
          1.0f, __fadd_rn(__fmul_rn(vr, vr), __fmul_rn(vt, vt)));
      const float* row =
          packed + ((size_t)(v0 + j) * C + (size_t)c0) * (2 * K);
#pragma unroll
      for (int k = 0; k < K; ++k)
        acc[k] += w * (__ldg(row + k) * (1.0f - f) + __ldg(row + K + k) * f);
    }
  }
  if (!valid) return;
  const size_t plane = (size_t)N * N;
#pragma unroll
  for (int k = 0; k < K; ++k)
    out[k * plane + (size_t)iy * N + ix] = acc[k] * dbeta;
}

template <int K>
void launch(const float* packed, const float* cos_b, const float* sin_b,
            float* out, int V, int C, int N, float px, float half, float sid,
            float dgamma, float dbeta, cudaStream_t stream) {
  const dim3 threads(16, 16);
  const dim3 blocks((N + 15) / 16, (N + 15) / 16);
  fan_backproject_kernel<K><<<blocks, threads, 0, stream>>>(
      packed, cos_b, sin_b, out, V, C, N, px, half, sid, dgamma, dbeta);
}

}  // namespace

extern "C" int dexct_fan_backproject(const void* packed, const void* cos_b,
                                     const void* sin_b, void* out,
                                     int n_images, int V, int C, int N,
                                     float px, float half, float sid,
                                     float dgamma, float dbeta,
                                     void* stream) {
  const float* p = static_cast<const float*>(packed);
  const float* cb = static_cast<const float*>(cos_b);
  const float* sb = static_cast<const float*>(sin_b);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0) return (int)cudaGetLastError();
#define DEXCT_CASE(KK) \
  launch<KK>(p, cb, sb, o, V, C, N, px, half, sid, dgamma, dbeta, st)
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
