// K5 rebin_to_parallel and K8 resample_to_fan: a gather-weighted sum of a
// few taps per output sample, for every row of a small [K, n_src] table
// (and K22, K8's adjoint, a scatter of the same taps; below).
//
// K5 replaces dexct_tpu/ops/fbp_fast.py:rebin_to_parallel, the TPU program
// that maps K fan sinograms [K, V*C] onto a (theta, t) parallel grid.  Its
// plan (parallel_rebin_plan) gives each parallel bin 8 taps (16 for the
// flying-focal-spot plan; 4, the bilinear (beta, gamma) taps, for the
// cone-parallel rebin of dexct_tpu/ops/helical_pi.py:289-319, where the K
// table rows are the R detector rows), listed as adjacent-channel pairs:
// the TPU program reads only each pair's first index and takes the second
// tap from a channel-rolled copy of the table, laid out as [V*C, 2K] rows
// so one gather fetches a pair for all K images.  Here the pair's second tap is
// the next element of the same row (mod V*C, the roll's wrap), read
// straight from the sinograms [K, V*C]; no rolled table is built.
//
// K8 replaces dexct_tpu/ops/fourier.py:_resample_to_fan, the 4-tap
// bilinear resample of the Radon transforms [M, ntheta*nt] onto the fan
// rays, written ray-major [V*C, M]: the [V, C, M] layout K2 reads.
//
// What bounds it on the card: each output sample reads TAPS indices and
// weights once (TAPS * 8 bytes) and then K * TAPS table values.  The
// tables are small (K5: 12.8 MB of sinograms at 4 x 1000 x 800; K8: 25 MB
// of Radon transforms at 6 x 1024 x 1024), so they stay in the 50 MB L2
// and the gathers are L2 hits; the plan streams from device memory once
// (K5: 33 MB, K8: 26 MB at the reference protocol).  Design: one thread
// per output sample, taps and weights in registers, a loop over the K
// table rows; neighbouring threads are neighbouring bins or channels whose
// taps are neighbouring table elements, so their gathers share lines.
// Indices are clamped into the table, as the JAX gather clamps them.

#include <cuda_runtime.h>

namespace {

template <int TAPS, bool PAIRED, bool ROW_OUT>
__global__ void tap_sum_kernel(const float* __restrict__ table,
                               const int* __restrict__ idx,
                               const float* __restrict__ w,
                               float* __restrict__ out, long long n_out,
                               int K, long long n_src) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_out) return;
  const int* ip = idx + o * TAPS;
  const float* wp = w + o * TAPS;
  long long src[TAPS];
  float wt[TAPS];
#pragma unroll
  for (int t = 0; t < TAPS; ++t) wt[t] = __ldg(wp + t);
#pragma unroll
  for (int t = 0; t < TAPS; t += PAIRED ? 2 : 1) {
    long long s = __ldg(ip + t);
    s = s < 0 ? 0 : (s >= n_src ? n_src - 1 : s);
    src[t] = s;
    if constexpr (PAIRED) src[t + 1] = s + 1 == n_src ? 0 : s + 1;
  }
  for (int k = 0; k < K; ++k) {
    const float* row = table + (size_t)k * n_src;
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < TAPS; ++t) acc += wt[t] * __ldg(row + src[t]);
    out[ROW_OUT ? o * K + k : (long long)k * n_out + o] = acc;
  }
}

template <int TAPS, bool PAIRED, bool ROW_OUT>
int launch(const void* table, const void* idx, const void* w, void* out,
           long long n_out, int K, long long n_src, void* stream) {
  if (n_out <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  const long long blocks = (n_out + threads - 1) / threads;
  tap_sum_kernel<TAPS, PAIRED, ROW_OUT>
      <<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(table), static_cast<const int*>(idx),
          static_cast<const float*>(w), static_cast<float*>(out), n_out, K,
          n_src);
  return (int)cudaGetLastError();
}

// K22 resample_to_fan_adjoint: the adjoint of K8 (dexct_tpu/ops/
// fourier.py:397 transposed by jax.linear_transpose and jax.grad).  Each
// ray scatters its M values, times its 4 bilinear weights, into the Radon
// transforms' gradient [M, ntheta*nt] with float32 atomic adds, its tap
// indices clamped as K8 clamps them.  Bound: 4 * M atomics per ray into a
// table that stays in L2 (8 MB per image at 1024 x 2048); neighbouring
// rays of a view hit neighbouring bins, so the adds of a warp share lines.
__global__ void resample_adjoint_kernel(const float* __restrict__ g,
                                        const int* __restrict__ idx,
                                        const float* __restrict__ w,
                                        float* __restrict__ radon,
                                        long long n_rays, int M,
                                        long long n_src) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_rays) return;
  long long src[4];
  float wt[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    long long s = __ldg(idx + o * 4 + t);
    src[t] = s < 0 ? 0 : (s >= n_src ? n_src - 1 : s);
    wt[t] = __ldg(w + o * 4 + t);
  }
  for (int k = 0; k < M; ++k) {
    const float v = __ldg(g + o * M + k);
    float* row = radon + (size_t)k * n_src;
#pragma unroll
    for (int t = 0; t < 4; ++t) atomicAdd(row + src[t], wt[t] * v);
  }
}

}  // namespace

// sinos [K, n_src] -> out [K, n_bins]; idx/w [n_bins, taps], taps 4, 8 or
// 16
extern "C" int dexct_rebin_to_parallel(const void* sinos, const void* idx,
                                       const void* w, void* out,
                                       long long n_bins, int K,
                                       long long n_src, int taps,
                                       void* stream) {
  switch (taps) {
    case 4:
      return launch<4, true, false>(sinos, idx, w, out, n_bins, K, n_src,
                                    stream);
    case 8:
      return launch<8, true, false>(sinos, idx, w, out, n_bins, K, n_src,
                                    stream);
    case 16:
      return launch<16, true, false>(sinos, idx, w, out, n_bins, K, n_src,
                                     stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// radon [M, n_src] -> out [n_rays, M]; idx/w [n_rays, 4]
extern "C" int dexct_resample_to_fan(const void* radon, const void* idx,
                                     const void* w, void* out,
                                     long long n_rays, int M,
                                     long long n_src, void* stream) {
  return launch<4, false, true>(radon, idx, w, out, n_rays, M, n_src,
                                stream);
}

// g [n_rays, M]; idx/w [n_rays, 4]; radon [M, n_src], zeroed by the
// caller, accumulated into
extern "C" int dexct_resample_to_fan_adjoint(const void* g, const void* idx,
                                             const void* w, void* radon,
                                             long long n_rays, int M,
                                             long long n_src, void* stream) {
  if (n_rays <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  const long long blocks = (n_rays + threads - 1) / threads;
  resample_adjoint_kernel<<<(unsigned)blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<float*>(radon), n_rays, M,
      n_src);
  return (int)cudaGetLastError();
}
