// K5 rebin_to_parallel and K8 resample_to_fan: a gather-weighted sum of a
// few taps per output sample, for every row of a small [K, n_src] table
// (and K22, K8's adjoint, the same sum over the transposed taps; below).
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
// fourier.py:397 transposed by jax.linear_transpose and jax.grad), in
// gather form over the plan's transposed taps.
//
// The first design zero-filled the gradient [M, ntheta*nt] and let
// every ray scatter its 4 M weighted values into it with float32 atomic
// adds: 3.2M atomics per image at the reference plan (8e5 rays into
// 1024 x 1024 bins, ~3 a bin), contended where rays of different views
// land on one bin, in an order that changed from run to run.
//
// Here the plan's taps come transposed, once per plan (fan_transpose in
// ops/fourier.py): a CSR over the Radon bins, row_ptr [n_bins + 1] and
// for every tap its ray and weight, each bin's taps in the stable (bin,
// ray * 4 + tap) order, the tap indices clamped as K8 clamps them.  One
// thread per bin walks its run and sums w * y[ray, m] for four images at a
// time in registers, in that order and with _rn arithmetic from 0, then
// writes each output element once: no zero fill, no atomics, the same bits
// in every launch, and the sums of the CPU's index_add_, which adds the
// same products into each bin in the same order.  Every M takes one
// launch: beyond four images the thread walks its run again for each
// further group of four (no path has more than four).
//
// What bounds it on the card: bytes.  The transposed taps are as large as
// the plan's (ray and weight, 8 bytes a tap: 25.6 MB at the reference
// plan) plus row_ptr (4 bytes a bin, 4 MB); the output is written once
// (4 bytes a bin and image) and the values y (4 M bytes a ray) are
// gathered from L2: neighbouring bins of one angle take their taps from
// neighbouring channels of a few views.  Neighbouring threads read
// neighbouring runs of the CSR arrays.  Measured (chip_smoke.py, NVIDIA
// H100 80GB HBM3, 700.00 W): 0.0143 ms of device time at the reference
// plan against its 0.0098 ms bound, 0.0261 ms against 0.0146 ms at the
// one-step plan (two images).
template <int MB>
__global__ void tap_gather_kernel(const float* __restrict__ g,
                                  const int* __restrict__ row_ptr,
                                  const int* __restrict__ ray,
                                  const float* __restrict__ w,
                                  float* __restrict__ out, long long n_bins,
                                  int M) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_bins) return;
  const int lo = __ldg(row_ptr + b), hi = __ldg(row_ptr + b + 1);
  // MB images at a time; beyond MB the thread walks its run again for the
  // next group
  for (int m0 = 0; m0 < M; m0 += MB) {
    float acc[MB];
#pragma unroll
    for (int m = 0; m < MB; ++m) acc[m] = 0.0f;
    for (int j = lo; j < hi; ++j) {
      const float wt = __ldg(w + j);
      const float* gr = g + (long long)__ldg(ray + j) * M + m0;
#pragma unroll
      for (int m = 0; m < MB; ++m)
        if (m0 + m < M)
          acc[m] = __fadd_rn(acc[m], __fmul_rn(__ldg(gr + m), wt));
    }
#pragma unroll
    for (int m = 0; m < MB; ++m)
      if (m0 + m < M) out[(long long)(m0 + m) * n_bins + b] = acc[m];
  }
}

template <int MB>
void launch_gather(const float* g, const int* row_ptr, const int* ray,
                   const float* w, float* out, long long n_bins, int M,
                   cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (n_bins + threads - 1) / threads;
  tap_gather_kernel<MB><<<(unsigned)blocks, threads, 0, stream>>>(
      g, row_ptr, ray, w, out, n_bins, M);
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

// g [n_rays, M]; the transposed taps row_ptr [n_bins + 1], ray/w [n_taps]
// (n_taps = row_ptr[n_bins]); radon [M, n_bins], every element written
extern "C" int dexct_resample_to_fan_adjoint(const void* g,
                                             const void* row_ptr,
                                             const void* ray, const void* w,
                                             void* radon, long long n_bins,
                                             int M, void* stream) {
  if (M < 0 || n_bins < 0) return (int)cudaErrorInvalidValue;
  if (n_bins == 0 || M == 0) return (int)cudaGetLastError();
  if ((n_bins + 255) / 256 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto* gp = static_cast<const float*>(g);
  const auto* rp = static_cast<const int*>(row_ptr);
  const auto* ip = static_cast<const int*>(ray);
  const auto* wp = static_cast<const float*>(w);
  auto* op = static_cast<float*>(radon);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (M < 4 ? M : 4) {  // one launch; M > 4 in groups of 4
    case 1:
      launch_gather<1>(gp, rp, ip, wp, op, n_bins, M, st);
      break;
    case 2:
      launch_gather<2>(gp, rp, ip, wp, op, n_bins, M, st);
      break;
    case 3:
      launch_gather<3>(gp, rp, ip, wp, op, n_bins, M, st);
      break;
    default:
      launch_gather<4>(gp, rp, ip, wp, op, n_bins, M, st);
  }
  return (int)cudaGetLastError();
}
