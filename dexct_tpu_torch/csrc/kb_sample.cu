// K7 kb_sample: Kaiser-Bessel gridding sample of the 2-D spectra of M
// material images along ntheta radial lines (the Fourier-slice projector).
//
// Replaces the sampler of dexct_tpu/ops/fourier.py:_radon_from_images.
// The TPU program builds a table of 16 rolled copies of the spectrum,
// [G^2, 16 * 2M] floats (201 MB at G = 512, M = 6), so that one row gather
// fetches the whole 4 x 4 window of every re/im channel of a sample; the
// gather count, not the bytes, sets a TPU's rate.  Here each sample reads
// its 16 window taps straight from the spectrum F [M, G, G] (complex64, 12.6
// MB at the reference protocol: it stays in the 50 MB L2), with the window
// base from slice_idx and the four row and four column offsets wrapped mod
// G.  No table is built.
//
// What bounds it on the card: 16 * M complex L2 reads (768 bytes at M = 6)
// and 16 * M * 4 float ops per sample, ntheta * nl = 1024 x 257 samples:
// 0.2 GB of L2 traffic.  Design: one thread per (theta, l) sample; the 16
// weights, the 4 row and 4 column offsets and the phase stay in registers
// across the loop over materials; neighbouring threads are neighbouring
// radii of one line, whose windows overlap, so their reads share lines.
// The output is complex64 [M, ntheta, nl], the layout torch.fft.irfft takes
// along its last axis.
//
// Per sample, as the JAX program: z = sum_{i,j} w[i*4 + j] *
// F[(vb + j) % G, (ub + i) % G] for re and im, then spec = z * (cos phi +
// i sin phi) with the host phase table.

#include <cuda_runtime.h>

namespace {

__global__ void kb_sample_kernel(const float2* __restrict__ F,
                                 const int* __restrict__ base,
                                 const float* __restrict__ w,
                                 const float* __restrict__ phase_cos,
                                 const float* __restrict__ phase_sin,
                                 float2* __restrict__ out, int S, int M,
                                 int G) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int plane = G * G;
  int b = __ldg(base + s);
  b = b < 0 ? 0 : (b >= plane ? plane - 1 : b);  // the JAX gather's clamp
  const int vb = b / G, ub = b % G;
  int rows[4], cols[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    rows[j] = ((vb + j) % G) * G;
    cols[j] = (ub + j) % G;
  }
  float wt[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) wt[k] = __ldg(w + (size_t)s * 16 + k);
  const float pc = __ldg(phase_cos + s), ps = __ldg(phase_sin + s);
  for (int m = 0; m < M; ++m) {
    const float2* Fm = F + (size_t)m * plane;
    float re = 0.0f, im = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 z = __ldg(Fm + rows[j] + cols[i]);
        re += wt[i * 4 + j] * z.x;
        im += wt[i * 4 + j] * z.y;
      }
    }
    out[(size_t)m * S + s] =
        make_float2(__fsub_rn(__fmul_rn(re, pc), __fmul_rn(im, ps)),
                    __fadd_rn(__fmul_rn(re, ps), __fmul_rn(im, pc)));
  }
}

}  // namespace

// F [M, G, G] complex64; base [S] int32; w [S, 16]; phase_cos/sin [S];
// out [M, S] complex64
extern "C" int dexct_kb_sample(const void* F, const void* base,
                               const void* w, const void* phase_cos,
                               const void* phase_sin, void* out, int S, int M,
                               int G, void* stream) {
  if (S <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  kb_sample_kernel<<<(S + threads - 1) / threads, threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(F), static_cast<const int*>(base),
      static_cast<const float*>(w), static_cast<const float*>(phase_cos),
      static_cast<const float*>(phase_sin), static_cast<float2*>(out), S, M,
      G);
  return (int)cudaGetLastError();
}
