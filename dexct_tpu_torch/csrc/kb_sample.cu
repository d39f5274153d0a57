// K7 kb_sample: Kaiser-Bessel gridding sample of the 2-D spectra of M
// material images along ntheta radial lines (the Fourier-slice projector),
// and K21, its adjoint (below).
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

// K21 kb_sample_adjoint: the adjoint of K7 (dexct_tpu/ops/fourier.py:258
// transposed by jax.linear_transpose in ops/iterative.py and jax.grad in
// ops/onestep.py).  Each (theta, l) sample multiplies its incoming complex
// gradient by the conjugate phase and scatters it, times its 16 KB
// weights, into the spectrum's gradient F [M, G, G]: the transpose of K7's
// real-linear map in the (re, im) pairing that torch's autograd uses, so it
// serves both the explicit A^T and the backward pass.  The window base is
// clamped and the offsets wrapped exactly as K7 does, so <K7 x, y> =
// <x, K21 y> holds for the pair.
//
// What bounds it on the card: 16 * M complex float32 atomic adds per
// sample into a spectrum that stays in L2 (8 MB at G = 1024, M = 1).  The
// lines cross near DC: at l = 0 and 1 all ntheta lines add into the same
// 16 cells (1024 x 2 x 16 adds serialised per cell, ~1 us at the L2's
// same-address rate), which the first timing shows to be small against the
// ~2e6 adds of the rest.  Design: one thread per sample, as K7; the
// weights and offsets in registers, float32 atomicAdd on re and im.

__global__ void kb_sample_adjoint_kernel(const float2* __restrict__ g,
                                         const int* __restrict__ base,
                                         const float* __restrict__ w,
                                         const float* __restrict__ phase_cos,
                                         const float* __restrict__ phase_sin,
                                         float* __restrict__ F, int S, int M,
                                         int G) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int plane = G * G;
  int b = __ldg(base + s);
  b = b < 0 ? 0 : (b >= plane ? plane - 1 : b);  // K7's clamp
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
    const float2 z = __ldg(g + (size_t)m * S + s);
    // z * conj(cos phi + i sin phi)
    const float re = __fadd_rn(__fmul_rn(z.x, pc), __fmul_rn(z.y, ps));
    const float im = __fsub_rn(__fmul_rn(z.y, pc), __fmul_rn(z.x, ps));
    float* Fm = F + (size_t)m * plane * 2;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* cell = Fm + (size_t)(rows[j] + cols[i]) * 2;
        atomicAdd(cell, wt[i * 4 + j] * re);
        atomicAdd(cell + 1, wt[i * 4 + j] * im);
      }
    }
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

// g [M, S] complex64; base [S] int32; w [S, 16]; phase_cos/sin [S];
// F [M, G, G] complex64, zeroed by the caller, accumulated into
extern "C" int dexct_kb_sample_adjoint(const void* g, const void* base,
                                       const void* w, const void* phase_cos,
                                       const void* phase_sin, void* F, int S,
                                       int M, int G, void* stream) {
  if (S <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  kb_sample_adjoint_kernel<<<(S + threads - 1) / threads, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(g), static_cast<const int*>(base),
      static_cast<const float*>(w), static_cast<const float*>(phase_cos),
      static_cast<const float*>(phase_sin), static_cast<float*>(F), S, M, G);
  return (int)cudaGetLastError();
}
