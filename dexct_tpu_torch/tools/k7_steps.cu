// The steps of K7's redesign as kernel variants, for
// tools/probe_k7_steps.py (not part of the package's kernel library).
//
// Variant 0 is K7 as it stood before the redesign (csrc/kb_sample.cu at
// that commit): one thread per sample in the tables' (theta, l) order, the
// 16 weights in 16 scalar loads at a 64-byte stride, every tap gathered
// from the spectrum in device memory, `re += w * z` (nvcc contracts it to
// fma(w, z, re)).  Then, each built on the last:
// (a) the same kernel with each sample's weights in four 16-byte loads;
// (b) the samples in binned order (ops/fourier.py:kb_tiles), a block per
//     work item, the records and weights in 16-byte loads from the binned
//     tables, the taps still gathered from device memory through L1;
// (c) the tile staged in shared memory: csrc/kb_sample.cu's kernel, at the
//     tile and item size its tables were binned with (T = 8, items of 128:
//     the library's entry, dexct_kb_sample; any other, and variant 4 at
//     every size: the kernel instantiated here at T and up to kStepMax
//     threads).
// All variants compute each sample's sum in the same order with the same
// contraction, so they agree with variant 0 bit for bit.

#include "../csrc/kb_sample.cu"

namespace {

constexpr int kStepMax = 256;  // the largest work item the steps take

__global__ void parent_kernel(const float2* __restrict__ F,
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

// (a): variant 0 with the weights as four float4
__global__ void float4_kernel(const float2* __restrict__ F,
                              const int* __restrict__ base,
                              const float4* __restrict__ w,
                              const float* __restrict__ phase_cos,
                              const float* __restrict__ phase_sin,
                              float2* __restrict__ out, int S, int M,
                              int G) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int plane = G * G;
  int b = __ldg(base + s);
  b = b < 0 ? 0 : (b >= plane ? plane - 1 : b);
  const int vb = b / G, ub = b % G;
  int rows[4], cols[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    rows[j] = ((vb + j) % G) * G;
    cols[j] = (ub + j) % G;
  }
  float wt[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v = __ldg(w + (size_t)s * 4 + q);
    wt[4 * q] = v.x;
    wt[4 * q + 1] = v.y;
    wt[4 * q + 2] = v.z;
    wt[4 * q + 3] = v.w;
  }
  const float pc = __ldg(phase_cos + s), ps = __ldg(phase_sin + s);
  for (int m = 0; m < M; ++m) {
    const float2* Fm = F + (size_t)m * plane;
    float re = 0.0f, im = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 z = __ldg(Fm + rows[j] + cols[i]);
        re = __fmaf_rn(wt[i * 4 + j], z.x, re);
        im = __fmaf_rn(wt[i * 4 + j], z.y, im);
      }
    }
    out[(size_t)m * S + s] =
        make_float2(__fsub_rn(__fmul_rn(re, pc), __fmul_rn(im, ps)),
                    __fadd_rn(__fmul_rn(re, ps), __fmul_rn(im, pc)));
  }
}

// (b): the binned order, a block per work item, taps from device memory
template <int T>
__global__ void __launch_bounds__(kStepMax)
    binned_kernel(const float2* __restrict__ F, const int* __restrict__ items,
                  const int2* __restrict__ origin,
                  const int4* __restrict__ rec, const float4* __restrict__ w,
                  float2* __restrict__ out, int S, int M, int G) {
  constexpr int P = T + 3;
  const int p = __ldg(items + blockIdx.x) + threadIdx.x;
  if (p >= __ldg(items + blockIdx.x + 1)) return;
  const int2 o = __ldg(origin + blockIdx.x);
  const int4 r = __ldg(rec + p);
  const int vb = o.x + r.y / P, ub = o.y + r.y % P;
  int rows[4], cols[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    rows[j] = ((vb + j) % G) * G;
    cols[j] = (ub + j) % G;
  }
  float wt[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v = __ldg(w + (long long)q * S + p);
    wt[4 * q] = v.x;
    wt[4 * q + 1] = v.y;
    wt[4 * q + 2] = v.z;
    wt[4 * q + 3] = v.w;
  }
  const float pc = __int_as_float(r.z), ps = __int_as_float(r.w);
  const long long plane = (long long)G * G;
  for (int m = 0; m < M; ++m) {
    const float2* Fm = F + m * plane;
    float re = 0.0f, im = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 z = __ldg(Fm + rows[j] + cols[i]);
        re = __fmaf_rn(wt[i * 4 + j], z.x, re);
        im = __fmaf_rn(wt[i * 4 + j], z.y, im);
      }
    }
    out[m * (long long)S + r.x] =
        make_float2(__fsub_rn(__fmul_rn(re, pc), __fmul_rn(im, ps)),
                    __fadd_rn(__fmul_rn(re, ps), __fmul_rn(im, pc)));
  }
}

}  // namespace

// variant 0 parent, 1 (a), 2 (b), 3 (c), 4 (c) built for kStepMax threads;
// base, slice_w, phase_cos and
// phase_sin are the plan's tables (variants 0 and 1), items, origin, rec
// and w the binned ones at tile and cap (variants 2 to 4)
extern "C" int k7_step(int variant, const void* F, const void* base,
                       const void* slice_w, const void* phase_cos,
                       const void* phase_sin, const void* items,
                       const void* origin, const void* rec, const void* w,
                       void* out, int S, int M, int G, int tile, int n_items,
                       int cap, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* fp = static_cast<const float2*>(F);
  auto* op = static_cast<float2*>(out);
  if (cap <= 0 || cap > kStepMax || (tile != 8 && tile != 16))
    return (int)cudaErrorInvalidValue;
  const int threads = (cap + 31) / 32 * 32;
  switch (variant) {
    case 0:
      parent_kernel<<<(S + 255) / 256, 256, 0, st>>>(
          fp, static_cast<const int*>(base),
          static_cast<const float*>(slice_w),
          static_cast<const float*>(phase_cos),
          static_cast<const float*>(phase_sin), op, S, M, G);
      break;
    case 1:
      float4_kernel<<<(S + 255) / 256, 256, 0, st>>>(
          fp, static_cast<const int*>(base),
          static_cast<const float4*>(slice_w),
          static_cast<const float*>(phase_cos),
          static_cast<const float*>(phase_sin), op, S, M, G);
      break;
    case 2:
      if (tile == 16)
        binned_kernel<16><<<n_items, threads, 0, st>>>(
            fp, static_cast<const int*>(items),
            static_cast<const int2*>(origin), static_cast<const int4*>(rec),
            static_cast<const float4*>(w), op, S, M, G);
      else
        binned_kernel<8><<<n_items, threads, 0, st>>>(
            fp, static_cast<const int*>(items),
            static_cast<const int2*>(origin), static_cast<const int4*>(rec),
            static_cast<const float4*>(w), op, S, M, G);
      break;
    case 3:
    case 4:
      if (variant == 3 && tile == kTile && cap == kItem)
        return dexct_kb_sample(F, items, origin, rec, w, out, S, M, G,
                               n_items, stream);
      if (tile == 16)
        kb_tile_kernel<16, kStepMax><<<n_items, threads, 0, st>>>(
            fp, static_cast<const int*>(items),
            static_cast<const int2*>(origin), static_cast<const int4*>(rec),
            static_cast<const float4*>(w), op, S, M, G);
      else
        kb_tile_kernel<8, kStepMax><<<n_items, threads, 0, st>>>(
            fp, static_cast<const int*>(items),
            static_cast<const int2*>(origin), static_cast<const int4*>(rec),
            static_cast<const float4*>(w), op, S, M, G);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
