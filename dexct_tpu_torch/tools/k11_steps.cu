// The steps of K11's redesign as kernel variants, for
// tools/probe_cone_backproject.py --kernel k11 --steps (not part of the
// package's kernel library).  Built once per variant: nvcc
// -DK11_VARIANT=<n> (n = 0..13) compiles that variant beside the package's
// csrc/cone_backproject.cu, whose device functions it uses.
//
// Variant 0 is K11 as it stood before the redesign (csrc/
// cone_backproject.cu at that commit): one thread per (disc pixel, slice)
// in 128-thread blocks, every view's in-plane geometry (view_tap, atan2,
// the channel tap, 1 / h^2) recomputed for every slice, scalar taps at
// 64-bit offsets.  k11v_kernel<K, n> is variant n (Cfg<n> names its
// settings): one thread per (disc pixel, group of S slices) forming each
// view's in-plane geometry once for the group, the slices' z sid in shared
// memory.  1: S = 4 with scalar taps, 128 threads bounded to 8 blocks an
// SM; 2: as 1 with the packed taps (the images innermost: one 16-byte load
// a detector element at K = 3, 4); 3: as 2 at S = 2; 4, 5: as 2 and 3 in
// 64-thread blocks bounded to 16; 6, 7: as 2 and 3 with mirror slices
// paired (slice i and nz - 1 - i in one thread; where their z sid are
// negatives bit for bit, one division serves both, the quotient negated:
// IEEE division rounds sign-symmetrically); 8: as 2 at S = 8; 9: as 3
// bounded to 12 blocks an SM; 10: as 8 with mirror slices paired; 11: as 8
// in 64-thread blocks bounded to 16; 12: as 8 bounded to 6 blocks an SM
// (80 registers); 13: as 8 with each slice's quotient formed where it is
// used (fewer live registers).  Every variant adds each slice's terms in
// ascending view order with the parent's expressions (its contracted
// `acc += val * w` as __fmaf_rn), so all agree bit for bit.

#include "../csrc/cone_backproject.cu"

#ifndef K11_VARIANT
#define K11_VARIANT 0
#endif

namespace {

#if K11_VARIANT == 0

// the parent kernel (its fdk_backproject_kernel, verbatim)
template <int K>
__global__ void parent_kernel(
    const float* __restrict__ qs, const float* __restrict__ cos_b,
    const float* __restrict__ sin_b, const float* __restrict__ X,
    const float* __restrict__ Y, const long long* __restrict__ sel,
    const float* __restrict__ zc, float* __restrict__ out, int V, int R,
    int C, int P, long long plane, float sid, float dgamma, float row_h,
    float dbeta) {
  __shared__ float s_cos[kChunk];
  __shared__ float s_sin[kChunk];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int iz = blockIdx.y;
  const bool valid = p < P;
  const float x = valid ? X[p] : 0.0f;
  const float y = valid ? Y[p] : 0.0f;
  const float zs = __fmul_rn(zc[iz], sid);
  const Detector d = make_detector(V, R, C);

  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0f;

  for (int v0 = 0; v0 < V; v0 += kChunk) {
    const int nv = min(kChunk, V - v0);
    __syncthreads();
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      s_cos[i] = cos_b[v0 + i];
      s_sin[i] = sin_b[v0 + i];
    }
    __syncthreads();
    if (!valid) continue;
    for (int j = 0; j < nv; ++j) {
      const ViewTap t = view_tap(x, y, s_cos[j], s_sin[j], sid);
      const float c = channel(t, dgamma, d);
      if (!in_fan(c, d)) continue;
      const float ridx = __fadd_rn(
          __fsub_rn(__fdiv_rn(__fmul_rn(zs, t.inv_h), row_h), 0.5f),
          d.r_shift);
      if (!on_detector(ridx, d)) continue;
      add_taps<K>(qs, d, v0 + j, c, ridx, __fdiv_rn(1.0f, t.h2), acc);
    }
  }
  if (!valid) return;
  const long long dst = (long long)iz * plane + sel[p];
  const long long vol = (long long)gridDim.y * plane;
#pragma unroll
  for (int k = 0; k < K; ++k) out[k * vol + dst] = acc[k] * dbeta;
}

#else

// S slices a thread, threads a block, blocks an SM (launch bounds),
// packed taps, mirror pairs
// kLate: each slice's quotient formed where it is used
struct CfgBase {
  static constexpr bool kLate = false;
};
template <int N>
struct Cfg;
template <>
struct Cfg<1> : CfgBase {
  static constexpr int S = 4, kThr = 128, kMinBlocks = 8;
  static constexpr bool kPacked = false, kMirror = false;
};
template <>
struct Cfg<2> : CfgBase {
  static constexpr int S = 4, kThr = 128, kMinBlocks = 8;
  static constexpr bool kPacked = true, kMirror = false;
};
template <>
struct Cfg<3> : CfgBase {
  static constexpr int S = 2, kThr = 128, kMinBlocks = 8;
  static constexpr bool kPacked = true, kMirror = false;
};
template <>
struct Cfg<4> : CfgBase {
  static constexpr int S = 4, kThr = 64, kMinBlocks = 16;
  static constexpr bool kPacked = true, kMirror = false;
};
template <>
struct Cfg<5> : CfgBase {
  static constexpr int S = 2, kThr = 64, kMinBlocks = 16;
  static constexpr bool kPacked = true, kMirror = false;
};
template <>
struct Cfg<6> : CfgBase {
  static constexpr int S = 4, kThr = 128, kMinBlocks = 8;
  static constexpr bool kPacked = true, kMirror = true;
};
template <>
struct Cfg<7> : CfgBase {
  static constexpr int S = 2, kThr = 128, kMinBlocks = 8;
  static constexpr bool kPacked = true, kMirror = true;
};
template <>
struct Cfg<8> : CfgBase {
  static constexpr int S = 8, kThr = 128, kMinBlocks = 8;
  static constexpr bool kPacked = true, kMirror = false;
};
template <>
struct Cfg<9> : CfgBase {
  static constexpr int S = 2, kThr = 128, kMinBlocks = 12;
  static constexpr bool kPacked = true, kMirror = false;
};
template <>
struct Cfg<10> : CfgBase {
  static constexpr int S = 8, kThr = 128, kMinBlocks = 8;
  static constexpr bool kPacked = true, kMirror = true;
};
template <>
struct Cfg<11> : CfgBase {
  static constexpr int S = 8, kThr = 64, kMinBlocks = 16;
  static constexpr bool kPacked = true, kMirror = false;
};
template <>
struct Cfg<12> : CfgBase {
  static constexpr int S = 8, kThr = 128, kMinBlocks = 6;
  static constexpr bool kPacked = true, kMirror = false;
};
template <>
struct Cfg<13> : Cfg<8> {
  static constexpr bool kLate = true;
};

// add_taps with the channel tap (c0, fc) formed once per view, the
// contracted sum written out
template <int K>
__device__ __forceinline__ void add_scalar_taps(const float* __restrict__ qs,
                                                const Detector& d, int v,
                                                float c0, float fc,
                                                float ridx, float w,
                                                float* acc) {
  float r0, fr;
  row_tap(ridx, d, r0, fr);
  const int ir0 = (int)r0;
  const int ir1 = min(ir0 + 1, d.R - 1);
  const long long base = (long long)v * d.view_stride + (int)c0;
  const long long o0 = base + (long long)ir0 * d.C;
  const long long o1 = base + (long long)ir1 * d.C;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float* q = qs + k * d.image_stride;
    const float top = lerp_channels(q, o0, fc);
    const float bot = lerp_channels(q, o1, fc);
    acc[k] = __fmaf_rn(
        __fadd_rn(__fmul_rn(top, 1.0f - fr), __fmul_rn(bot, fr)), w, acc[k]);
  }
}

// the row position of z sid at 1 / sqrt(h^2) = inv_h, from its quotient
__device__ __forceinline__ float row_of(float quot, const Detector& d) {
  return __fadd_rn(__fsub_rn(quot, 0.5f), d.r_shift);
}

// The slices of the block's group: slot s of a thread holds slice iz[s]
// (-1: none).  Plain groups are S consecutive slices; mirror groups are S /
// 2 units, unit u the slices u and nz - 1 - u (slot 2 j and 2 j + 1; the
// second -1 for the middle slice of an odd nz).
template <int S, bool kMirror>
__device__ __forceinline__ int slot_slice(int group, int s, int nz) {
  if (!kMirror) {
    const int iz = group * S + s;
    return iz < nz ? iz : -1;
  }
  const int u = group * (S / 2) + s / 2;
  const int lo = u, hi = nz - 1 - u;
  if (lo > hi) return -1;
  if (s % 2 == 0) return lo;
  return hi > lo ? hi : -1;
}

template <int K, int N>
__global__ void __launch_bounds__(Cfg<N>::kThr, Cfg<N>::kMinBlocks)
    k11v_kernel(const float* __restrict__ q, const float* __restrict__ cos_b,
                const float* __restrict__ sin_b, const float* __restrict__ X,
                const float* __restrict__ Y,
                const long long* __restrict__ sel,
                const float* __restrict__ zc, float* __restrict__ out, int V,
                int R, int C, int P, int nz, long long plane, float sid,
                float dgamma, float row_h, float dbeta) {
  constexpr int S = Cfg<N>::S;
  constexpr bool kPacked = Cfg<N>::kPacked, kMirror = Cfg<N>::kMirror;
  __shared__ float s_cos[kChunk];
  __shared__ float s_sin[kChunk];
  __shared__ float s_zs[S];
  __shared__ int s_iz[S];
  __shared__ int s_neg[S / 2 > 0 ? S / 2 : 1];
  if (threadIdx.x < S) {
    const int iz = slot_slice<S, kMirror>(blockIdx.y, threadIdx.x, nz);
    s_iz[threadIdx.x] = iz;
    s_zs[threadIdx.x] = iz >= 0 ? __fmul_rn(zc[iz], sid) : 0.0f;
  }
  __syncthreads();
  if (kMirror && threadIdx.x < S / 2) {
    const int j = threadIdx.x;
    s_neg[j] = s_iz[2 * j + 1] >= 0 &&
               __float_as_uint(s_zs[2 * j + 1]) ==
                   (__float_as_uint(s_zs[2 * j]) ^ 0x80000000u);
  }
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = p < P;
  const float x = valid ? X[p] : 0.0f;
  const float y = valid ? Y[p] : 0.0f;
  const Detector d = make_detector(V, R, C);

  float acc[S][K];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int k = 0; k < K; ++k) acc[s][k] = 0.0f;

  for (int v0 = 0; v0 < V; v0 += kChunk) {
    const int nv = min(kChunk, V - v0);
    __syncthreads();
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      s_cos[i] = cos_b[v0 + i];
      s_sin[i] = sin_b[v0 + i];
    }
    __syncthreads();
    if (!valid) continue;
    for (int j = 0; j < nv; ++j) {
      // the pixel's in-plane geometry at view v0 + j, once for the group
      const ViewTap t = view_tap(x, y, s_cos[j], s_sin[j], sid);
      const float c = channel(t, dgamma, d);
      if (!in_fan(c, d)) continue;
      float c0, fc;
      channel_tap(c, d, c0, fc);
      const int base = (v0 + j) * R * C + (int)c0;
      const float w = __fdiv_rn(1.0f, t.h2);
      constexpr bool kLate = Cfg<N>::kLate;
      float quot[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (kLate) break;
        if (kMirror && s % 2 == 1 && s_neg[s / 2]) {
          quot[s] = -quot[s - 1];
        } else {
          quot[s] = __fdiv_rn(__fmul_rn(s_zs[s], t.inv_h), row_h);
        }
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (s_iz[s] < 0) continue;
        const float ridx = row_of(
            kLate ? __fdiv_rn(__fmul_rn(s_zs[s], t.inv_h), row_h) : quot[s],
            d);
        if (!on_detector(ridx, d)) continue;
        if (kPacked) {
          add_packed_taps<K>(q, d, base, fc, ridx, w, acc[s]);
        } else {
          add_scalar_taps<K>(q, d, v0 + j, c0, fc, ridx, w, acc[s]);
        }
      }
    }
  }
  if (!valid) return;
  const long long vol = (long long)nz * plane;
  const long long px = sel[p];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int iz = s_iz[s];
    if (iz < 0) continue;
#pragma unroll
    for (int k = 0; k < K; ++k)
      out[k * vol + (long long)iz * plane + px] = __fmul_rn(acc[s][k], dbeta);
  }
}

#endif

}  // namespace

// The variant this library was built as, on the checkout's
// dexct_fdk_backproject arguments: q packed for the variants that read
// packed taps (k11_step_packed), the stacks [K, V, R, C] otherwise.
extern "C" int k11_step(const void* q, const void* cos_b, const void* sin_b,
                        const void* X, const void* Y, const void* sel,
                        const void* zc, void* out, int n_images, int V, int R,
                        int C, int P, int nz, long long plane, float sid,
                        float dgamma, float row_h, float dbeta,
                        void* stream) {
  if (P <= 0 || nz <= 0) return (int)cudaGetLastError();
  if (C < 2 || R < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f[] = {static_cast<const float*>(q),
                      static_cast<const float*>(cos_b),
                      static_cast<const float*>(sin_b),
                      static_cast<const float*>(X),
                      static_cast<const float*>(Y)};
  const long long* s = static_cast<const long long*>(sel);
  const float* z = static_cast<const float*>(zc);
  float* o = static_cast<float*>(out);
  return for_images(n_images, [&](auto k) {
    constexpr int kK = decltype(k)::value;
#if K11_VARIANT == 0
    const dim3 blocks((P + 127) / 128, nz);
    parent_kernel<kK><<<blocks, 128, 0, st>>>(f[0], f[1], f[2], f[3], f[4],
                                              s, z, o, V, R, C, P, plane,
                                              sid, dgamma, row_h, dbeta);
#else
    using Cf = Cfg<K11_VARIANT>;
    const int units = Cf::kMirror ? (nz + 1) / 2 : nz;
    const int per = Cf::kMirror ? Cf::S / 2 : Cf::S;
    const dim3 blocks((P + Cf::kThr - 1) / Cf::kThr, (units + per - 1) / per);
    k11v_kernel<kK, K11_VARIANT><<<blocks, Cf::kThr, 0, st>>>(
        f[0], f[1], f[2], f[3], f[4], s, z, o, V, R, C, P, nz, plane, sid,
        dgamma, row_h, dbeta);
#endif
  });
}

// whether this variant reads the packed stacks
extern "C" int k11_step_packed() {
#if K11_VARIANT == 0
  return 0;
#else
  return Cfg<K11_VARIANT>::kPacked;
#endif
}
