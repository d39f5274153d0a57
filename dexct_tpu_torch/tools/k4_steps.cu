// The steps of K4's redesign as kernel variants, for
// tools/probe_k4_steps.py (not part of the package's kernel library).
//
// Variant 0 is K4 as it stood before the redesign (csrc/fan_backproject.cu
// at that commit): one thread per pixel in 16 x 16 blocks whose warps hold
// 16 x 2 pixels, cos/sin from shared memory, the packed row in 2K scalar
// loads at a 64-bit offset, and the sum written as acc += w * (a (1 - f)
// + b f), which nvcc contracted into fma(a, 1 - f, b f), then fma(w, tap,
// acc).  Every other variant is one template instance of step_kernel or
// two_px_kernel; the table in k4_step() names each variant's settings, and
// probe_k4_steps.py holds the same table by name.  All variants compute
// the same per-pixel operations in the same order, so they agree bit for
// bit with variant 0 except where a variant changes the contraction
// (INNER or OUTER other than 0).

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 1024;

__device__ __forceinline__ bool fan_tap(float X, float Y, float cb, float sb,
                                        float sid, float dgamma,
                                        float c_shift, float c_max,
                                        float c0_max, float& c0, float& f,
                                        float& l2) {
  const float vr = __fsub_rn(__fadd_rn(__fmul_rn(X, cb), __fmul_rn(Y, sb)),
                             sid);
  const float vt = __fadd_rn(__fmul_rn(-X, sb), __fmul_rn(Y, cb));
  const float c = __fadd_rn(
      __fsub_rn(__fdiv_rn(atan2f(-vt, -vr), dgamma), 0.5f), c_shift);
  if (!(c >= 0.0f && c <= c_max)) return false;
  c0 = fminf(fmaxf(floorf(c), 0.0f), c0_max);
  f = fminf(fmaxf(c - c0, 0.0f), 1.0f);
  l2 = __fadd_rn(__fmul_rn(vr, vr), __fmul_rn(vt, vt));
  return true;
}

template <int K>
__global__ void parent_kernel(const float* __restrict__ packed,
                              const float* __restrict__ cos_b,
                              const float* __restrict__ sin_b,
                              float* __restrict__ out, int V, int C, int N,
                              float px, float half, float sid, float dgamma,
                              float dbeta) {
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
      float c0, f, l2;
      if (!fan_tap(X, Y, s_cos[j], s_sin[j], sid, dgamma, c_shift, c_max,
                   c0_max, c0, f, l2))
        continue;
      const float w = __fdiv_rn(1.0f, l2);
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

// A variant's settings: warp tile width TW (the tile is TW x 32/TW), block
// height BH (blocks are 16 x BH pixels), 16-byte row loads VEC, 32-bit row
// offsets OFF32, the view loop's unroll factor UNROLL (0: the next view's
// tap and row loads issued before this view's sums), the minimum resident
// blocks MINB of __launch_bounds__, 1/l2 by __frcp_rn (RCP) or
// __fdiv_rn, and the contraction of the tap (INNER: 0 fma(a, g, b f),
// 1 fma(b, f, a g), 2 no fma) and of the sum (OUTER: 0 fma(w, tap, acc),
// 1 acc + w tap rounded).
template <int TW_, int BH_, bool VEC_, bool OFF32_, int UNROLL_, int MINB_,
          bool RCP_, int INNER_ = 0, int OUTER_ = 0>
struct Cfg {
  static constexpr int TW = TW_, BH = BH_, UNROLL = UNROLL_, MINB = MINB_;
  static constexpr bool VEC = VEC_, OFF32 = OFF32_, RCP = RCP_;
  static constexpr int INNER = INNER_, OUTER = OUTER_;
};

template <int K>
struct Row {
  float a[K];
  float b[K];
};

template <int K, bool VEC>
__device__ __forceinline__ Row<K> load_row(const float* __restrict__ p) {
  if constexpr (!VEC) {
    Row<K> r;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      r.a[k] = __ldg(p + k);
      r.b[k] = __ldg(p + K + k);
    }
    return r;
  } else if constexpr (K == 4) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
    return {{lo.x, lo.y, lo.z, lo.w}, {hi.x, hi.y, hi.z, hi.w}};
  } else if constexpr (K == 3) {
    const float2 t0 = __ldg(reinterpret_cast<const float2*>(p));
    const float2 t1 = __ldg(reinterpret_cast<const float2*>(p) + 1);
    const float2 t2 = __ldg(reinterpret_cast<const float2*>(p) + 2);
    return {{t0.x, t0.y, t1.x}, {t1.y, t2.x, t2.y}};
  } else {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    return {{t.x}, {t.y}};
  }
}

// one view of one pixel: prep() computes the tap, the weight and loads the
// row (false outside the fan); sum() adds it to the K sums
template <int K, class S>
struct View {
  Row<K> r;
  float w, f;
  __device__ __forceinline__ bool prep(const float* __restrict__ packed,
                                       float X, float Y, float2 cs, int v,
                                       int C, float sid, float dgamma,
                                       float c_shift, float c_max,
                                       float c0_max) {
    float c0, l2;
    if (!fan_tap(X, Y, cs.x, cs.y, sid, dgamma, c_shift, c_max, c0_max, c0,
                 f, l2))
      return false;
    w = S::RCP ? __frcp_rn(l2) : __fdiv_rn(1.0f, l2);
    const float* p;
    if constexpr (S::OFF32)
      p = packed + (v * C + __float2int_rz(c0)) * (2 * K);
    else
      p = packed + ((size_t)v * C + (size_t)c0) * (2 * K);
    r = load_row<K, S::VEC>(p);
    return true;
  }
  __device__ __forceinline__ void sum(float* acc) const {
    const float g = __fsub_rn(1.0f, f);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float t;
      if constexpr (S::INNER == 0)
        t = __fmaf_rn(r.a[k], g, __fmul_rn(r.b[k], f));
      else if constexpr (S::INNER == 1)
        t = __fmaf_rn(r.b[k], f, __fmul_rn(r.a[k], g));
      else
        t = __fadd_rn(__fmul_rn(r.a[k], g), __fmul_rn(r.b[k], f));
      acc[k] = S::OUTER == 0 ? __fmaf_rn(w, t, acc[k])
                             : __fadd_rn(acc[k], __fmul_rn(w, t));
    }
  }
};

// the views of one chunk, unrolled by S::UNROLL, or software-pipelined
template <int K, class S>
__device__ __forceinline__ void chunk(const float* __restrict__ packed,
                                      const float2* s_cs, int v0, int nv,
                                      float X, float Y, int C, float sid,
                                      float dgamma, float c_shift,
                                      float c_max, float c0_max,
                                      float* acc) {
  using Vw = View<K, S>;
  if constexpr (S::UNROLL > 0) {
#pragma unroll (S::UNROLL)
    for (int j = 0; j < nv; ++j) {
      Vw cur;
      if (cur.prep(packed, X, Y, s_cs[j], v0 + j, C, sid, dgamma, c_shift,
                   c_max, c0_max))
        cur.sum(acc);
    }
  } else {
    Vw nxt;
    bool in_n = nxt.prep(packed, X, Y, s_cs[0], v0, C, sid, dgamma, c_shift,
                         c_max, c0_max);
#pragma unroll 1
    for (int j = 0; j < nv; ++j) {
      const Vw cur = nxt;
      const bool in_c = in_n;
      in_n = j + 1 < nv && nxt.prep(packed, X, Y, s_cs[j + 1], v0 + j + 1,
                                    C, sid, dgamma, c_shift, c_max, c0_max);
      if (in_c) cur.sum(acc);
    }
  }
}

template <int K, class S>
__global__ void __launch_bounds__(16 * S::BH, S::MINB) step_kernel(
    const float* __restrict__ packed, const float* __restrict__ cos_b,
    const float* __restrict__ sin_b, float* __restrict__ out, int V, int C,
    int N, float px, float half, float sid, float dgamma, float dbeta) {
  __shared__ float2 s_cs[kChunk];
  constexpr int TH = 32 / S::TW, WX = 16 / S::TW, NT = 16 * S::BH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ix = blockIdx.x * 16 + (warp % WX) * S::TW + lane % S::TW;
  const int iy = blockIdx.y * S::BH + (warp / WX) * TH + lane / S::TW;
  const bool valid = ix < N && iy < N;
  const float X = ((float)ix + 0.5f - half) * px;
  const float Y = ((float)iy + 0.5f - half) * px;
  const float c_shift = 0.5f * (float)C;
  const float c_max = (float)(C - 1);
  const float c0_max = (float)(C - 2);

  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0f;
  for (int v0 = 0; v0 < V; v0 += kChunk) {
    const int nv = min(kChunk, V - v0);
    __syncthreads();
#pragma unroll 1
    for (int i = threadIdx.x; i < nv; i += NT)
      s_cs[i] = make_float2(cos_b[v0 + i], sin_b[v0 + i]);
    __syncthreads();
    if (valid)
      chunk<K, S>(packed, s_cs, v0, nv, X, Y, C, sid, dgamma, c_shift, c_max,
                  c0_max, acc);
  }
  if (!valid) return;
  const size_t plane = (size_t)N * N;
#pragma unroll
  for (int k = 0; k < K; ++k)
    out[k * plane + (size_t)iy * N + ix] = __fmul_rn(acc[k], dbeta);
}

// two pixels a thread, rows iy and iy + 16 of a 16 x 32 block of 256
// threads in 8 x 4 warp tiles; the settings' other fields as above
template <int K, class S>
__global__ void __launch_bounds__(256, S::MINB) two_px_kernel(
    const float* __restrict__ packed, const float* __restrict__ cos_b,
    const float* __restrict__ sin_b, float* __restrict__ out, int V, int C,
    int N, float px, float half, float sid, float dgamma, float dbeta) {
  __shared__ float2 s_cs[kChunk];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ix = blockIdx.x * 16 + (warp % 2) * 8 + lane % 8;
  const int iy0 = blockIdx.y * 32 + (warp / 2) * 4 + lane / 8;
  const float X = ((float)ix + 0.5f - half) * px;
  float Y[2];
  bool valid[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    valid[p] = ix < N && iy0 + 16 * p < N;
    Y[p] = ((float)(iy0 + 16 * p) + 0.5f - half) * px;
  }
  const float c_shift = 0.5f * (float)C;
  const float c_max = (float)(C - 1);
  const float c0_max = (float)(C - 2);
  float acc[2][K];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int k = 0; k < K; ++k) acc[p][k] = 0.0f;
  using Vw = View<K, S>;
  for (int v0 = 0; v0 < V; v0 += kChunk) {
    const int nv = min(kChunk, V - v0);
    __syncthreads();
#pragma unroll 1
    for (int i = threadIdx.x; i < nv; i += 256)
      s_cs[i] = make_float2(cos_b[v0 + i], sin_b[v0 + i]);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < nv; ++j) {
      const float2 cs = s_cs[j];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        Vw cur;
        if (valid[p] && cur.prep(packed, X, Y[p], cs, v0 + j, C, sid, dgamma,
                                 c_shift, c_max, c0_max))
          cur.sum(acc[p]);
      }
    }
  }
  const size_t plane = (size_t)N * N;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    if (!valid[p]) continue;
#pragma unroll
    for (int k = 0; k < K; ++k)
      out[k * plane + (size_t)(iy0 + 16 * p) * N + ix] =
          __fmul_rn(acc[p][k], dbeta);
  }
}

template <int K, class S>
void launch_step(const float* p, const float* cb, const float* sb, float* o,
                 int V, int C, int N, float px, float half, float sid,
                 float dgamma, float dbeta, cudaStream_t st) {
  const dim3 blocks((N + 15) / 16, (N + S::BH - 1) / S::BH);
  step_kernel<K, S><<<blocks, 16 * S::BH, 0, st>>>(p, cb, sb, o, V, C, N, px,
                                                   half, sid, dgamma, dbeta);
}

template <int K, class S>
void launch_two_px(const float* p, const float* cb, const float* sb,
                   float* o, int V, int C, int N, float px, float half,
                   float sid, float dgamma, float dbeta, cudaStream_t st) {
  const dim3 blocks((N + 15) / 16, (N + 31) / 32);
  two_px_kernel<K, S><<<blocks, 256, 0, st>>>(p, cb, sb, o, V, C, N, px,
                                              half, sid, dgamma, dbeta);
}

template <int K>
void launch_parent(const float* p, const float* cb, const float* sb,
                   float* o, int V, int C, int N, float px, float half,
                   float sid, float dgamma, float dbeta, cudaStream_t st) {
  const dim3 blocks((N + 15) / 16, (N + 15) / 16);
  parent_kernel<K><<<blocks, dim3(16, 16), 0, st>>>(p, cb, sb, o, V, C, N,
                                                    px, half, sid, dgamma,
                                                    dbeta);
}

// the variants, in the order of probe_k4_steps.STEPS
template <int K>
int run(int variant, const float* p, const float* cb, const float* sb,
        float* o, int V, int C, int N, float px, float half, float sid,
        float dgamma, float dbeta, cudaStream_t st) {
#define A p, cb, sb, o, V, C, N, px, half, sid, dgamma, dbeta, st
  // Cfg<TW, BH, VEC, OFF32, UNROLL, MINB, RCP, INNER, OUTER>
  switch (variant) {
    case 0: launch_parent<K>(A); break;
    case 1: launch_step<K, Cfg<16, 16, false, false, 1, 1, false>>(A); break;
    case 2: launch_step<K, Cfg<16, 16, false, false, 1, 1, false, 1>>(A);
      break;
    case 3: launch_step<K, Cfg<16, 16, false, false, 1, 1, false, 2>>(A);
      break;
    case 4: launch_step<K, Cfg<16, 16, false, false, 1, 1, false, 0, 1>>(A);
      break;
    case 5: launch_step<K, Cfg<16, 16, true, false, 1, 1, false>>(A); break;
    case 6: launch_step<K, Cfg<16, 16, true, true, 1, 1, false>>(A); break;
    case 7: launch_step<K, Cfg<8, 16, true, true, 1, 1, false>>(A); break;
    case 8: launch_step<K, Cfg<4, 16, true, true, 1, 1, false>>(A); break;
    case 9: launch_step<K, Cfg<8, 8, true, true, 1, 1, false>>(A); break;
    case 10: launch_step<K, Cfg<8, 32, true, true, 1, 1, false>>(A); break;
    case 11: launch_step<K, Cfg<8, 16, true, true, 1, 8, false>>(A); break;
    case 12: launch_step<K, Cfg<8, 32, true, true, 1, 4, false>>(A); break;
    case 13: launch_step<K, Cfg<8, 32, true, true, 1, 4, true>>(A); break;
    case 14: launch_step<K, Cfg<8, 32, true, true, 0, 1, true>>(A); break;
    case 15: launch_step<K, Cfg<8, 32, true, true, 2, 4, true>>(A); break;
    case 16: launch_step<K, Cfg<8, 32, true, true, 4, 4, true>>(A); break;
    case 17: launch_step<K, Cfg<8, 32, true, true, 8, 4, true>>(A); break;
    case 18: launch_two_px<K, Cfg<8, 32, true, true, 2, 4, true>>(A); break;
    case 19: launch_two_px<K, Cfg<8, 32, true, true, 2, 2, true>>(A); break;
    case 20: launch_step<K, Cfg<8, 32, false, true, 8, 4, true>>(A); break;
    case 21: launch_step<K, Cfg<8, 32, true, false, 8, 4, true>>(A); break;
    case 22: launch_step<K, Cfg<8, 32, true, true, 8, 4, false>>(A); break;
    case 23: launch_step<K, Cfg<16, 32, true, true, 8, 4, true>>(A); break;
    case 24: launch_step<K, Cfg<4, 32, true, true, 8, 4, true>>(A); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef A
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int k4_step(int variant, int K, const void* packed,
                       const void* cos_b, const void* sin_b, void* out,
                       int V, int C, int N, float px, float half, float sid,
                       float dgamma, float dbeta, void* stream) {
  const float* p = static_cast<const float*>(packed);
  const float* cb = static_cast<const float*>(cos_b);
  const float* sb = static_cast<const float*>(sin_b);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1:
      return run<1>(variant, p, cb, sb, o, V, C, N, px, half, sid, dgamma,
                    dbeta, st);
    case 3:
      return run<3>(variant, p, cb, sb, o, V, C, N, px, half, sid, dgamma,
                    dbeta, st);
    case 4:
      return run<4>(variant, p, cb, sb, o, V, C, N, px, half, sid, dgamma,
                    dbeta, st);
  }
  return (int)cudaErrorInvalidValue;
}
