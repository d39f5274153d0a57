// K4 fan_backproject: equiangular fan-beam backprojection of K images;
// K25 fan_backproject_var: the squared-weight backprojection of the
// filtered variance and lag-1 covariance of F fields; K30
// fan_backproject_motion: K4 with each view's rigid pose; K31
// gated_backproject: K4 with per-view gate weights and a per-pixel
// normalisation (K25, K30 and K31 below).
//
// Replaces the TPU programs dexct_tpu/ops/fbp_fast.py:fan_backproject_multi
// (a lax.scan over 32-view blocks whose body gathers one packed row of all
// 2K taps per (view, pixel)) and dexct_tpu/ops/fbp.py:fan_backproject (the
// one-image form, K = 1 here).
//
// What bounds it on the card: per (pixel, view) one atan2, two IEEE
// divisions and ~20 other float ops, plus one row of 2K floats of the
// packed tap table (25.6 MB at 4 x 1000 x 800, resident in L2).  N^2 x V =
// 2.6e8 pixel-views at the reference protocol, ~115 instructions each on
// the path of a view inside the fan (K = 4; atan2 ~48 of them), so the
// SMs' issue rate bounds it, then the gathers' L1 wavefronts.  Design: one
// thread per output pixel loops over all views and keeps the K sums in
// registers, so the output [K, N, N] is written once with no atomics;
// cos/sin of the view angles come from shared memory as one float2
// (staged in chunks of kChunk views); the packed table
// pack_filtered([K, V, C]) -> [V*C, 2K] lets one row fetch serve both
// linear-interpolation taps of all K images, and the row comes in 16-byte
// loads (two at K = 4, one at K = 2; 8-byte loads at K = 1 and 3) at a
// 32-bit offset, which cuts the L1 wavefronts of a warp's gather from
// eight scalar loads' to two.  The lanes of a warp hold an 8 x 4 pixel
// tile, blocks are 16 x 32 pixels with 32 registers a thread (64 warps an
// SM), and the view loop is unrolled by 8.  The geometry and the sums are
// the parent design's operations in its order, each rounding explicit
// (fan_tap, and the contraction nvcc had chosen for the sum: fma(q[c0],
// 1 - f, f q[c0+1]), then fma(tap, w, acc); 1 / l2 correctly rounded), so
// the output is bit for bit that of the kernel with scalar loads and 16 x 2
// warps it replaced.
//
// Per view, as the JAX program: vr = X cos b + Y sin b - sid,
// vt = -X sin b + Y cos b, gamma = atan2(-vt, -vr),
// c = gamma / dgamma - 0.5 + C/2, c0 = clamp(floor(c), 0, C-2),
// f = clamp(c - c0, 0, 1), inside = 0 <= c <= C-1, weight 1/(vr^2 + vt^2);
// the packed row at c0 holds q[c0] and q[c0+1] (pack_filtered's
// last-channel rule repeats q[C-1] only at c = C-1, which c0 never
// reaches).  The sum is multiplied by dbeta at the end.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 1024;

// The channel coordinate of pixel (X, Y) in the view (cos b, sin b), in the
// JAX programs' operation order with no fused multiply-add (the hard
// fan-edge test must flip where the reference's does): vr, vt, gamma =
// atan2(-vt, -vr), c = gamma / dgamma - 0.5 + C/2.  Returns false outside
// the fan (c < 0 or c > C - 1); else c0 = clamp(floor(c), 0, C - 2), the
// tap fraction f = clamp(c - c0, 0, 1) and l2 = vr^2 + vt^2.  K4, K25, K30
// and K31 share it.
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

// K4's pixel tiles: a block of kBlockW x kBlockH pixels, one thread each;
// the lanes of a warp hold a kTileW x (32 / kTileW) tile of it
constexpr int kBlockW = 16;
constexpr int kBlockH = 32;
constexpr int kTileW = 8;
constexpr int kThreads = kBlockW * kBlockH;
// blocks an SM keeps resident (64 warps): caps the registers at 32 a thread
constexpr int kMinBlocks = 4;

// One packed row: a[k] = q_k[c0], b[k] = q_k[c0 + 1], from 2K floats at p
// (16-byte aligned: the wrapper checks the table, and a row of 2K floats
// starts at a multiple of 8K bytes).
template <int K>
struct Row {
  float a[K];
  float b[K];
};

template <int K>
__device__ __forceinline__ Row<K> load_row(const float* __restrict__ p) {
  if constexpr (K == 4) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
    return {{lo.x, lo.y, lo.z, lo.w}, {hi.x, hi.y, hi.z, hi.w}};
  } else if constexpr (K == 3) {
    const float2 t0 = __ldg(reinterpret_cast<const float2*>(p));
    const float2 t1 = __ldg(reinterpret_cast<const float2*>(p) + 1);
    const float2 t2 = __ldg(reinterpret_cast<const float2*>(p) + 2);
    return {{t0.x, t0.y, t1.x}, {t1.y, t2.x, t2.y}};
  } else if constexpr (K == 2) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    return {{t.x, t.y}, {t.z, t.w}};
  } else {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    return {{t.x}, {t.y}};
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    fan_backproject_kernel(const float* __restrict__ packed,
                           const float* __restrict__ cos_b,
                           const float* __restrict__ sin_b,
                           float* __restrict__ out, int V, int C, int N,
                           float px, float half, float sid, float dgamma,
                           float dbeta) {
  __shared__ float2 s_cs[kChunk];  // (cos b, sin b) of a chunk of views
  constexpr int kTileH = 32 / kTileW;
  constexpr int kWarpsW = kBlockW / kTileW;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ix = blockIdx.x * kBlockW + (warp % kWarpsW) * kTileW +
                 lane % kTileW;
  const int iy = blockIdx.y * kBlockH + (warp / kWarpsW) * kTileH +
                 lane / kTileW;
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
    for (int i = threadIdx.x; i < nv; i += kThreads)
      s_cs[i] = make_float2(cos_b[v0 + i], sin_b[v0 + i]);
    __syncthreads();
    if (!valid) continue;
    // the table's row index v C + c0 < 2^31 / (2K): the wrapper refuses a
    // table of 2^31 floats or more
    int row_v = v0 * C;
#pragma unroll 8
    for (int j = 0; j < nv; ++j, row_v += C) {
      const float2 cs = s_cs[j];
      float c0, f, l2;
      if (!fan_tap(X, Y, cs.x, cs.y, sid, dgamma, c_shift, c_max, c0_max,
                   c0, f, l2))
        continue;  // outside the fan
      const float w = __frcp_rn(l2);  // 1 / l2, IEEE-rounded
      const Row<K> r =
          load_row<K>(packed + (row_v + __float2int_rz(c0)) * (2 * K));
      const float g = __fsub_rn(1.0f, f);
#pragma unroll
      for (int k = 0; k < K; ++k)
        acc[k] = __fmaf_rn(w, __fmaf_rn(r.a[k], g, __fmul_rn(r.b[k], f)),
                           acc[k]);
    }
  }
  if (!valid) return;
  const size_t plane = (size_t)N * N;
#pragma unroll
  for (int k = 0; k < K; ++k)
    out[k * plane + (size_t)iy * N + ix] = __fmul_rn(acc[k], dbeta);
}

template <int K>
void launch(const float* packed, const float* cos_b, const float* sin_b,
            float* out, int V, int C, int N, float px, float half, float sid,
            float dgamma, float dbeta, cudaStream_t stream) {
  const dim3 blocks((N + kBlockW - 1) / kBlockW, (N + kBlockH - 1) / kBlockH);
  fan_backproject_kernel<K><<<blocks, kThreads, 0, stream>>>(
      packed, cos_b, sin_b, out, V, C, N, px, half, sid, dgamma, dbeta);
}

}  // namespace

// Refuses (cudaErrorInvalidValue) a table that is not 16-byte aligned or
// holds 2^31 floats or more, as the wrapper does before it calls here.
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
  if (reinterpret_cast<uintptr_t>(packed) % 16 != 0 ||
      (long long)V * C * 2 * n_images > INT_MAX)
    return (int)cudaErrorInvalidValue;
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

// K25 fan_backproject_var: replaces the TPU program
// dexct_tpu/ops/noisemap.py:_fan_backproject_var (a lax.scan over 64-view
// blocks, each a vmap over views of a full-image gather of the filtered
// variance r0 and lag-1 covariance r1).  Per (pixel, view) inside the fan
// it adds
//     ((1-f)^2 r0[c0] + f^2 r0[c0+1] + 2 f (1-f) r1[c0]) / l2^2
// for each of F fields and multiplies the sum by dbeta^2: the variance of
// the linear-interpolation backprojection, with the taps' covariance.
//
// What bounds it on the card: as K4, one atan2 and ~30 float operations per
// (pixel, view) for the geometry plus 9 per field; N^2 x V = 2.6e8
// pixel-views at the reference protocol, so arithmetic.  Design: K4's
// kernel with fan_tap() shared, one thread per pixel over all views, cos
// and sin of the views in shared memory, the F sums in registers (the dual
// energy noise map's three fields var1, var2, cov12 share one launch and
// one geometry), the output written once with no atomics.  r0 and r1
// [F, V, C] are read directly: three taps per field from rows that
// neighbouring pixels share (L1/L2 resident).
namespace {

template <int F>
__global__ void fan_backproject_var_kernel(
    const float* __restrict__ r0, const float* __restrict__ r1,
    const float* __restrict__ cos_b, const float* __restrict__ sin_b,
    float* __restrict__ out, int V, int C, int N, float px, float half,
    float sid, float dgamma, float dbeta2) {
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
  const size_t field = (size_t)V * C;

  float acc[F];
#pragma unroll
  for (int k = 0; k < F; ++k) acc[k] = 0.0f;

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
      // the JAX program's order: (1-f)^2 r0[c0] + f f r0[c0+1]
      // + (2 f)(1-f) r1[c0], then / (l2 l2)
      const float g = __fsub_rn(1.0f, f);
      const float a0 = __fmul_rn(g, g);
      const float a1 = __fmul_rn(f, f);
      const float a2 = __fmul_rn(__fmul_rn(2.0f, f), g);
      const float l4 = __fmul_rn(l2, l2);
      const size_t base = (size_t)(v0 + j) * C + (size_t)c0;
#pragma unroll
      for (int k = 0; k < F; ++k) {
        const float* q0 = r0 + k * field + base;
        const float var = __fadd_rn(
            __fadd_rn(__fmul_rn(a0, __ldg(q0)), __fmul_rn(a1, __ldg(q0 + 1))),
            __fmul_rn(a2, __ldg(r1 + k * field + base)));
        acc[k] += __fdiv_rn(var, l4);
      }
    }
  }
  if (!valid) return;
  const size_t plane = (size_t)N * N;
#pragma unroll
  for (int k = 0; k < F; ++k)
    out[k * plane + (size_t)iy * N + ix] = acc[k] * dbeta2;
}

template <int F>
void launch_var(const float* r0, const float* r1, const float* cos_b,
                const float* sin_b, float* out, int V, int C, int N,
                float px, float half, float sid, float dgamma, float dbeta2,
                cudaStream_t stream) {
  const dim3 threads(16, 16);
  const dim3 blocks((N + 15) / 16, (N + 15) / 16);
  fan_backproject_var_kernel<F><<<blocks, threads, 0, stream>>>(
      r0, r1, cos_b, sin_b, out, V, C, N, px, half, sid, dgamma, dbeta2);
}

}  // namespace

extern "C" int dexct_fan_backproject_var(const void* r0, const void* r1,
                                         const void* cos_b,
                                         const void* sin_b, void* out,
                                         int n_fields, int V, int C, int N,
                                         float px, float half, float sid,
                                         float dgamma, float dbeta2,
                                         void* stream) {
  const float* a = static_cast<const float*>(r0);
  const float* b = static_cast<const float*>(r1);
  const float* cb = static_cast<const float*>(cos_b);
  const float* sb = static_cast<const float*>(sin_b);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0) return (int)cudaGetLastError();
#define DEXCT_CASE(FF) \
  launch_var<FF>(a, b, cb, sb, o, V, C, N, px, half, sid, dgamma, dbeta2, st)
  switch (n_fields) {  // one map, or the three basis fields
    case 1: DEXCT_CASE(1); break;
    case 3: DEXCT_CASE(3); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef DEXCT_CASE
  return (int)cudaGetLastError();
}

// K30 fan_backproject_motion: replaces the TPU program
// dexct_tpu/ops/motion.py:fan_backproject_motion (a lax.scan over 64-view
// blocks, each a vmap over views of a full-image rotate/shift and gather).
// The rigid motion-compensated backprojection: view v evaluates pixel x at
// its world position under the view's pose, x_v = R(phi_v) x + d_v, and
// then adds K4's equiangular tap with its 1/l2 weight; the sum is
// multiplied by dbeta.
//
// What bounds it on the card: K4's arithmetic (one atan2, one reciprocal,
// ~20 float ops per pixel-view) plus 6 for the pose; N^2 x V = 2.6e8
// pixel-views at the reference protocol, so arithmetic.  Design: K4's, one
// thread per pixel over all views, the per-view cos b, sin b, cos phi,
// sin phi, dx and dy staged in shared memory (kChunk views at a time), the
// sum in a register, the image written once.  The posed coordinates are
// formed in the JAX order, Xv = (cos phi X - sin phi Y) + dx and Yv =
// (sin phi X + cos phi Y) + dy, each operation rounded (no FMA); at phi = d
// = 0 they are X and Y exactly, and the tap and sum below are K4's for one
// image, so K30 then returns K4's image bit for bit.  q [V, C] is read
// directly: q[c0] and q[c0 + 1] are the two halves of K4's packed row.
namespace {

__global__ void fan_backproject_motion_kernel(
    const float* __restrict__ q, const float* __restrict__ cos_b,
    const float* __restrict__ sin_b, const float* __restrict__ cos_p,
    const float* __restrict__ sin_p, const float* __restrict__ dx,
    const float* __restrict__ dy, float* __restrict__ out, int V, int C,
    int N, float px, float half, float sid, float dgamma, float dbeta) {
  __shared__ float s_cb[kChunk];
  __shared__ float s_sb[kChunk];
  __shared__ float s_cp[kChunk];
  __shared__ float s_sp[kChunk];
  __shared__ float s_dx[kChunk];
  __shared__ float s_dy[kChunk];
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

  float acc = 0.0f;
  for (int v0 = 0; v0 < V; v0 += kChunk) {
    const int nv = min(kChunk, V - v0);
    __syncthreads();
    for (int i = tid; i < nv; i += nthreads) {
      s_cb[i] = cos_b[v0 + i];
      s_sb[i] = sin_b[v0 + i];
      s_cp[i] = cos_p[v0 + i];
      s_sp[i] = sin_p[v0 + i];
      s_dx[i] = dx[v0 + i];
      s_dy[i] = dy[v0 + i];
    }
    __syncthreads();
    if (!valid) continue;
    for (int j = 0; j < nv; ++j) {
      const float cp = s_cp[j], sp = s_sp[j];
      const float Xv = __fadd_rn(__fsub_rn(__fmul_rn(cp, X), __fmul_rn(sp, Y)),
                                 s_dx[j]);
      const float Yv = __fadd_rn(__fadd_rn(__fmul_rn(sp, X), __fmul_rn(cp, Y)),
                                 s_dy[j]);
      float c0, f, l2;
      if (!fan_tap(Xv, Yv, s_cb[j], s_sb[j], sid, dgamma, c_shift, c_max,
                   c0_max, c0, f, l2))
        continue;  // outside the fan
      const float w = __fdiv_rn(1.0f, l2);
      const float* row = q + (size_t)(v0 + j) * C + (size_t)c0;
      acc += w * (__ldg(row) * (1.0f - f) + __ldg(row + 1) * f);
    }
  }
  if (!valid) return;
  out[(size_t)iy * N + ix] = acc * dbeta;
}

// K31 gated_backproject: replaces the TPU program
// dexct_tpu/pipeline/gated.py:_gated_backproject (a lax.scan over 64-view
// blocks of a vmap over views, carrying num and den images).  Per (pixel,
// view) inside the fan K4's tap qi = q[c0] (1 - f) + q[c0 + 1] f adds
// (qi / l2) w[g, v] to num[g] and w[g, v] to den[g], for each of G gate
// weightings of the same filtered sinogram; out[g] = (den > 0 ? num /
// max(den, 1e-30) : 0) 2 pi, the per-pixel weighted mean over the views that
// reached it.
//
// What bounds it on the card: K4's per pixel-view geometry (one atan2, ~20
// float ops) plus 4 per gate; N^2 x V = 1e9 pixel-views for a 4-rotation
// scan at the reference protocol, so arithmetic.  Design: one thread per
// pixel over all views, cos b, sin b and the G weights of a chunk of views
// in shared memory, num and den of all G gates in registers (gated_series
// sends its gates through one launch, which computes the geometry once),
// the G images written once; a view whose G weights are all 0 adds exact
// zeros in the JAX program and is skipped.
template <int G>
__global__ void gated_backproject_kernel(
    const float* __restrict__ q, const float* __restrict__ cos_b,
    const float* __restrict__ sin_b, const float* __restrict__ w,
    float* __restrict__ out, int V, int C, int N, float px, float half,
    float sid, float dgamma) {
  constexpr int kGChunk = 512;
  __shared__ float s_cos[kGChunk];
  __shared__ float s_sin[kGChunk];
  __shared__ float s_w[G][kGChunk];
  __shared__ int s_any[kGChunk];
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

  float num[G], den[G];
#pragma unroll
  for (int g = 0; g < G; ++g) num[g] = den[g] = 0.0f;

  for (int v0 = 0; v0 < V; v0 += kGChunk) {
    const int nv = min(kGChunk, V - v0);
    __syncthreads();
    for (int i = tid; i < nv; i += nthreads) {
      s_cos[i] = cos_b[v0 + i];
      s_sin[i] = sin_b[v0 + i];
      int any = 0;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float wg = w[(size_t)g * V + v0 + i];
        s_w[g][i] = wg;
        any |= wg != 0.0f;
      }
      s_any[i] = any;
    }
    __syncthreads();
    if (!valid) continue;
    for (int j = 0; j < nv; ++j) {
      if (!s_any[j]) continue;  // every gate adds exact zeros
      float c0, f, l2;
      if (!fan_tap(X, Y, s_cos[j], s_sin[j], sid, dgamma, c_shift, c_max,
                   c0_max, c0, f, l2))
        continue;  // outside the fan: num and den add zeros
      const float* row = q + (size_t)(v0 + j) * C + (size_t)c0;
      const float qi = __fadd_rn(__fmul_rn(__ldg(row), __fsub_rn(1.0f, f)),
                                 __fmul_rn(__ldg(row + 1), f));
      const float ql = __fdiv_rn(qi, l2);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        num[g] = __fadd_rn(num[g], __fmul_rn(ql, s_w[g][j]));
        den[g] = __fadd_rn(den[g], s_w[g][j]);
      }
    }
  }
  if (!valid) return;
  const size_t plane = (size_t)N * N;
  const float two_pi = 6.28318530717958647692f;  // float32(2 pi)
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float o =
        den[g] > 0.0f ? __fdiv_rn(num[g], fmaxf(den[g], 1e-30f)) : 0.0f;
    out[g * plane + (size_t)iy * N + ix] = __fmul_rn(o, two_pi);
  }
}

}  // namespace

extern "C" int dexct_fan_backproject_motion(
    const void* q, const void* cos_b, const void* sin_b, const void* cos_p,
    const void* sin_p, const void* dx, const void* dy, void* out, int V,
    int C, int N, float px, float half, float sid, float dgamma, float dbeta,
    void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  if (C < 2) return (int)cudaErrorInvalidValue;
  const dim3 threads(16, 16);
  const dim3 blocks((N + 15) / 16, (N + 15) / 16);
  fan_backproject_motion_kernel<<<blocks, threads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(cos_b),
      static_cast<const float*>(sin_b), static_cast<const float*>(cos_p),
      static_cast<const float*>(sin_p), static_cast<const float*>(dx),
      static_cast<const float*>(dy), static_cast<float*>(out), V, C, N, px,
      half, sid, dgamma, dbeta);
  return (int)cudaGetLastError();
}

extern "C" int dexct_gated_backproject(const void* q, const void* cos_b,
                                       const void* sin_b, const void* w,
                                       void* out, int n_gates, int V, int C,
                                       int N, float px, float half, float sid,
                                       float dgamma, void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  if (C < 2) return (int)cudaErrorInvalidValue;
  const float* qq = static_cast<const float*>(q);
  const float* cb = static_cast<const float*>(cos_b);
  const float* sb = static_cast<const float*>(sin_b);
  const float* ww = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 threads(16, 16);
  const dim3 blocks((N + 15) / 16, (N + 15) / 16);
#define DEXCT_CASE(GG)                                             \
  gated_backproject_kernel<GG><<<blocks, threads, 0, st>>>(        \
      qq, cb, sb, ww, o, V, C, N, px, half, sid, dgamma)
  switch (n_gates) {  // one gate, or a series of up to four per launch
    case 1: DEXCT_CASE(1); break;
    case 2: DEXCT_CASE(2); break;
    case 3: DEXCT_CASE(3); break;
    case 4: DEXCT_CASE(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef DEXCT_CASE
  return (int)cudaGetLastError();
}
