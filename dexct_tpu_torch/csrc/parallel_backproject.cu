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
// What bounds it on the card: per (pixel, view) ~44 instructions at K = 4
// and ~35 at K = 1 (the channel coordinate with its IEEE division ~15, the
// clamps and the row address ~10, 3 a tap) and one row of 2K floats of the
// packed tap table (16.8 MB at 4 x 512 x 1024, resident in L2).  1.05e8
// in-disc pixel-views at the reference protocol (512 views, 79% of 512^2
// pixels): an issue floor of ~0.16 ms at K = 4.  The rows' gathers come
// close: a 16-byte load is served a quarter-warp (8 lanes) at a time, one
// L1 wavefront per 128-byte line each quarter touches, and neighbouring
// pixels sit ~2 channels (~64 bytes at K = 4) apart.  Design: one thread
// per output pixel (two at K = 4) loops over all views and keeps the K
// sums in registers, so the output is written once with no atomics;
// cos/sin of the view angles come from shared memory as one float2
// (staged in chunks of kChunk views).  A warp holds an 8 x 4 pixel tile
// whose quarters are 4 x 2 tiles, so each quarter's rows of a view span
// ~6 channels where a 16 x 2 strip's span ~15; each packed row arrives in
// 16-byte loads (two at K = 4, one at K = 2) or 8-byte loads (one at
// K = 1, three at K = 3) at a 32-bit offset; and the rows of kViews views
// are loaded before their sums are formed (each row is loaded whatever
// its view's test, c0 being clamped into the table), so several gathers
// are in flight a thread.  Blocks are 2 warps: 8 x 8 pixels, 8 x 16 at
// K = 4, whose second pixel a thread lies 8 rows below its first.
// Pixels outside the disc (the host's float64 mask, as the JAX program
// builds it) skip the loop and write 0.
//
// Per view, as the JAX program: c = (X cos t + Y sin t - t0) / dt,
// c0 = clamp(floor(c), 0, nt-2), f = clamp(c - c0, 0, 1), and the view
// counts only where 0 <= c <= nt-1.  Every rounding is explicit: the
// channel coordinate with no fused multiply-add (the edge tests must flip
// where the reference's do) and an IEEE division, the tap as the
// contraction nvcc chose for the kernel this one replaced (read from its
// SASS: fma(q[c0], 1 - f, f q[c0+1])), added to the sum in view order.
// So the output is bit for bit that of the kernel with scalar loads and
// 16 x 2 warps it replaced.  The sum is multiplied by dtheta at the end.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 1024;

// K6's tiling at K images: kPix pixels a thread, kViews views whose rows
// are loaded before their sums (two and two at K = 4, where the rows are
// widest; else one and four: the steps measured in
// tools/probe_parallel_backproject.py --steps)
template <int K>
struct Tiling {
  static constexpr int kPix = K == 4 ? 2 : 1;
  static constexpr int kViews = K == 4 ? 2 : 4;
};
// a block: 2 warps of 8 x 4 pixels, kBlockW x kThreadRows threads; one
// block an SM at least, which leaves ptxas the registers to keep the rows
// of kViews views in flight (the steps' setting)
constexpr int kBlockW = 8;
constexpr int kThreadRows = 8;
constexpr int kThreads = kBlockW * kThreadRows;
constexpr int kMinBlocks = 1;

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

// The channel coordinate of pixel (X, Y) in the view cs = (cos t, sin t),
// in the JAX program's operations with no fused multiply-add (the edge
// tests must flip where the reference's do): c = (X cos t + Y sin t - t0)
// / dt.  Returns whether the view reaches the detector (0 <= c <= nt - 1);
// c0 = clamp(floor(c), 0, nt - 2), as an int, and f = clamp(c - c0, 0, 1)
// whatever it returns (c0 is then a row inside the table).
__device__ __forceinline__ bool channel(float X, float Y, float2 cs, float t0,
                                        float dt, float c_max, float c0_max,
                                        int& c0i, float& f) {
  const float c = __fdiv_rn(
      __fsub_rn(__fadd_rn(__fmul_rn(X, cs.x), __fmul_rn(Y, cs.y)), t0), dt);
  const float c0 = fminf(fmaxf(floorf(c), 0.0f), c0_max);
  f = fminf(fmaxf(__fsub_rn(c, c0), 0.0f), 1.0f);
  c0i = __float2int_rz(c0);
  return c >= 0.0f && c <= c_max;
}

// V views, j to j + V - 1 of the chunk in s_cs (their rows from row_v, nt
// rows a view), added to the sums of a thread's P pixels (X, Y[p]; valid[p]
// in the disc): every row loaded first, then the sums in view order; the
// tap as the parent's nvcc contracted it, fma(q[c0], 1 - f, f q[c0+1])
template <int K, int P, int V>
__device__ __forceinline__ void add_views(
    const float* __restrict__ packed, const float2* s_cs, int j, int row_v,
    int nt, float X, const float (&Y)[P], const bool (&valid)[P], float t0,
    float dt, float c_max, float c0_max, float (&acc)[P][K]) {
  Row<K> r[V][P];
  float f[V][P];
  bool on[V][P];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const float2 cs = s_cs[j + u];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      int c0i;
      on[u][p] =
          channel(X, Y[p], cs, t0, dt, c_max, c0_max, c0i, f[u][p]) &&
          valid[p];
      r[u][p] = load_row<K>(packed + (row_v + u * nt + c0i) * (2 * K));
    }
  }
#pragma unroll
  for (int u = 0; u < V; ++u)
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float g = __fsub_rn(1.0f, f[u][p]);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float t = __fmaf_rn(r[u][p].a[k], g,
                                  __fmul_rn(r[u][p].b[k], f[u][p]));
        if (on[u][p]) acc[p][k] = __fadd_rn(acc[p][k], t);
      }
    }
}

template <int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    parallel_backproject_kernel(const float* __restrict__ packed,
                                const float* __restrict__ cos_t,
                                const float* __restrict__ sin_t,
                                const unsigned char* __restrict__ mask,
                                float* __restrict__ out, int n_theta, int nt,
                                int N, float px, float half, float t0,
                                float dt, float dtheta) {
  constexpr int P = Tiling<K>::kPix;
  constexpr int V = Tiling<K>::kViews;
  __shared__ float2 s_cs[kChunk];  // (cos t, sin t) of a chunk of views
  // the lane's pixel: quarter q of its warp's 8 x 4 tile is a 4 x 2 tile
  const int lane = threadIdx.x & 31;
  const int q = lane >> 3, l = lane & 7;
  const int ix = blockIdx.x * kBlockW + (q & 1) * 4 + (l & 3);
  const int iy0 = blockIdx.y * (kThreadRows * P) + (threadIdx.x >> 5) * 4 +
                  (q >> 1) * 2 + (l >> 2);
  // pixel centres in the JAX program's operation order
  const float X = __fmul_rn(__fsub_rn(__fadd_rn((float)ix, 0.5f), half), px);
  float Y[P];
  bool valid[P];
  bool any = false;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int iy = iy0 + p * kThreadRows;
    Y[p] = __fmul_rn(__fsub_rn(__fadd_rn((float)iy, 0.5f), half), px);
    valid[p] = ix < N && iy < N &&
               (mask == nullptr || mask[(size_t)iy * N + ix] != 0);
    any |= valid[p];
  }
  const float c_max = (float)(nt - 1);
  const float c0_max = (float)(nt - 2);

  float acc[P][K];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int k = 0; k < K; ++k) acc[p][k] = 0.0f;

  for (int v0 = 0; v0 < n_theta; v0 += kChunk) {
    const int nv = min(kChunk, n_theta - v0);
    __syncthreads();
    for (int i = threadIdx.x; i < nv; i += kThreads)
      s_cs[i] = make_float2(cos_t[v0 + i], sin_t[v0 + i]);
    __syncthreads();
    if (!any) continue;
    // the table's row index v nt + c0 < 2^31 / (2K): the wrapper refuses
    // a table of 2^31 floats or more
    int j = 0, row_v = v0 * nt;
    for (; j + V <= nv; j += V, row_v += V * nt)
      add_views<K, P, V>(packed, s_cs, j, row_v, nt, X, Y, valid, t0, dt,
                         c_max, c0_max, acc);
    for (; j < nv; ++j, row_v += nt)
      add_views<K, P, 1>(packed, s_cs, j, row_v, nt, X, Y, valid, t0, dt,
                         c_max, c0_max, acc);
  }
  const size_t plane = (size_t)N * N;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int iy = iy0 + p * kThreadRows;
    if (ix >= N || iy >= N) continue;
#pragma unroll
    for (int k = 0; k < K; ++k)
      out[k * plane + (size_t)iy * N + ix] =
          valid[p] ? __fmul_rn(acc[p][k], dtheta) : 0.0f;
  }
}

template <int K>
void launch(const float* packed, const float* cos_t, const float* sin_t,
            const unsigned char* mask, float* out, int n_theta, int nt,
            int N, float px, float half, float t0, float dt, float dtheta,
            cudaStream_t stream) {
  constexpr int kBlockH = kThreadRows * Tiling<K>::kPix;
  const dim3 blocks((N + kBlockW - 1) / kBlockW, (N + kBlockH - 1) / kBlockH);
  parallel_backproject_kernel<K><<<blocks, kThreads, 0, stream>>>(
      packed, cos_t, sin_t, mask, out, n_theta, nt, N, px, half, t0, dt,
      dtheta);
}

}  // namespace

// packed [n_theta * nt, 2K]; cos_t, sin_t [n_theta]; mask [N * N] uint8 or
// null (every pixel); out [K, N, N].  Refuses (cudaErrorInvalidValue) a
// table that is not 16-byte aligned or holds 2^31 floats or more, as the
// wrapper does before it calls here.
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
  if (reinterpret_cast<uintptr_t>(packed) % 16 != 0 ||
      (long long)n_theta * nt * 2 * n_images > INT_MAX)
    return (int)cudaErrorInvalidValue;
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
