// The steps of K6's redesign as kernel variants, for
// tools/probe_parallel_backproject.py --steps (not part of the package's
// kernel library).
//
// Variant 0 is K6 as it stood before the redesign
// (csrc/parallel_backproject.cu at that commit): one thread per pixel in
// 16 x 16 blocks whose warps hold 16 x 2 pixels, cos/sin from shared
// memory, the packed row in 2K scalar loads at a 64-bit offset behind a
// branch per view, and the sum written as acc += a (1 - f) + b f for nvcc
// to contract.  step_kernel is every other setting but the staged one,
// one template instance per variant (the table in run() names each
// variant's settings; the probe holds the same table by name): warp tile,
// block, scalar or vector row loads, views unrolled or their rows loaded
// before their sums, pixels a thread, the register cap, the tap's
// contraction; staged_kernel copies each block's channel window of a
// chunk of views into shared memory with cp.async before it reads it.  All
// variants compute each pixel-view's channel coordinate, clamps and
// off-detector test in the parent's operations and add the views in view
// order, so they agree bit for bit with variant 0 wherever their tap is
// the contraction nvcc chose for it (INNER).

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 1024;

template <int K>
__global__ void parent_kernel(
    const float* __restrict__ packed, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, const unsigned char* __restrict__ mask,
    float* __restrict__ out, int n_theta, int nt, int N, float px,
    float half, float t0, float dt, float dtheta) {
  __shared__ float s_cos[kChunk];
  __shared__ float s_sin[kChunk];
  const int ix = blockIdx.x * blockDim.x + threadIdx.x;
  const int iy = blockIdx.y * blockDim.y + threadIdx.y;
  const size_t pix = (size_t)iy * N + ix;
  const bool valid =
      ix < N && iy < N && (mask == nullptr || mask[pix] != 0);
  const float X = __fmul_rn(__fsub_rn(__fadd_rn((float)ix, 0.5f), half), px);
  const float Y = __fmul_rn(__fsub_rn(__fadd_rn((float)iy, 0.5f), half), px);
  const float c_max = (float)(nt - 1);
  const float c0_max = (float)(nt - 2);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0f;

  for (int v0 = 0; v0 < n_theta; v0 += kChunk) {
    const int nv = min(kChunk, n_theta - v0);
    __syncthreads();
    for (int i = tid; i < nv; i += nthreads) {
      s_cos[i] = cos_t[v0 + i];
      s_sin[i] = sin_t[v0 + i];
    }
    __syncthreads();
    if (!valid) continue;
    for (int j = 0; j < nv; ++j) {
      const float c = __fdiv_rn(
          __fsub_rn(__fadd_rn(__fmul_rn(X, s_cos[j]), __fmul_rn(Y, s_sin[j])),
                    t0),
          dt);
      if (!(c >= 0.0f && c <= c_max)) continue;
      const float c0 = fminf(fmaxf(floorf(c), 0.0f), c0_max);
      const float f = fminf(fmaxf(c - c0, 0.0f), 1.0f);
      const float* row =
          packed + ((size_t)(v0 + j) * nt + (size_t)c0) * (2 * K);
#pragma unroll
      for (int k = 0; k < K; ++k)
        acc[k] += __ldg(row + k) * (1.0f - f) + __ldg(row + K + k) * f;
    }
  }
  if (ix >= N || iy >= N) return;
  const size_t plane = (size_t)N * N;
#pragma unroll
  for (int k = 0; k < K; ++k)
    out[k * plane + pix] = valid ? acc[k] * dtheta : 0.0f;
}

template <int TW_, int BW_, int BH_, bool VEC_, int UNROLL_, int PIX_,
          int MINB_, int INNER_, int LAYOUT_, bool TWO_>
struct Cfg {
  static constexpr int TW = TW_, BW = BW_, BH = BH_, UNROLL = UNROLL_,
                       PIX = PIX_, MINB = MINB_, INNER = INNER_,
                       LAYOUT = LAYOUT_;
  static constexpr bool VEC = VEC_, TWO = TWO_;
  static constexpr int THREADS = BW * BH / PIX;
};

template <int K>
struct Row {
  float a[K];
  float b[K];
};

template <int K, bool VEC>
__device__ __forceinline__ Row<K> load_row(const float* __restrict__ p) {
  Row<K> r;
  if constexpr (!VEC) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      r.a[k] = __ldg(p + k);
      r.b[k] = __ldg(p + K + k);
    }
  } else if constexpr (K == 4) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
    r = {{lo.x, lo.y, lo.z, lo.w}, {hi.x, hi.y, hi.z, hi.w}};
  } else if constexpr (K == 3) {
    const float2 t0 = __ldg(reinterpret_cast<const float2*>(p));
    const float2 t1 = __ldg(reinterpret_cast<const float2*>(p) + 1);
    const float2 t2 = __ldg(reinterpret_cast<const float2*>(p) + 2);
    r = {{t0.x, t0.y, t1.x}, {t1.y, t2.x, t2.y}};
  } else if constexpr (K == 2) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    r = {{t.x, t.y}, {t.z, t.w}};
  } else {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    r = {{t.x}, {t.y}};
  }
  return r;
}

// The tap of one image: the contraction nvcc chose (0), the other one (1),
// or none (2); g = 1 - f
template <int INNER>
__device__ __forceinline__ float tap(float a, float b, float g, float f) {
  if constexpr (INNER == 0) return __fmaf_rn(a, g, __fmul_rn(b, f));
  if constexpr (INNER == 1) return __fmaf_rn(b, f, __fmul_rn(a, g));
  return __fadd_rn(__fmul_rn(a, g), __fmul_rn(b, f));
}

// The channel coordinate in the parent's operations: on = the view reaches
// the detector; c0 and f as the parent's, whatever on is (c0 is then a
// row inside the table)
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

// A lane's pixel in its block: LAYOUT 0, the warp a TW x (32 / TW) tile,
// lanes along x first; LAYOUT 1, the warp an 8 x 4 tile whose four groups
// of 8 lanes (the quarters a 16-byte load is served in) are 4 x 2 tiles
template <class S>
__device__ __forceinline__ void lane_pixel(int& dx, int& dy) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if constexpr (S::LAYOUT == 0) {
    constexpr int TH = 32 / S::TW;
    constexpr int WW = S::BW / S::TW;
    dx = (warp % WW) * S::TW + lane % S::TW;
    dy = (warp / WW) * TH + lane / S::TW;
  } else {
    constexpr int WW = S::BW / 8;
    const int q = lane >> 3, r = lane & 7;
    dx = (warp % WW) * 8 + (q & 1) * 4 + (r & 3);
    dy = (warp / WW) * 4 + (q >> 1) * 2 + (r >> 2);
  }
}

template <int K, class S>
__global__ void __launch_bounds__(S::THREADS, S::MINB) step_kernel(
    const float* __restrict__ packed, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, const unsigned char* __restrict__ mask,
    float* __restrict__ out, int n_theta, int nt, int N, float px,
    float half, float t0, float dt, float dtheta) {
  __shared__ float2 s_cs[kChunk];
  constexpr int ROWS = S::BH / S::PIX;
  constexpr int U = S::UNROLL;
  int dx, dy;
  lane_pixel<S>(dx, dy);
  const int ix = blockIdx.x * S::BW + dx;
  const int iy0 = blockIdx.y * S::BH + dy;
  const float X = __fmul_rn(__fsub_rn(__fadd_rn((float)ix, 0.5f), half), px);
  float Y[S::PIX];
  bool valid[S::PIX];
  bool any = false;
#pragma unroll
  for (int p = 0; p < S::PIX; ++p) {
    const int iy = iy0 + p * ROWS;
    Y[p] = __fmul_rn(__fsub_rn(__fadd_rn((float)iy, 0.5f), half), px);
    valid[p] = ix < N && iy < N &&
               (mask == nullptr || mask[(size_t)iy * N + ix] != 0);
    any |= valid[p];
  }
  const float c_max = (float)(nt - 1);
  const float c0_max = (float)(nt - 2);

  float acc[S::PIX][K];
#pragma unroll
  for (int p = 0; p < S::PIX; ++p)
#pragma unroll
    for (int k = 0; k < K; ++k) acc[p][k] = 0.0f;

  // one view's rows and sums, in the interleaved order
  auto view = [&](int j, int row_v) {
    const float2 cs = s_cs[j];
#pragma unroll
    for (int p = 0; p < S::PIX; ++p) {
      int c0i;
      float f;
      const bool on =
          channel(X, Y[p], cs, t0, dt, c_max, c0_max, c0i, f) && valid[p];
      const Row<K> r = load_row<K, S::VEC>(packed + (row_v + c0i) * (2 * K));
      const float g = __fsub_rn(1.0f, f);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float t = tap<S::INNER>(r.a[k], r.b[k], g, f);
        if (on) acc[p][k] = __fadd_rn(acc[p][k], t);
      }
    }
  };

  for (int v0 = 0; v0 < n_theta; v0 += kChunk) {
    const int nv = min(kChunk, n_theta - v0);
    __syncthreads();
    for (int i = threadIdx.x; i < nv; i += S::THREADS)
      s_cs[i] = make_float2(cos_t[v0 + i], sin_t[v0 + i]);
    __syncthreads();
    if (!any) continue;
    int row_v = v0 * nt;
    if constexpr (S::TWO) {
      // U views a step: every row loaded first, then the sums in order
      int j = 0;
      for (; j + U <= nv; j += U, row_v += U * nt) {
        Row<K> r[U][S::PIX];
        float fr[U][S::PIX];
        bool on[U][S::PIX];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float2 cs = s_cs[j + u];
#pragma unroll
          for (int p = 0; p < S::PIX; ++p) {
            int c0i;
            on[u][p] = channel(X, Y[p], cs, t0, dt, c_max, c0_max, c0i,
                               fr[u][p]) &&
                       valid[p];
            r[u][p] = load_row<K, S::VEC>(packed +
                                          (row_v + u * nt + c0i) * (2 * K));
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int p = 0; p < S::PIX; ++p) {
            const float g = __fsub_rn(1.0f, fr[u][p]);
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const float t =
                  tap<S::INNER>(r[u][p].a[k], r[u][p].b[k], g, fr[u][p]);
              if (on[u][p]) acc[p][k] = __fadd_rn(acc[p][k], t);
            }
          }
      }
      for (; j < nv; ++j, row_v += nt) view(j, row_v);
    } else {
#pragma unroll (S::UNROLL)
      for (int j = 0; j < nv; ++j, row_v += nt) view(j, row_v);
    }
  }
  const size_t plane = (size_t)N * N;
#pragma unroll
  for (int p = 0; p < S::PIX; ++p) {
    const int iy = iy0 + p * ROWS;
    if (ix >= N || iy >= N) continue;
#pragma unroll
    for (int k = 0; k < K; ++k)
      out[k * plane + (size_t)iy * N + ix] =
          valid[p] ? __fmul_rn(acc[p][k], dtheta) : 0.0f;
  }
}

// The staged variant: 16 x 16 pixel blocks of 8 x 4 warp tiles; per chunk
// of kStageViews views the block copies the rows its pixels can reach
// (from its corners' channel coordinates, one row of margin each side)
// into shared memory with cp.async, double-buffered, and reads them there
// (a row outside the copied window, which rounding could only cause at
// the margin, is read from the table).
constexpr int kStageViews = 16;
constexpr int kSB = 16;

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem));
}

template <int K>
__global__ void __launch_bounds__(kSB * kSB) staged_kernel(
    const float* __restrict__ packed, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, const unsigned char* __restrict__ mask,
    float* __restrict__ out, int n_theta, int nt, int N, float px,
    float half, float t0, float dt, float dtheta, int w_max) {
  extern __shared__ __align__(16) float s_rows[];  // [2][kStageViews][w_max][2K]
  __shared__ int s_lo[2][kStageViews];
  __shared__ int s_w[2][kStageViews];
  constexpr int RF = 2 * K;                          // floats a row
  constexpr int GB = (RF * 4) % 16 == 0 ? 16 : 8;    // bytes a copy
  constexpr int GF = GB / 4;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bx = blockIdx.x * kSB, by = blockIdx.y * kSB;
  const int ix = bx + (warp % 2) * 8 + lane % 8;
  const int iy = by + (warp / 2) * 4 + lane / 8;
  const bool valid = ix < N && iy < N &&
                     (mask == nullptr || mask[(size_t)iy * N + ix] != 0);
  const float X = __fmul_rn(__fsub_rn(__fadd_rn((float)ix, 0.5f), half), px);
  const float Y = __fmul_rn(__fsub_rn(__fadd_rn((float)iy, 0.5f), half), px);
  const float c_max = (float)(nt - 1);
  const float c0_max = (float)(nt - 2);
  const float xs[2] = {
      __fmul_rn(__fsub_rn(__fadd_rn((float)bx, 0.5f), half), px),
      __fmul_rn(__fsub_rn(__fadd_rn((float)(bx + kSB - 1), 0.5f), half), px)};
  const float ys[2] = {
      __fmul_rn(__fsub_rn(__fadd_rn((float)by, 0.5f), half), px),
      __fmul_rn(__fsub_rn(__fadd_rn((float)(by + kSB - 1), 0.5f), half), px)};
  const int per_buf = kStageViews * w_max * RF;

  // the windows of views [v, v + kStageViews) into buffer b, copies issued
  auto stage = [&](int v, int b) {
    if (threadIdx.x < kStageViews) {
      const int j = v + threadIdx.x;
      int lo = 0, w = 0;
      if (j < n_theta) {
        const float2 cs = make_float2(cos_t[j], sin_t[j]);
        float cmin = 3.0e38f, cmax = -3.0e38f;
        for (int a = 0; a < 4; ++a) {
          const float c = __fdiv_rn(
              __fsub_rn(__fadd_rn(__fmul_rn(xs[a & 1], cs.x),
                                  __fmul_rn(ys[a >> 1], cs.y)),
                        t0),
              dt);
          cmin = fminf(cmin, c);
          cmax = fmaxf(cmax, c);
        }
        const float lo_f = fminf(fmaxf(floorf(cmin) - 1.0f, 0.0f), c0_max);
        const float hi_f = fminf(fmaxf(floorf(cmax) + 1.0f, 0.0f), c0_max);
        lo = (int)lo_f;
        w = min((int)hi_f - lo + 1, w_max);
      }
      s_lo[b][threadIdx.x] = lo;
      s_w[b][threadIdx.x] = w;
    }
    __syncthreads();
    float* buf = s_rows + b * per_buf;
    for (int jj = 0; jj < kStageViews; ++jj) {
      const int j = v + jj;
      if (j >= n_theta) break;
      const int n = s_w[b][jj] * RF / GF;
      const float* src = packed + ((size_t)j * nt + s_lo[b][jj]) * RF;
      float* dst = buf + jj * w_max * RF;
      for (int i = threadIdx.x; i < n; i += kSB * kSB)
        cp_async(dst + i * GF, src + i * GF, GB);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0f;
  stage(0, 0);
  for (int v0 = 0, b = 0; v0 < n_theta; v0 += kStageViews, b ^= 1) {
    if (v0 + kStageViews < n_theta) {
      stage(v0 + kStageViews, b ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    if (valid) {
      const float* buf = s_rows + b * per_buf;
      const int nv = min(kStageViews, n_theta - v0);
      for (int jj = 0; jj < nv; ++jj) {
        const int j = v0 + jj;
        const float2 cs = make_float2(cos_t[j], sin_t[j]);
        int c0i;
        float f;
        const bool on = channel(X, Y, cs, t0, dt, c_max, c0_max, c0i, f);
        const int r = c0i - s_lo[b][jj];
        const float* p = (r >= 0 && r < s_w[b][jj])
                             ? buf + (jj * w_max + r) * RF
                             : packed + ((size_t)j * nt + c0i) * RF;
        float a[K], bb[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          a[k] = p[k];
          bb[k] = p[K + k];
        }
        const float g = __fsub_rn(1.0f, f);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float t = tap<0>(a[k], bb[k], g, f);
          if (on) acc[k] = __fadd_rn(acc[k], t);
        }
      }
    }
    __syncthreads();
  }
  if (ix >= N || iy >= N) return;
  const size_t plane = (size_t)N * N;
#pragma unroll
  for (int k = 0; k < K; ++k)
    out[k * plane + (size_t)iy * N + ix] =
        valid ? __fmul_rn(acc[k], dtheta) : 0.0f;
}

struct Args {
  const float* packed;
  const float* cos_t;
  const float* sin_t;
  const unsigned char* mask;
  float* out;
  int n_theta, nt, N;
  float px, half, t0, dt, dtheta;
  cudaStream_t stream;
};

template <int K>
int launch_parent(const Args& a) {
  const dim3 threads(16, 16);
  const dim3 blocks((a.N + 15) / 16, (a.N + 15) / 16);
  parent_kernel<K><<<blocks, threads, 0, a.stream>>>(
      a.packed, a.cos_t, a.sin_t, a.mask, a.out, a.n_theta, a.nt, a.N, a.px,
      a.half, a.t0, a.dt, a.dtheta);
  return (int)cudaGetLastError();
}

template <int K, class S>
int launch_step(const Args& a) {
  const dim3 blocks((a.N + S::BW - 1) / S::BW, (a.N + S::BH - 1) / S::BH);
  step_kernel<K, S><<<blocks, S::THREADS, 0, a.stream>>>(
      a.packed, a.cos_t, a.sin_t, a.mask, a.out, a.n_theta, a.nt, a.N, a.px,
      a.half, a.t0, a.dt, a.dtheta);
  return (int)cudaGetLastError();
}

template <int K>
int launch_staged(const Args& a) {
  // the widest window a 16 x 16 block can reach: its diagonal in
  // channels, plus the margins and the floors
  const float diag = 1.4142136f * kSB * a.px / a.dt;
  const int w_max = (int)ceilf(diag) + 4;
  const size_t bytes = sizeof(float) * 2 * kStageViews * w_max * 2 * K;
  cudaFuncSetAttribute(staged_kernel<K>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  const dim3 blocks((a.N + kSB - 1) / kSB, (a.N + kSB - 1) / kSB);
  staged_kernel<K><<<blocks, kSB * kSB, bytes, a.stream>>>(
      a.packed, a.cos_t, a.sin_t, a.mask, a.out, a.n_theta, a.nt, a.N, a.px,
      a.half, a.t0, a.dt, a.dtheta, w_max);
  return (int)cudaGetLastError();
}

template <int K>
int run(int variant, const Args& a) {
  // the probe's STEPS, in order (Cfg: TW, BW, BH, VEC, UNROLL, PIX, MINB,
  // INNER, LAYOUT, TWO)
  switch (variant) {
    case 0: return launch_parent<K>(a);
    case 1:
      return launch_step<K, Cfg<16, 16, 16, false, 1, 1, 1, 0, 0, false>>(a);
    case 2:
      return launch_step<K, Cfg<16, 16, 16, false, 1, 1, 1, 1, 0, false>>(a);
    case 3:
      return launch_step<K, Cfg<16, 16, 16, false, 1, 1, 1, 2, 0, false>>(a);
    case 4:
      return launch_step<K, Cfg<16, 16, 16, true, 1, 1, 1, 0, 0, false>>(a);
    case 5:
      return launch_step<K, Cfg<8, 16, 16, true, 1, 1, 1, 0, 0, false>>(a);
    case 6:
      return launch_step<K, Cfg<4, 16, 16, true, 1, 1, 1, 0, 0, false>>(a);
    case 7:
      return launch_step<K, Cfg<8, 16, 16, true, 4, 1, 1, 0, 0, false>>(a);
    case 8:
      return launch_step<K, Cfg<8, 16, 16, true, 8, 1, 1, 0, 0, false>>(a);
    case 9:
      return launch_step<K, Cfg<8, 16, 32, true, 8, 1, 1, 0, 0, false>>(a);
    case 10:
      return launch_step<K, Cfg<8, 32, 8, true, 8, 1, 1, 0, 0, false>>(a);
    case 11:
      return launch_step<K, Cfg<8, 16, 16, true, 8, 1, 4, 0, 0, false>>(a);
    case 12:
      return launch_step<K, Cfg<8, 16, 16, true, 4, 1, 6, 0, 0, false>>(a);
    case 13:
      return launch_step<K, Cfg<8, 16, 16, true, 4, 2, 1, 0, 0, false>>(a);
    case 14:
      return launch_step<K, Cfg<8, 16, 16, true, 8, 2, 1, 0, 0, false>>(a);
    case 15:
      return launch_step<K, Cfg<8, 16, 32, true, 4, 2, 1, 0, 0, false>>(a);
    case 16:
      return launch_step<K, Cfg<8, 16, 16, false, 8, 1, 1, 0, 0, false>>(a);
    case 17:
      return launch_step<K, Cfg<16, 16, 16, true, 8, 1, 1, 0, 0, false>>(a);
    case 18: return launch_staged<K>(a);
    case 19:
      return launch_step<K, Cfg<8, 16, 16, true, 1, 1, 1, 0, 1, false>>(a);
    case 20:
      return launch_step<K, Cfg<2, 16, 16, true, 1, 1, 1, 0, 0, false>>(a);
    case 21:
      return launch_step<K, Cfg<4, 16, 16, true, 4, 1, 1, 0, 0, false>>(a);
    case 22:
      return launch_step<K, Cfg<4, 16, 16, true, 8, 1, 1, 0, 0, false>>(a);
    case 23:
      return launch_step<K, Cfg<4, 16, 16, true, 4, 1, 1, 0, 0, true>>(a);
    case 24:
      return launch_step<K, Cfg<4, 16, 16, true, 8, 1, 1, 0, 0, true>>(a);
    case 25:
      return launch_step<K, Cfg<4, 16, 16, true, 2, 1, 1, 0, 0, true>>(a);
    case 26:
      return launch_step<K, Cfg<4, 16, 16, true, 4, 1, 4, 0, 0, true>>(a);
    case 27:
      return launch_step<K, Cfg<4, 16, 16, true, 4, 1, 3, 0, 0, true>>(a);
    case 28:
      return launch_step<K, Cfg<4, 16, 16, true, 4, 1, 2, 0, 0, true>>(a);
    case 29:
      return launch_step<K, Cfg<4, 16, 16, true, 4, 2, 1, 0, 0, false>>(a);
    case 30:
      return launch_step<K, Cfg<4, 16, 16, true, 2, 2, 1, 0, 0, true>>(a);
    case 31:
      return launch_step<K, Cfg<4, 16, 16, true, 4, 2, 1, 0, 0, true>>(a);
    case 32:
      return launch_step<K, Cfg<4, 16, 32, true, 4, 1, 1, 0, 0, true>>(a);
    case 33:
      return launch_step<K, Cfg<4, 32, 8, true, 4, 1, 1, 0, 0, true>>(a);
    case 34:
      return launch_step<K, Cfg<4, 16, 16, true, 1, 1, 4, 0, 0, false>>(a);
    case 35:
      return launch_step<K, Cfg<8, 16, 16, true, 4, 1, 1, 0, 1, true>>(a);
    case 36:
      return launch_step<K, Cfg<4, 16, 16, false, 4, 1, 1, 0, 0, true>>(a);
    case 37:
      return launch_step<K, Cfg<8, 16, 16, true, 2, 2, 1, 0, 1, true>>(a);
    case 38:
      return launch_step<K, Cfg<4, 32, 16, true, 2, 2, 1, 0, 0, true>>(a);
    case 39:
      return launch_step<K, Cfg<4, 16, 16, true, 3, 2, 1, 0, 0, true>>(a);
    case 40:
      return launch_step<K, Cfg<4, 16, 16, true, 2, 2, 8, 0, 0, true>>(a);
    case 41:
      return launch_step<K, Cfg<8, 16, 16, true, 3, 1, 1, 0, 1, true>>(a);
    case 42:
      return launch_step<K, Cfg<8, 16, 8, true, 4, 1, 1, 0, 1, true>>(a);
    case 43:
      return launch_step<K, Cfg<8, 32, 16, true, 4, 1, 1, 0, 1, true>>(a);
    case 44:
      return launch_step<K, Cfg<4, 16, 32, true, 2, 2, 1, 0, 0, true>>(a);
    case 45: return launch_step<K, Cfg<8, 8, 8, true, 4, 1, 1, 0, 1, true>>(a);
    case 46:
      return launch_step<K, Cfg<8, 8, 16, true, 4, 1, 1, 0, 1, true>>(a);
    case 47:
      return launch_step<K, Cfg<8, 16, 8, true, 2, 1, 1, 0, 1, true>>(a);
    case 48:
      return launch_step<K, Cfg<8, 16, 8, true, 3, 1, 1, 0, 1, true>>(a);
    case 49:
      return launch_step<K, Cfg<8, 16, 8, true, 2, 2, 1, 0, 1, true>>(a);
    case 50:
      return launch_step<K, Cfg<8, 8, 16, true, 2, 2, 1, 0, 1, true>>(a);
    case 51:
      return launch_step<K, Cfg<8, 16, 8, true, 4, 1, 10, 0, 1, true>>(a);
    case 52: return launch_step<K, Cfg<8, 8, 8, true, 2, 2, 1, 0, 1, true>>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// As dexct_parallel_backproject, with the variant first.
extern "C" int k6_step(int variant, const void* packed, const void* cos_t,
                       const void* sin_t, const void* mask, void* out,
                       int n_images, int n_theta, int nt, int N, float px,
                       float half, float t0, float dt, float dtheta,
                       void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  const Args a{static_cast<const float*>(packed),
               static_cast<const float*>(cos_t),
               static_cast<const float*>(sin_t),
               static_cast<const unsigned char*>(mask),
               static_cast<float*>(out),
               n_theta, nt, N, px, half, t0, dt, dtheta,
               static_cast<cudaStream_t>(stream)};
  switch (n_images) {
    case 1: return run<1>(variant, a);
    case 2: return run<2>(variant, a);
    case 3: return run<3>(variant, a);
    case 4: return run<4>(variant, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
