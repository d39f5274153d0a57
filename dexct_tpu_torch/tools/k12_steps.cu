// The steps of K12's redesign as kernel variants, for
// tools/probe_cone_backproject.py --steps (not part of the package's kernel
// library).  Built once per variant: nvcc -DK12_VARIANT=<n> (n = 0..17)
// compiles that variant beside the package's csrc/cone_backproject.cu,
// whose device functions it uses.
//
// Variant 0 is K12 as it stood before the redesign (csrc/
// cone_backproject.cu at that commit): one thread per (disc pixel, slice)
// in 128-thread blocks, the slice's view range walked with the in-plane
// geometry (view_tap, atan2, the channel tap, 1 / h^2) recomputed for
// every slice, the window weight per term, 16 scalar taps at K = 4 at
// 64-bit offsets, betas[0] passed by the host.  k12v_kernel<..., n> is
// variant n (Cfg<n> names its settings): one thread per (disc pixel, group
// of S slices) walking the union of the group's view ranges with the
// in-plane geometry formed once per view.  1, 2, 3: S = 4, 8 and 19 with
// scalar taps (the parent's loads and offsets); 4: as 2 with each (slice,
// view)'s (z - src_z) sid and beta - beta_c read from a block-wide table
// in shared memory, 64 views at a time; 5: as 2 with the packed taps (the
// images innermost, one 16-byte load a detector element at K = 4); 6: as 5
// at 256 threads a block; 7, 8: as 5 at S = 4 and 19; 9: as 5 with 4's
// table.  10, 11 (tile_kernel): a block of 32 pixels x a group of at most
// 8 or 16 slices, one (pixel, slice) a thread, each chunk of 32 views'
// in-plane geometry staged once in shared memory.  12 to 17: as 5 with the
// group's z, beta_c and view ranges in shared memory, which frees 4 S
// registers: 12 S = 8; 13 S = 8 bounded to 6 blocks an SM; 14 S = 4
// bounded to 8 (the package's kernel, which also skips `full`'s product by
// its weight 1); 15 S = 10 bounded to 5; 16 S = 5 bounded to 8; 17 as 14 in
// 64-thread blocks bounded to 16.  Every variant adds each slice's terms
// in ascending view order with the parent's expressions (its contracted
// `acc += val * w` as __fmaf_rn), so all agree bit for bit.  Each builds
// K = 4 and K = 2 in every weighting and K = 1 and K = 3 in `full`: the
// probe's cases.

#include "../csrc/cone_backproject.cu"

#ifndef K12_VARIANT
#define K12_VARIANT 0
#endif

namespace {

#if K12_VARIANT == 0

// the parent's window weight (its window_weight, verbatim)
template <int W>
__device__ __forceinline__ float parent_window_weight(
    const Window& k, float d, float gam, float zt, float z, float sz,
    const ViewTap& t, float sid) {
  if (W == kFull) return fabsf(d) <= kPi ? 1.0f : 0.0f;
  if (W == kFeather) {
    const float dd = __fdiv_rn(fabsf(d), kPi);
    return cos2(__fmul_rn(
        clampf(__fdiv_rn(__fsub_rn(dd, 0.75f), 0.5f), 0.0f, 1.0f), kHalfPi));
  }
  if (W == kTd) {
    if (!(fabsf(d) <= kOneHalfPi)) return 0.0f;
    return dexct_td::weight<false>(
        zt, dexct_td::over_cos(dexct_td::bounds(k.qp, k.nqp, gam), cosf(gam)),
        k.taper);
  }
  if (W == kCosz) {
    if (!(fabsf(d) <= kOneHalfPi)) return 0.0f;
    return __fadd_rn(
        cos2(__fmul_rn(clampf(__fdiv_rn(zt, k.hmax), -1.0f, 1.0f), kHalfPi)),
        1e-3f);
  }
  if (W == kShort) {
    const float alpha = __fadd_rn(__fadd_rn(d, kHalfPi), k.gm);
    if (!(alpha >= 0.0f && alpha <= k.pi_2gm)) return 0.0f;
    if (alpha < __fmul_rn(2.0f, __fsub_rn(k.gm, gam))) {
      const float lo_den = fmaxf(__fsub_rn(k.gm, gam), 1e-3f);
      const float s = sinf(__fmul_rn(
          kQuarterPi, clampf(__fdiv_rn(alpha, lo_den), 0.0f, 2.0f)));
      return __fmul_rn(s, s);
    }
    if (alpha > __fsub_rn(kPi, __fmul_rn(2.0f, gam))) {
      const float hi_den = fmaxf(__fadd_rn(k.gm, gam), 1e-3f);
      const float s = sinf(__fmul_rn(
          kQuarterPi,
          clampf(__fdiv_rn(__fsub_rn(k.pi_2gm, alpha), hi_den), 0.0f, 2.0f)));
      return __fmul_rn(s, s);
    }
    return 1.0f;
  }
  if (!(fabsf(d) <= kPi)) return 0.0f;
  const float two_g = __fmul_rn(2.0f, gam);
  const float dbc =
      d > -two_g ? -__fsub_rn(kPi, two_g) : __fadd_rn(kPi, two_g);
  const float sz_conj =
      __fadd_rn(sz, __fdiv_rn(__fmul_rn(dbc, k.pitch), kTwoPi));
  const float h_own = __fmul_rn(t.h2, t.inv_h);
  const float h_conj =
      fmaxf(__fsub_rn(__fmul_rn(k.two_sid, cosf(gam)), h_own), 1e-3f);
  const float zt_c = __fdiv_rn(__fmul_rn(__fsub_rn(z, sz_conj), sid), h_conj);
  const float k_own = __fadd_rn(
      cos2(__fmul_rn(clampf(__fdiv_rn(zt, k.scale), -1.0f, 1.0f), kHalfPi)),
      1e-4f);
  const float k_c =
      fabsf(zt_c) <= k.hdet
          ? __fadd_rn(cos2(__fmul_rn(
                          clampf(__fdiv_rn(zt_c, k.scale), -1.0f, 1.0f),
                          kHalfPi)),
                      1e-4f)
          : 0.0f;
  return __fdiv_rn(k_own, __fadd_rn(__fadd_rn(k_own, k_c), 1e-30f));
}

// the parent kernel (its helical_backproject_kernel, verbatim)
template <int K, int W>
__global__ void parent_kernel(
    const float* __restrict__ qs, const float* __restrict__ cos_b,
    const float* __restrict__ sin_b, const float* __restrict__ betas,
    const float* __restrict__ src_z, const float* __restrict__ row_off,
    const float* __restrict__ beta_c, const float* __restrict__ X,
    const float* __restrict__ Y, const long long* __restrict__ sel,
    const float* __restrict__ zc, float* __restrict__ out, int V, int R,
    int C, int P, long long plane, float sid, float dgamma, float row_h,
    float beta0, float dbeta, Window win) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int iz = blockIdx.y;
  if (p >= P) return;
  const float x = X[p], y = Y[p];
  const float z = zc[iz];
  const float bc = beta_c[iz];
  const Detector d = make_detector(V, R, C);
  const int v_lo =
      max(0, (int)floorf((bc - win.hwpi - beta0) / dbeta) - 2);
  const int v_hi =
      min(V - 1, (int)ceilf((bc + win.hwpi - beta0) / dbeta) + 2);

  float num[K];
#pragma unroll
  for (int k = 0; k < K; ++k) num[k] = 0.0f;
  float den = 0.0f;

  for (int v = v_lo; v <= v_hi; ++v) {
    const float dv = __fsub_rn(__ldg(betas + v), bc);
    if (W == kFull && !(fabsf(dv) <= kPi)) continue;
    const ViewTap t =
        view_tap(x, y, __ldg(cos_b + v), __ldg(sin_b + v), sid);
    const float sz = __ldg(src_z + v);
    const float zt = __fmul_rn(__fmul_rn(__fsub_rn(z, sz), sid), t.inv_h);
    const float ridx = __fadd_rn(
        __fadd_rn(__fsub_rn(__fdiv_rn(zt, row_h), 0.5f), d.r_shift),
        __ldg(row_off + v));
    if (!on_detector(ridx, d)) continue;
    const float gam = atan2f(-t.vt, t.ell);
    const float w = parent_window_weight<W>(win, dv, gam, zt, z, sz, t, sid);
    if (w == 0.0f) continue;
    den += w;
    const float c =
        __fadd_rn(__fsub_rn(__fdiv_rn(gam, dgamma), 0.5f), d.c_shift);
    if (!in_fan(c, d)) continue;
    add_taps<K>(qs, d, v, c, ridx, __fmul_rn(__fdiv_rn(1.0f, t.h2), w), num);
  }
  const long long dst = (long long)iz * plane + sel[p];
  const long long vol = (long long)gridDim.y * plane;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float o = den > 0.0f ? __fdiv_rn(num[k], fmaxf(den, 1e-30f)) : 0.0f;
    out[k * vol + dst] = __fmul_rn(o, kTwoPi);
  }
}

#elif K12_VARIANT == 10 || K12_VARIANT == 11

// the tile's pixels and the views staged at a time
constexpr int kTile = 32;
constexpr int kChunkViews = 32;

// ViewWindow's fields that a weighting reads
template <int W>
constexpr int kWindowFields =
    W == kTd ? 2 : (W == kShort || W == kPair ? 4 : 0);

template <int K, int W>
__global__ void tile_kernel(
    const float* __restrict__ qp, const float* __restrict__ cos_b,
    const float* __restrict__ sin_b, const float* __restrict__ betas,
    const float* __restrict__ src_z, const float* __restrict__ row_off,
    const float* __restrict__ beta_c, const float* __restrict__ X,
    const float* __restrict__ Y, const long long* __restrict__ sel,
    const float* __restrict__ zc, float* __restrict__ out, int V, int R,
    int C, int P, int nz, long long plane, float sid, float dgamma,
    float row_h, float dbeta, Window win) {
  constexpr int kFields = kWindowFields<W>;
  // per (view, pixel) of the chunk: 1 / sqrt(h^2), 1 / h^2, the channel
  // fraction, the element offset of (view, row 0, c0) (-1 outside the
  // fan), the window's pixel part; per view: beta, src_z, row_off
  __shared__ float s_inv_h[kChunkViews][kTile];
  __shared__ float s_inv_h2[kChunkViews][kTile];
  __shared__ float s_fc[kChunkViews][kTile];
  __shared__ int s_base[kChunkViews][kTile];
  __shared__ float s_win[kFields > 0 ? kFields : 1][kChunkViews][kTile];
  __shared__ float s_beta[kChunkViews], s_sz[kChunkViews], s_ro[kChunkViews];

  const int lane = threadIdx.x;
  const int p = blockIdx.x * kTile + lane;
  const int iz = blockIdx.y * blockDim.y + threadIdx.y;
  const bool live = p < P && iz < nz;
  const float x = p < P ? X[p] : 0.0f, y = p < P ? Y[p] : 0.0f;
  const Detector d = make_detector(V, R, C);
  const float beta0 = __ldg(betas);
  // each slice's views: those within hw pi of its beta_c, with a two-view
  // margin (the parent's range); the block walks the union of its slices'
  const int s0 = blockIdx.y * blockDim.y;
  const int s_end = min(nz, s0 + (int)blockDim.y);
  int v_first = V, v_last = -1, lo = V, hi = -1;
  for (int s = s0; s < s_end; ++s) {
    const float b = beta_c[s];
    const int l = max(0, (int)floorf((b - win.hwpi - beta0) / dbeta) - 2);
    const int h = min(V - 1, (int)ceilf((b + win.hwpi - beta0) / dbeta) + 2);
    v_first = min(v_first, l);
    v_last = max(v_last, h);
    if (s == iz) {
      lo = l;
      hi = h;
    }
  }
  const float z = iz < nz ? zc[iz] : 0.0f;
  const float bc = iz < nz ? beta_c[iz] : 0.0f;

  float num[K];
#pragma unroll
  for (int k = 0; k < K; ++k) num[k] = 0.0f;
  float den = 0.0f;

  const int tid = threadIdx.y * kTile + lane;
  for (int v0 = v_first; v0 <= v_last; v0 += kChunkViews) {
    const int nv = min(kChunkViews, v_last + 1 - v0);
    __syncthreads();
    // this pixel's in-plane geometry at views v0 + j, once for the group
    for (int j = threadIdx.y; j < nv; j += blockDim.y) {
      const int v = v0 + j;
      const ViewTap t =
          view_tap(x, y, __ldg(cos_b + v), __ldg(sin_b + v), sid);
      const float gam = atan2f(-t.vt, t.ell);
      const float c =
          __fadd_rn(__fsub_rn(__fdiv_rn(gam, dgamma), 0.5f), d.c_shift);
      float c0, fc;
      channel_tap(c, d, c0, fc);
      s_inv_h[j][lane] = t.inv_h;
      s_inv_h2[j][lane] = __fdiv_rn(1.0f, t.h2);
      s_fc[j][lane] = fc;
      s_base[j][lane] = in_fan(c, d) ? v * R * C + (int)c0 : -1;
      if constexpr (kFields > 0) {
        const ViewWindow vw = view_window<W>(win, gam, t, __ldg(src_z + v));
        const float f[4] = {vw.p0, vw.p1, vw.p2, vw.p3};
#pragma unroll
        for (int i = 0; i < kFields; ++i) s_win[i][j][lane] = f[i];
      }
    }
    if (tid < nv) {
      s_beta[tid] = __ldg(betas + v0 + tid);
      s_sz[tid] = __ldg(src_z + v0 + tid);
      s_ro[tid] = __ldg(row_off + v0 + tid);
    }
    __syncthreads();
    if (!live) continue;
    // this slice's terms of those views, in ascending order
    const int j_end = min(nv - 1, hi - v0);
    for (int j = max(0, lo - v0); j <= j_end; ++j) {
      const float dv = __fsub_rn(s_beta[j], bc);
      if (W == kFull && !(fabsf(dv) <= kPi)) continue;
      const float zt =
          __fmul_rn(__fmul_rn(__fsub_rn(z, s_sz[j]), sid), s_inv_h[j][lane]);
      const float ridx = __fadd_rn(
          __fadd_rn(__fsub_rn(__fdiv_rn(zt, row_h), 0.5f), d.r_shift),
          s_ro[j]);
      if (!on_detector(ridx, d)) continue;
      ViewWindow vw{0.0f, 0.0f, 0.0f, 0.0f};
      if constexpr (kFields > 0) {
        vw.p0 = s_win[0][j][lane];
        vw.p1 = s_win[kFields > 1 ? 1 : 0][j][lane];
      }
      if constexpr (kFields > 2) {
        vw.p2 = s_win[2][j][lane];
        vw.p3 = s_win[3][j][lane];
      }
      const float w = term_weight<W>(win, vw, dv, zt, z, sid);
      if (w == 0.0f) continue;
      den += w;
      const int base = s_base[j][lane];
      if (base < 0) continue;
      add_packed_taps<K>(qp, d, base, s_fc[j][lane], ridx,
                         __fmul_rn(s_inv_h2[j][lane], w), num);
    }
  }
  if (!live) return;
  const long long dst = (long long)iz * plane + sel[p];
  const long long vol = (long long)nz * plane;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float o = den > 0.0f ? __fdiv_rn(num[k], fmaxf(den, 1e-30f)) : 0.0f;
    out[k * vol + dst] = __fmul_rn(o, kTwoPi);
  }
}


#else

// variant n's settings: slices a thread, packed taps, the (slice, view)
// table, threads a block, the slices' constants in shared memory, the
// blocks an SM must hold (launch bounds)
template <int N>
struct Cfg;
template <>
struct Cfg<1> {
  enum { S = 4, kPacked = 0, kTable = 0, kThr = 128 };
  enum { kSmem = 0, kMinBlocks = 1 };
};
template <>
struct Cfg<2> {
  enum { S = 8, kPacked = 0, kTable = 0, kThr = 128 };
  enum { kSmem = 0, kMinBlocks = 1 };
};
template <>
struct Cfg<3> {
  enum { S = 19, kPacked = 0, kTable = 0, kThr = 128 };
  enum { kSmem = 0, kMinBlocks = 1 };
};
template <>
struct Cfg<4> {
  enum { S = 8, kPacked = 0, kTable = 1, kThr = 128 };
  enum { kSmem = 0, kMinBlocks = 1 };
};
template <>
struct Cfg<5> {
  enum { S = 8, kPacked = 1, kTable = 0, kThr = 128 };
  enum { kSmem = 0, kMinBlocks = 1 };
};
template <>
struct Cfg<6> {
  enum { S = 8, kPacked = 1, kTable = 0, kThr = 256 };
  enum { kSmem = 0, kMinBlocks = 1 };
};
template <>
struct Cfg<7> {
  enum { S = 4, kPacked = 1, kTable = 0, kThr = 128 };
  enum { kSmem = 0, kMinBlocks = 1 };
};
template <>
struct Cfg<8> {
  enum { S = 19, kPacked = 1, kTable = 0, kThr = 128 };
  enum { kSmem = 0, kMinBlocks = 1 };
};
template <>
struct Cfg<9> {
  enum { S = 8, kPacked = 1, kTable = 1, kThr = 128 };
  enum { kSmem = 0, kMinBlocks = 1 };
};
template <>
struct Cfg<12> {
  enum { S = 8, kPacked = 1, kTable = 0, kThr = 128 };
  enum { kSmem = 1, kMinBlocks = 1 };
};
template <>
struct Cfg<13> {
  enum { S = 8, kPacked = 1, kTable = 0, kThr = 128 };
  enum { kSmem = 1, kMinBlocks = 6 };
};
template <>
struct Cfg<14> {
  enum { S = 4, kPacked = 1, kTable = 0, kThr = 128 };
  enum { kSmem = 1, kMinBlocks = 8 };
};
template <>
struct Cfg<15> {
  enum { S = 10, kPacked = 1, kTable = 0, kThr = 128 };
  enum { kSmem = 1, kMinBlocks = 5 };
};
template <>
struct Cfg<16> {
  enum { S = 5, kPacked = 1, kTable = 0, kThr = 128 };
  enum { kSmem = 1, kMinBlocks = 8 };
};
template <>
struct Cfg<17> {
  enum { S = 4, kPacked = 1, kTable = 0, kThr = 64 };
  enum { kSmem = 1, kMinBlocks = 16 };
};

constexpr int kChunkV = 64;  // the table's views at a time

// acc[k] += w x the bilinear value of unpacked stack k (the parent's
// scalar loads at 64-bit offsets) at channel tap (c0, fc)
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
    acc[k] = __fmaf_rn(__fadd_rn(__fmul_rn(top, 1.0f - fr), __fmul_rn(bot, fr)),
                       w, acc[k]);
  }
}

template <int K, int W, int N>
__global__ void __launch_bounds__(Cfg<N>::kThr, Cfg<N>::kMinBlocks)
    k12v_kernel(
    const float* __restrict__ qs, const float* __restrict__ cos_b,
    const float* __restrict__ sin_b, const float* __restrict__ betas,
    const float* __restrict__ src_z, const float* __restrict__ row_off,
    const float* __restrict__ beta_c, const float* __restrict__ X,
    const float* __restrict__ Y, const long long* __restrict__ sel,
    const float* __restrict__ zc, float* __restrict__ out, int V, int R,
    int C, int P, int nz, long long plane, float sid, float dgamma,
    float row_h, float dbeta, Window win) {
  constexpr int S = Cfg<N>::S;
  constexpr bool kPacked = Cfg<N>::kPacked;
  constexpr bool kTable = Cfg<N>::kTable;
  // kSmem: the slices' z, beta_c and view ranges in shared memory (block
  // constants), else in registers
  constexpr bool kSmem = Cfg<N>::kSmem;
  constexpr int SR = kSmem ? 1 : S;
  static_assert(!(kSmem && kTable), "one table at a time");
  __shared__ float s_zs[kTable ? S : 1][kTable ? kChunkV : 1];
  __shared__ float s_dv[kTable ? S : 1][kTable ? kChunkV : 1];
  __shared__ float s_z[kSmem ? S : 1], s_bc[kSmem ? S : 1];
  __shared__ int s_lo[kSmem ? S : 1], s_hi[kSmem ? S : 1];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int s0 = blockIdx.y * S;
  const bool valid = p < P;
  if (!kTable && !kSmem && !valid) return;
  const float x = valid ? X[p] : 0.0f, y = valid ? Y[p] : 0.0f;
  const Detector d = make_detector(V, R, C);
  const float beta0 = __ldg(betas);
  float z_r[SR], bc_r[SR];
  int lo_r[SR], hi_r[SR];
  int v_first = V, v_last = -1;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    float zz = 0.0f, bb = 0.0f;
    int l = V, h = -1;
    if (s0 + s < nz) {
      zz = zc[s0 + s];
      bb = beta_c[s0 + s];
      l = max(0, (int)floorf((bb - win.hwpi - beta0) / dbeta) - 2);
      h = min(V - 1, (int)ceilf((bb + win.hwpi - beta0) / dbeta) + 2);
    }
    if (kSmem) {
      if (threadIdx.x == s) {
        s_z[s] = zz;
        s_bc[s] = bb;
        s_lo[s] = l;
        s_hi[s] = h;
      }
    } else {
      z_r[kSmem ? 0 : s] = zz;
      bc_r[kSmem ? 0 : s] = bb;
      lo_r[kSmem ? 0 : s] = l;
      hi_r[kSmem ? 0 : s] = h;
    }
    v_first = min(v_first, l);
    v_last = max(v_last, h);
  }
  if (kSmem) {
    __syncthreads();
    if (!valid) return;
  }
  auto z_of = [&](int s) { return kSmem ? s_z[s] : z_r[kSmem ? 0 : s]; };
  auto bc_of = [&](int s) { return kSmem ? s_bc[s] : bc_r[kSmem ? 0 : s]; };
  auto lo_of = [&](int s) { return kSmem ? s_lo[s] : lo_r[kSmem ? 0 : s]; };
  auto hi_of = [&](int s) { return kSmem ? s_hi[s] : hi_r[kSmem ? 0 : s]; };
  float num[S][K], den[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    den[s] = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) num[s][k] = 0.0f;
  }

  for (int v0 = v_first; v0 <= v_last; v0 += kChunkV) {
    const int v_end = min(v_last, v0 + kChunkV - 1);
    if (kTable) {
      __syncthreads();
      for (int i = threadIdx.x; i < S * kChunkV; i += blockDim.x) {
        const int s = i / kChunkV, j = i % kChunkV;
        if (v0 + j <= v_end && s0 + s < nz) {
          s_zs[s][j] = __fmul_rn(
              __fsub_rn(zc[s0 + s], __ldg(src_z + v0 + j)), sid);
          s_dv[s][j] = __fsub_rn(__ldg(betas + v0 + j), beta_c[s0 + s]);
        }
      }
      __syncthreads();
      if (!valid) continue;
    }
    for (int v = v0; v <= v_end; ++v) {
      const float bv = __ldg(betas + v);
      const float sz = __ldg(src_z + v);
      const float ro = __ldg(row_off + v);
      const ViewTap t =
          view_tap(x, y, __ldg(cos_b + v), __ldg(sin_b + v), sid);
      const float gam = atan2f(-t.vt, t.ell);
      const float c =
          __fadd_rn(__fsub_rn(__fdiv_rn(gam, dgamma), 0.5f), d.c_shift);
      const bool fan = in_fan(c, d);
      float c0, fc;
      channel_tap(c, d, c0, fc);
      const float inv_h2 = __fdiv_rn(1.0f, t.h2);
      const ViewWindow vw = view_window<W>(win, gam, t, sz);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (v < lo_of(s) || v > hi_of(s)) continue;
        const float dv = kTable ? s_dv[s][v - v0] : __fsub_rn(bv, bc_of(s));
        if (W == kFull && !(fabsf(dv) <= kPi)) continue;
        const float zs = kTable ? s_zs[s][v - v0]
                                : __fmul_rn(__fsub_rn(z_of(s), sz), sid);
        const float zt = __fmul_rn(zs, t.inv_h);
        const float ridx = __fadd_rn(
            __fadd_rn(__fsub_rn(__fdiv_rn(zt, row_h), 0.5f), d.r_shift), ro);
        if (!on_detector(ridx, d)) continue;
        const float w = term_weight<W>(win, vw, dv, zt, z_of(s), sid);
        if (w == 0.0f) continue;
        den[s] += w;
        if (!fan) continue;
        if (kPacked)
          add_packed_taps<K>(qs, d, v * R * C + (int)c0, fc, ridx,
                             __fmul_rn(inv_h2, w), num[s]);
        else
          add_scalar_taps<K>(qs, d, v, c0, fc, ridx, __fmul_rn(inv_h2, w),
                             num[s]);
      }
    }
  }
  if (!valid) return;
  const long long vol = (long long)nz * plane;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (s0 + s >= nz) break;
    const long long dst = (long long)(s0 + s) * plane + sel[p];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float o =
          den[s] > 0.0f ? __fdiv_rn(num[s][k], fmaxf(den[s], 1e-30f)) : 0.0f;
      out[k * vol + dst] = __fmul_rn(o, kTwoPi);
    }
  }
}

#endif

// The probe's (K, weighting) pairs: K = 4 and 2 in every weighting, K = 1
// and 3 in `full`.
template <typename Launch>
int for_case(int n_images, int weighting, Launch&& launch) {
  auto w = [&](auto k) {
    switch (weighting) {
      case kFull: launch(k, std::integral_constant<int, kFull>{}); break;
      case kFeather: launch(k, std::integral_constant<int, kFeather>{}); break;
      case kTd: launch(k, std::integral_constant<int, kTd>{}); break;
      case kCosz: launch(k, std::integral_constant<int, kCosz>{}); break;
      case kShort: launch(k, std::integral_constant<int, kShort>{}); break;
      case kPair: launch(k, std::integral_constant<int, kPair>{}); break;
      default: return false;
    }
    return true;
  };
  bool ok = false;
  switch (n_images) {
    case 4: ok = w(std::integral_constant<int, 4>{}); break;
    case 2: ok = w(std::integral_constant<int, 2>{}); break;
    case 1:
      if (weighting == kFull) {
        launch(std::integral_constant<int, 1>{},
               std::integral_constant<int, kFull>{});
        ok = true;
      }
      break;
    case 3:
      if (weighting == kFull) {
        launch(std::integral_constant<int, 3>{},
               std::integral_constant<int, kFull>{});
        ok = true;
      }
      break;
    default: break;
  }
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

}  // namespace

// The variant this library was built as, on the checkout's
// dexct_helical_backproject arguments: qs (packed for variants 5..9,
// unpacked for 0..4), then beta0 (read by variant 0 only) before dbeta.
extern "C" int k12_step(const void* qs, const void* cos_b, const void* sin_b,
                        const void* betas, const void* src_z,
                        const void* row_off, const void* beta_c,
                        const void* X, const void* Y, const void* sel,
                        const void* zc, void* out, int n_images,
                        int weighting, int V, int R, int C, int P, int nz,
                        long long plane, float sid, float dgamma,
                        float row_h, float beta0, float dbeta, float hwpi,
                        float pitch, float qp, float nqp, float taper,
                        float hmax, float gm, float pi_2gm, float two_sid,
                        float hdet, float scale, void* stream) {
  if (P <= 0 || nz <= 0) return (int)cudaGetLastError();
  const Window win{hwpi, pitch, qp, nqp, taper, hmax, gm, pi_2gm, two_sid,
                   hdet, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f[] = {static_cast<const float*>(qs),
                      static_cast<const float*>(cos_b),
                      static_cast<const float*>(sin_b),
                      static_cast<const float*>(betas),
                      static_cast<const float*>(src_z),
                      static_cast<const float*>(row_off),
                      static_cast<const float*>(beta_c),
                      static_cast<const float*>(X),
                      static_cast<const float*>(Y)};
  const long long* s = static_cast<const long long*>(sel);
  const float* z = static_cast<const float*>(zc);
  float* o = static_cast<float*>(out);
  return for_case(n_images, weighting, [&](auto k, auto w) {
    constexpr int kK = decltype(k)::value, kW = decltype(w)::value;
#if K12_VARIANT == 0
    const dim3 blocks((P + 127) / 128, nz);
    parent_kernel<kK, kW><<<blocks, 128, 0, st>>>(
        f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], s, z, o, V, R,
        C, P, plane, sid, dgamma, row_h, beta0, dbeta, win);
#elif K12_VARIANT == 10 || K12_VARIANT == 11
    // the staged tiles, slice groups of at most 8 (10) or 16 (11)
    const int max_group = K12_VARIANT == 10 ? 8 : 16;
    const int groups = (nz + max_group - 1) / max_group;
    const int group = (nz + groups - 1) / groups;
    const dim3 blocks((P + kTile - 1) / kTile, (nz + group - 1) / group);
    tile_kernel<kK, kW><<<blocks, dim3(kTile, group), 0, st>>>(
        f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], s, z, o, V, R,
        C, P, nz, plane, sid, dgamma, row_h, dbeta, win);
#else
    constexpr int kS = Cfg<K12_VARIANT>::S, kThr = Cfg<K12_VARIANT>::kThr;
    const dim3 blocks((P + kThr - 1) / kThr, (nz + kS - 1) / kS);
    k12v_kernel<kK, kW, K12_VARIANT><<<blocks, kThr, 0, st>>>(
        f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], s, z, o, V, R,
        C, P, nz, plane, sid, dgamma, row_h, dbeta, win);
#endif
  });
}

// whether this variant reads the packed stacks
extern "C" int k12_step_packed() {
#if K12_VARIANT == 0
  return 0;
#elif K12_VARIANT == 10 || K12_VARIANT == 11
  return 1;
#else
  return Cfg<K12_VARIANT>::kPacked;
#endif
}
