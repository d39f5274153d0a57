// Voxel-driven backprojection of K filtered cone-beam stacks, six kernels
// with one set of tap device functions:
// - K11 fdk_backproject: circular Feldkamp (cylindrical detector);
// - K12 helical_backproject: generalized Feldkamp on a helix, in each of the
//   reference's six view weightings (full, feather, td, cosz, short, pair:
//   the window each voxel's views are weighted by around its slice's centre
//   beta_c);
// - K13 flat_backproject: circular Feldkamp on a flat panel;
// - K15 katsevich_backproject: the PI-window backprojection of Katsevich's
//   exact helical inversion;
// - K32 fdk_backproject_motion and K33 helical_backproject_motion: K11 and
//   K12 'full' with every voxel posed per view (rigid patient motion; their
//   note is beside them below).
//
// They replace dexct_tpu/ops/conebeam.py:_fdk_backproject_multi (K11),
// :_helical_backproject (K12), dexct_tpu/ops/flatpanel.py:_flat_backproject
// (K13) and dexct_tpu/ops/katsevich.py:_katsevich_backproject (K15).  The
// TPU programs are lax.scans over view blocks that gather one packed row of
// all the bilinear (or 4-row cubic) taps per (view, pixel, slice), with
// z-slice pairs sharing a 4-row window; K11's quarter-turn orbit fold stacks
// four views into one row, and K12 and K15 update only a dynamic window of
// slices per view block.  These are gather-count layouts of one image.
//
// What bounds them on the card: per (pixel, slice, view) one atan2 (K15
// also a cosine), one square root, three to six divisions and ~40 other
// float ops, plus four taps (eight for K15's cubic rows) of each of the K
// stacks (4 x 360 x 16 x 256 floats, 23.6 MB, at the cone protocol and
// 4 x 720 x 16 x 256, 47 MB, at the helical one: about the size of the
// 50 MB L2), so arithmetic dominates.  Design: one thread per (disc pixel,
// output slice) loops over the views and keeps its sums in registers, so the
// output is written once with no atomics; neighbouring threads are
// neighbouring disc pixels of one slice, whose taps sit on neighbouring
// channels of the same detector rows.  K11 and K12 instead give a thread
// one disc pixel and a group of slices, so that each (pixel, view)'s
// in-plane geometry serves every slice of the group, and read a packed
// copy of the stacks (their notes are beside them below).
// K11 and K13 stage cos/sin of the view
// angles in shared memory (kChunk views at a time) and visit every view.
// K12 and K15 visit only the views that can reach their slice, the views
// being uniformly spaced: K12 those within the weighting's half-width hw pi
// of beta_c (the reference's _helical_window_halfwidth), K15 those whose
// source z lies within z_reach of the slice (z_reach bounds the tapered
// Tam-Danielsson window's height over the FOV), each with a two-view
// margin; the exact per-view tests below decide the rest, and the views
// skipped are those whose terms the reference multiplies by an exact zero.
//
// Per view, as the JAX programs in float32 without fused multiply-adds
// (view_tap, channel_tap, row_tap and add_taps below):
// ell = sid - (X cos b + Y sin b), vt = -X sin b + Y cos b,
// h2 = ell^2 + vt^2, inv_h = 1 / sqrt(h2) (the JAX programs' rsqrt),
// a channel position c, in the fan when 0 <= c <= C-1,
// c0 = clamp(floor(c), 0, C-2), fc = clamp(c - c0, 0, 1);
// a row position ridx, on the detector when -0.5 <= ridx <= R-0.5,
// r0 = clamp(floor(ridx), 0, R-2), fr = clamp(ridx - r0, 0, 1); the tap rows
// are r0 and min(r0 + 1, R-1) (the JAX row shift repeats the last row) and
// the channels c0 and c0 + 1.
// K11: c = atan2(-vt, ell) / dgamma - 0.5 + C/2, ridx = z sid inv_h / row_h
// - 0.5 + R/2, weight 1 / h2; the sum is multiplied by dbeta.
// K12: c as K11, zt = (z - src_z[v]) sid inv_h, ridx = zt / row_h - 0.5 +
// R/2 + row_off[v]; a view on the detector with window weight w (below,
// from d = beta[v] - beta_c, gam = atan2(-vt, ell) and zt; each jnp.where
// and clip of the reference's win_weight in its order) adds w to the
// denominator and, inside the fan, (1 / h2) w times its tap to the
// numerator; out = (den > 0 ? num / max(den, 1e-30) : 0) 2 pi.
// K13: u = -sid vt / ell, c = u / du - 0.5 - off_c + C/2, ridx = (sid z /
// ell) / dv - 0.5 - off_r + R/2, weight sid^2 / ell^2; the sum is multiplied
// by dbeta / 2.
// K15: gam = atan2(-vt, ell), c as K11, zt = (z - src_z[v]) sid inv_h, ridx =
// zt / row_h - 0.5 + R/2; the Tam-Danielsson bounds htop = qp (pi + 2 gam) /
// cos gam and hbot = -qp (pi - 2 gam) / cos gam (qp = pitch / 4 pi) give
// w_td = clamp((zt - hbot) / taper + 0.5, 0, 1) clamp((htop - zt) / taper +
// 0.5, 0, 1); weight w_td / max(ell, 1e-3); rows linear as above or
// Catmull-Rom over rows r0-1 .. r0+2 (clamped to the detector); the sum is
// multiplied by -dbeta / 2 pi.  K12's `td` window and K15's come from
// td_window.cuh, which K20 (pi_backproject.cu) shares.

#include <cuda_runtime.h>
#include <math.h>
#include <type_traits>

#include "td_window.cuh"

namespace {

using dexct_td::clampf;
using dexct_td::kHalfPi;
using dexct_td::kPi;
using dexct_td::kTwoPi;

constexpr int kChunk = 512;

// The detector constants every view shares.
struct Detector {
  int R, C;
  float c_shift, c_max, c0_max, r_shift, r_hi, r0_max;
  long long view_stride, image_stride;
};

__device__ __forceinline__ Detector make_detector(int V, int R, int C) {
  Detector d;
  d.R = R;
  d.C = C;
  d.c_shift = 0.5f * (float)C;
  d.c_max = (float)(C - 1);
  d.c0_max = (float)(C - 2);
  d.r_shift = 0.5f * (float)R;
  d.r_hi = (float)R - 0.5f;
  d.r0_max = (float)(R >= 2 ? R - 2 : 0);
  d.view_stride = (long long)R * C;
  d.image_stride = (long long)V * d.view_stride;
  return d;
}

// The in-plane geometry of pixel (x, y) at one view.
struct ViewTap {
  float ell, vt, h2, inv_h;
};

__device__ __forceinline__ ViewTap view_tap(float x, float y, float cb,
                                            float sb, float sid) {
  ViewTap t;
  t.ell = __fsub_rn(sid, __fadd_rn(__fmul_rn(x, cb), __fmul_rn(y, sb)));
  t.vt = __fadd_rn(__fmul_rn(-x, sb), __fmul_rn(y, cb));
  t.h2 = __fadd_rn(__fmul_rn(t.ell, t.ell), __fmul_rn(t.vt, t.vt));
  t.inv_h = __fdiv_rn(1.0f, __fsqrt_rn(t.h2));
  return t;
}

__device__ __forceinline__ float channel(const ViewTap& t, float dgamma,
                                         const Detector& d) {
  return __fadd_rn(__fsub_rn(__fdiv_rn(atan2f(-t.vt, t.ell), dgamma), 0.5f),
                   d.c_shift);
}

__device__ __forceinline__ bool in_fan(float c, const Detector& d) {
  return c >= 0.0f && c <= d.c_max;
}

__device__ __forceinline__ bool on_detector(float ridx, const Detector& d) {
  return ridx >= -0.5f && ridx <= d.r_hi;
}

// The channel tap (c0, fc) and row tap (r0, fr) of a detector position.
__device__ __forceinline__ void channel_tap(float c, const Detector& d,
                                            float& c0, float& fc) {
  c0 = fminf(fmaxf(floorf(c), 0.0f), d.c0_max);
  fc = fminf(fmaxf(__fsub_rn(c, c0), 0.0f), 1.0f);
}

__device__ __forceinline__ void row_tap(float ridx, const Detector& d,
                                        float& r0, float& fr) {
  r0 = fminf(fmaxf(floorf(ridx), 0.0f), d.r0_max);
  fr = fminf(fmaxf(__fsub_rn(ridx, r0), 0.0f), 1.0f);
}

// q[row, c0] (1 - fc) + q[row, c0 + 1] fc of one stack at one view.
__device__ __forceinline__ float lerp_channels(const float* __restrict__ q,
                                               long long o, float fc) {
  return __fadd_rn(__fmul_rn(__ldg(q + o), 1.0f - fc),
                   __fmul_rn(__ldg(q + o + 1), fc));
}

// acc[k] += w x the bilinear value of stack k at view v, row ridx, channel
// c.
template <int K>
__device__ __forceinline__ void add_taps(const float* __restrict__ qs,
                                         const Detector& d, int v, float c,
                                         float ridx, float w, float* acc) {
  float c0, fc, r0, fr;
  channel_tap(c, d, c0, fc);
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
    acc[k] += __fadd_rn(__fmul_rn(top, 1.0f - fr), __fmul_rn(bot, fr)) * w;
  }
}

// The packed images of one detector element: K floats (K = 3 padded to 4).
template <int K>
struct Packed;
template <>
struct Packed<1> {
  static constexpr int kWidth = 1;
  float v[1];
  __device__ __forceinline__ Packed(const float* __restrict__ q, int o) {
    v[0] = __ldg(q + o);
  }
};
template <>
struct Packed<2> {
  static constexpr int kWidth = 2;
  float v[2];
  __device__ __forceinline__ Packed(const float* __restrict__ q, int o) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(q + o));
    v[0] = a.x;
    v[1] = a.y;
  }
};
template <>
struct Packed<4> {
  static constexpr int kWidth = 4;
  float v[4];
  __device__ __forceinline__ Packed(const float* __restrict__ q, int o) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(q + o));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
};
template <>
struct Packed<3> : Packed<4> {
  using Packed<4>::Packed;
};

// acc[k] += w x the bilinear value of packed image k at the element offset
// `base` of (view, row 0, c0), row position ridx, channel fraction fc (K11
// and K12).
template <int K>
__device__ __forceinline__ void add_packed_taps(const float* __restrict__ qp,
                                                const Detector& d, int base,
                                                float fc, float ridx, float w,
                                                float* acc) {
  constexpr int kw = Packed<K>::kWidth;
  float r0, fr;
  row_tap(ridx, d, r0, fr);
  const int ir0 = (int)r0;
  const int ir1 = min(ir0 + 1, d.R - 1);
  const int o0 = (base + ir0 * d.C) * kw;
  const int o1 = (base + ir1 * d.C) * kw;
  const Packed<K> t0(qp, o0), t1(qp, o0 + kw), b0(qp, o1), b1(qp, o1 + kw);
  const float gc = 1.0f - fc, gr = 1.0f - fr;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float top = __fadd_rn(__fmul_rn(t0.v[k], gc), __fmul_rn(t1.v[k], fc));
    const float bot = __fadd_rn(__fmul_rn(b0.v[k], gc), __fmul_rn(b1.v[k], fc));
    acc[k] = __fmaf_rn(__fadd_rn(__fmul_rn(top, gr), __fmul_rn(bot, fr)), w,
                       acc[k]);
  }
}

// K11 design.  The parent ran one thread per (disc pixel, slice) and
// recomputed each view's in-plane geometry (view_tap, atan2, the channel
// tap, 1 / h^2: ~131 of the 283 instructions of its view loop) for every
// slice; at 47 registers it issued near that count's floor.  Every slice of
// the circular orbit takes every view, so here one thread owns a disc pixel
// and kGroupK11 consecutive slices: it forms the pixel's in-plane geometry
// once per view (a view outside the fan is skipped for all of them), then
// the group's row quotients, each slice's division independent of the
// others', and adds that view's term to each slice whose row lies on the
// detector.  The sums stay in registers, under launch bounds of 64
// registers; the slices' z sid, block constants, are read from shared
// memory.  Each slice's sum is the parent's: the same terms of the same
// views in the same order, each value from the same expression (the
// parent's `acc += val * w` was contracted by nvcc into an FFMA, written
// here as __fmaf_rn, in add_packed_taps).  The taps come from K12's packed
// copy of the stacks ([V, R, C, KP], the images innermost), one 16-, 8- or
// 4-byte load a detector element at a 32-bit offset.

// the slices a thread owns; the threads a block and the blocks an SM
// must hold (launch bounds: 64 registers)
constexpr int kGroupK11 = 8;
constexpr int kThreadsK11 = 128;
constexpr int kBlocksK11 = 8;

template <int K>
__global__ void __launch_bounds__(kThreadsK11, kBlocksK11)
    fdk_backproject_kernel(
        const float* __restrict__ qp, const float* __restrict__ cos_b,
        const float* __restrict__ sin_b, const float* __restrict__ X,
        const float* __restrict__ Y, const long long* __restrict__ sel,
        const float* __restrict__ zc, float* __restrict__ out, int V, int R,
        int C, int P, int nz, long long plane, float sid, float dgamma,
        float row_h, float dbeta) {
  __shared__ float s_cos[kChunk];
  __shared__ float s_sin[kChunk];
  __shared__ float s_zs[kGroupK11];
  __shared__ int s_iz[kGroupK11];  // the slice of each slot, -1 past nz
  if (threadIdx.x < kGroupK11) {
    const int iz = blockIdx.y * kGroupK11 + threadIdx.x;
    s_iz[threadIdx.x] = iz < nz ? iz : -1;
    s_zs[threadIdx.x] = iz < nz ? __fmul_rn(zc[iz], sid) : 0.0f;
  }
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = p < P;
  const float x = valid ? X[p] : 0.0f;
  const float y = valid ? Y[p] : 0.0f;
  const Detector d = make_detector(V, R, C);

  float acc[kGroupK11][K];
#pragma unroll
  for (int s = 0; s < kGroupK11; ++s)
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
      float quot[kGroupK11];
#pragma unroll
      for (int s = 0; s < kGroupK11; ++s)
        quot[s] = __fdiv_rn(__fmul_rn(s_zs[s], t.inv_h), row_h);
#pragma unroll
      for (int s = 0; s < kGroupK11; ++s) {
        if (s_iz[s] < 0) continue;
        const float ridx = __fadd_rn(__fsub_rn(quot[s], 0.5f), d.r_shift);
        if (!on_detector(ridx, d)) continue;
        add_packed_taps<K>(qp, d, base, fc, ridx, w, acc[s]);
      }
    }
  }
  if (!valid) return;
  const long long vol = (long long)nz * plane;
  const long long px = sel[p];
#pragma unroll
  for (int s = 0; s < kGroupK11; ++s) {
    const int iz = s_iz[s];
    if (iz < 0) continue;
#pragma unroll
    for (int k = 0; k < K; ++k)
      out[k * vol + (long long)iz * plane + px] = __fmul_rn(acc[s][k], dbeta);
  }
}

// The scalars of K12's windows, each the reference's Python float rounded
// once to float32 (computed on the host in float64).
struct Window {
  float hwpi, pitch, qp, nqp, taper, hmax, gm, pi_2gm, two_sid, hdet, scale;
};

enum Weighting { kFull, kFeather, kTd, kCosz, kShort, kPair };

constexpr float kQuarterPi = 0.78539816339744830962f;  // float32(pi / 4)
constexpr float kOneHalfPi = 4.71238898038468985769f;  // float32(1.5 pi)

__device__ __forceinline__ float cos2(float x) {
  const float c = cosf(x);
  return __fmul_rn(c, c);
}

// K12 design.  The parent ran one thread per (disc pixel, slice) and
// recomputed each view's in-plane geometry (view_tap, atan2, the channel
// tap, 1 / h^2: ~120 of the ~250 instructions its `full` loop executes a
// term) for every slice that view feeds, ~9.6x over at the helical config
// (19 slices, ~365 views a slice, 720 views); at 64 registers (32 warps an
// SM) it issued at ~95 % of that count's floor.  Here one thread owns a
// disc pixel and kGroup consecutive slices: it walks the union of those
// slices' view ranges in ascending order, forms the pixel's in-plane
// geometry (and the parts of the window that depend on the pixel and the
// view only, ViewWindow) once per view, and adds that view's term to each
// slice of the group whose own range holds the view.  The sums stay in
// registers; the slices' z, beta_c and view ranges, block constants, are
// read from shared memory, and the launch bounds hold the kernel to the
// parent's 64 registers: its occupancy, not its instruction count, is what
// the first designs lost (tools/k12_steps.cu, PERF.md: 8 slices a thread
// at 118 registers, or a block staging 32 views' geometry in shared memory
// for 32 pixels x 10 slices, ran 2.65 and 4.26 ms against the parent's
// 3.26).  Each slice's sums are the parent's: the same terms of the same
// views in the same order, each value from the same expression (the
// parent's `acc += val * w` was contracted by nvcc into an FFMA, written
// here as __fmaf_rn).  The taps come from a packed copy of the stacks with
// the K images innermost ([V, R, C, KP], KP = 4 at K = 3), so a tap row is
// one 16-byte (K = 3, 4), 8-byte (K = 2) or 4-byte load a channel instead
// of K scalar loads.

// the slices a thread owns; the threads a block and the blocks an SM
// must hold (launch bounds: 64 registers, the parent's count)
constexpr int kGroup = 4;
constexpr int kThreadsK12 = 128;
constexpr int kBlocksK12 = 8;

// The parts of one view's window weight that depend only on the pixel and
// the view (p0..p3, by weighting: td the window's edges over cos gam;
// short the ends and widths of the Parker ramps; pair 2 gam, the conjugate
// source heights on either side and the conjugate ray's length).
struct ViewWindow {
  float p0, p1, p2, p3;
};

template <int W>
__device__ __forceinline__ ViewWindow view_window(const Window& k, float gam,
                                                  const ViewTap& t,
                                                  float sz) {
  ViewWindow vw{0.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (W == kTd) {
    const dexct_td::Bounds b = dexct_td::over_cos(
        dexct_td::bounds(k.qp, k.nqp, gam), cosf(gam));
    vw.p0 = b.top;
    vw.p1 = b.bot;
  } else if constexpr (W == kShort) {
    vw.p0 = __fmul_rn(2.0f, __fsub_rn(k.gm, gam));
    vw.p1 = fmaxf(__fsub_rn(k.gm, gam), 1e-3f);
    vw.p2 = __fsub_rn(kPi, __fmul_rn(2.0f, gam));
    vw.p3 = fmaxf(__fadd_rn(k.gm, gam), 1e-3f);
  } else if constexpr (W == kPair) {
    const float two_g = __fmul_rn(2.0f, gam);
    vw.p0 = two_g;
    vw.p1 = __fadd_rn(
        sz, __fdiv_rn(__fmul_rn(-__fsub_rn(kPi, two_g), k.pitch), kTwoPi));
    vw.p2 = __fadd_rn(
        sz, __fdiv_rn(__fmul_rn(__fadd_rn(kPi, two_g), k.pitch), kTwoPi));
    const float h_own = __fmul_rn(t.h2, t.inv_h);
    vw.p3 = fmaxf(__fsub_rn(__fmul_rn(k.two_sid, cosf(gam)), h_own), 1e-3f);
  }
  return vw;
}

// The window weight of one view at one slice without its on-detector
// factor: d = beta - beta_c, zt the iso-scaled row height of the slice z,
// vw the view's pixel part.  Each jnp.where and clip of the reference's
// win_weight in its order.
template <int W>
__device__ __forceinline__ float term_weight(const Window& k,
                                             const ViewWindow& vw, float d,
                                             float zt, float z, float sid) {
  if constexpr (W == kFull) {
    return fabsf(d) <= kPi ? 1.0f : 0.0f;
  } else if constexpr (W == kFeather) {
    const float dd = __fdiv_rn(fabsf(d), kPi);
    return cos2(__fmul_rn(
        clampf(__fdiv_rn(__fsub_rn(dd, 0.75f), 0.5f), 0.0f, 1.0f), kHalfPi));
  } else if constexpr (W == kTd) {
    if (!(fabsf(d) <= kOneHalfPi)) return 0.0f;
    return dexct_td::weight<false>(zt, {vw.p0, vw.p1}, k.taper);
  } else if constexpr (W == kCosz) {
    if (!(fabsf(d) <= kOneHalfPi)) return 0.0f;
    return __fadd_rn(
        cos2(__fmul_rn(clampf(__fdiv_rn(zt, k.hmax), -1.0f, 1.0f), kHalfPi)),
        1e-3f);
  } else if constexpr (W == kShort) {
    const float alpha = __fadd_rn(__fadd_rn(d, kHalfPi), k.gm);
    if (!(alpha >= 0.0f && alpha <= k.pi_2gm)) return 0.0f;
    if (alpha < vw.p0) {
      const float s = sinf(__fmul_rn(
          kQuarterPi, clampf(__fdiv_rn(alpha, vw.p1), 0.0f, 2.0f)));
      return __fmul_rn(s, s);
    }
    if (alpha > vw.p2) {
      const float s = sinf(__fmul_rn(
          kQuarterPi,
          clampf(__fdiv_rn(__fsub_rn(k.pi_2gm, alpha), vw.p3), 0.0f, 2.0f)));
      return __fmul_rn(s, s);
    }
    return 1.0f;
  } else {  // kPair: the conjugate copy's row height, a smooth partition
    if (!(fabsf(d) <= kPi)) return 0.0f;
    const float sz_conj = d > -vw.p0 ? vw.p1 : vw.p2;
    const float zt_c =
        __fdiv_rn(__fmul_rn(__fsub_rn(z, sz_conj), sid), vw.p3);
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
}

template <int K, int W>
__global__ void __launch_bounds__(kThreadsK12, kBlocksK12)
    helical_backproject_kernel(
        const float* __restrict__ qp, const float* __restrict__ cos_b,
        const float* __restrict__ sin_b, const float* __restrict__ betas,
        const float* __restrict__ src_z, const float* __restrict__ row_off,
        const float* __restrict__ beta_c, const float* __restrict__ X,
        const float* __restrict__ Y, const long long* __restrict__ sel,
        const float* __restrict__ zc, float* __restrict__ out, int V, int R,
        int C, int P, int nz, long long plane, float sid, float dgamma,
        float row_h, float dbeta, Window win) {
  // the group's slices: z, beta_c and view range (those within hw pi of
  // beta_c, with a two-view margin: the parent's range; a slice past nz
  // visits none), block constants read from shared memory so that the
  // registers hold the sums
  __shared__ float s_z[kGroup], s_bc[kGroup];
  __shared__ int s_lo[kGroup], s_hi[kGroup];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int s0 = blockIdx.y * kGroup;
  const float beta0 = __ldg(betas);
  int v_first = V, v_last = -1;
#pragma unroll
  for (int s = 0; s < kGroup; ++s) {
    float z = 0.0f, bc = 0.0f;
    int lo = V, hi = -1;
    if (s0 + s < nz) {
      z = zc[s0 + s];
      bc = beta_c[s0 + s];
      lo = max(0, (int)floorf((bc - win.hwpi - beta0) / dbeta) - 2);
      hi = min(V - 1, (int)ceilf((bc + win.hwpi - beta0) / dbeta) + 2);
    }
    if (threadIdx.x == s) {
      s_z[s] = z;
      s_bc[s] = bc;
      s_lo[s] = lo;
      s_hi[s] = hi;
    }
    v_first = min(v_first, lo);
    v_last = max(v_last, hi);
  }
  __syncthreads();
  if (p >= P) return;
  const float x = X[p], y = Y[p];
  const Detector d = make_detector(V, R, C);

  float num[kGroup][K], den[kGroup];
#pragma unroll
  for (int s = 0; s < kGroup; ++s) {
    den[s] = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) num[s][k] = 0.0f;
  }

  for (int v = v_first; v <= v_last; ++v) {
    // the pixel's in-plane geometry at view v, once for every slice
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
    const int base = v * R * C + (int)c0;
    const float inv_h2 = __fdiv_rn(1.0f, t.h2);
    const ViewWindow vw = view_window<W>(win, gam, t, sz);
#pragma unroll
    for (int s = 0; s < kGroup; ++s) {
      if (v < s_lo[s] || v > s_hi[s]) continue;
      const float dv = __fsub_rn(bv, s_bc[s]);
      if (W == kFull && !(fabsf(dv) <= kPi)) continue;
      const float z = s_z[s];
      const float zt = __fmul_rn(__fmul_rn(__fsub_rn(z, sz), sid), t.inv_h);
      const float ridx = __fadd_rn(
          __fadd_rn(__fsub_rn(__fdiv_rn(zt, row_h), 0.5f), d.r_shift), ro);
      if (!on_detector(ridx, d)) continue;
      const float w = term_weight<W>(win, vw, dv, zt, z, sid);
      if (w == 0.0f) continue;
      den[s] += w;
      if (!fan) continue;
      // `full`'s w is 1, and inv_h2 x 1 is inv_h2
      add_packed_taps<K>(qp, d, base, fc, ridx,
                         W == kFull ? inv_h2 : __fmul_rn(inv_h2, w), num[s]);
    }
  }
  const long long vol = (long long)nz * plane;
#pragma unroll
  for (int s = 0; s < kGroup; ++s) {
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

template <int K>
__global__ void flat_backproject_kernel(
    const float* __restrict__ qs, const float* __restrict__ cos_b,
    const float* __restrict__ sin_b, const float* __restrict__ X,
    const float* __restrict__ Y, const long long* __restrict__ sel,
    const float* __restrict__ zc, float* __restrict__ out, int V, int R,
    int C, int P, long long plane, float sid, float du, float dv,
    float off_c, float off_r, float dbeta) {
  __shared__ float s_cos[kChunk];
  __shared__ float s_sin[kChunk];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int iz = blockIdx.y;
  const bool valid = p < P;
  const float x = valid ? X[p] : 0.0f;
  const float y = valid ? Y[p] : 0.0f;
  const float zs = __fmul_rn(sid, zc[iz]);
  const float nsid = -sid;
  const float sid2 = __fmul_rn(sid, sid);
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
      const float u = __fdiv_rn(__fmul_rn(nsid, t.vt), t.ell);
      const float c = __fadd_rn(
          __fsub_rn(__fsub_rn(__fdiv_rn(u, du), 0.5f), off_c), d.c_shift);
      if (!in_fan(c, d)) continue;
      const float ridx = __fadd_rn(
          __fsub_rn(__fsub_rn(__fdiv_rn(__fdiv_rn(zs, t.ell), dv), 0.5f),
                    off_r),
          d.r_shift);
      if (!on_detector(ridx, d)) continue;
      add_taps<K>(qs, d, v0 + j, c, ridx,
                  __fdiv_rn(sid2, __fmul_rn(t.ell, t.ell)), acc);
    }
  }
  if (!valid) return;
  const long long dst = (long long)iz * plane + sel[p];
  const long long vol = (long long)gridDim.y * plane;
  const float scale = 0.5f * dbeta;
#pragma unroll
  for (int k = 0; k < K; ++k) out[k * vol + dst] = acc[k] * scale;
}

// The Catmull-Rom row weights at fraction fr, in the reference's order.
__device__ __forceinline__ void cubic_weights(float fr, float* w) {
  const float fr2 = __fmul_rn(fr, fr);
  const float fr3 = __fmul_rn(fr2, fr);
  w[0] = __fsub_rn(__fadd_rn(__fmul_rn(-0.5f, fr), fr2), __fmul_rn(0.5f, fr3));
  w[1] = __fadd_rn(__fsub_rn(1.0f, __fmul_rn(2.5f, fr2)),
                   __fmul_rn(1.5f, fr3));
  w[2] = __fsub_rn(__fadd_rn(__fmul_rn(0.5f, fr), __fmul_rn(2.0f, fr2)),
                   __fmul_rn(1.5f, fr3));
  w[3] = __fadd_rn(__fmul_rn(-0.5f, fr2), __fmul_rn(0.5f, fr3));
}

template <int K, bool kCubic>
__global__ void katsevich_backproject_kernel(
    const float* __restrict__ gf, const float* __restrict__ cos_b,
    const float* __restrict__ sin_b, const float* __restrict__ src_z,
    const float* __restrict__ X, const float* __restrict__ Y,
    const long long* __restrict__ sel, const float* __restrict__ zc,
    float* __restrict__ out, int V, int R, int C, int P, long long plane,
    float sid, float dgamma, float row_h, float qp, float taper, float scale,
    float sz0, float dzv, float z_reach) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int iz = blockIdx.y;
  if (p >= P) return;
  const float x = X[p], y = Y[p];
  const float z = zc[iz];
  const Detector d = make_detector(V, R, C);
  int v_lo = 0, v_hi = V - 1;
  if (z_reach > 0.0f) {  // the views whose source lies within z_reach of z
    const float a = (z - z_reach - sz0) / dzv;
    const float b = (z + z_reach - sz0) / dzv;
    v_lo = max(0, (int)floorf(fminf(a, b)) - 2);
    v_hi = min(V - 1, (int)ceilf(fmaxf(a, b)) + 2);
  }
  const float nqp = -qp;

  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0f;

  for (int v = v_lo; v <= v_hi; ++v) {
    const ViewTap t =
        view_tap(x, y, __ldg(cos_b + v), __ldg(sin_b + v), sid);
    const float gam = atan2f(-t.vt, t.ell);
    const float c = __fadd_rn(__fsub_rn(__fdiv_rn(gam, dgamma), 0.5f),
                              d.c_shift);
    if (!in_fan(c, d)) continue;
    const float zt = __fmul_rn(
        __fmul_rn(__fsub_rn(z, __ldg(src_z + v)), sid), t.inv_h);
    const float ridx = __fadd_rn(__fsub_rn(__fdiv_rn(zt, row_h), 0.5f),
                                 d.r_shift);
    if (!on_detector(ridx, d)) continue;
    // the window at -gam: htop = qp (pi + 2 gam) / cos gam, hbot = -qp (pi -
    // 2 gam) / cos gam (negating gam is exact)
    const float w_td = dexct_td::weight<true>(
        zt, dexct_td::over_cos(dexct_td::bounds(qp, nqp, -gam), cosf(gam)),
        taper);
    if (w_td == 0.0f) continue;
    const float w = __fmul_rn(__fdiv_rn(1.0f, fmaxf(t.ell, 1e-3f)), w_td);
    if (!kCubic) {
      add_taps<K>(gf, d, v, c, ridx, w, acc);
      continue;
    }
    float c0, fc, r0, fr, wr[4];
    channel_tap(c, d, c0, fc);
    row_tap(ridx, d, r0, fr);
    cubic_weights(fr, wr);
    const int ir0 = (int)r0;
    const long long base = (long long)v * d.view_stride + (int)c0;
    long long o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)  // rows r0-1 .. r0+2, edges replicated
      o[j] = base + (long long)min(max(ir0 - 1 + j, 0), R - 1) * d.C;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float* q = gf + k * d.image_stride;
      float val = __fmul_rn(wr[0], lerp_channels(q, o[0], fc));
#pragma unroll
      for (int j = 1; j < 4; ++j)
        val = __fadd_rn(val, __fmul_rn(wr[j], lerp_channels(q, o[j], fc)));
      acc[k] += val * w;
    }
  }
  const long long dst = (long long)iz * plane + sel[p];
  const long long vol = (long long)gridDim.y * plane;
#pragma unroll
  for (int k = 0; k < K; ++k) out[k * vol + dst] = __fmul_rn(acc[k], scale);
}

// K32 fdk_backproject_motion and K33 helical_backproject_motion replace
// dexct_tpu/ops/motion.py:_fdk_backproject_motion and
// :_helical_backproject_motion (lax.scans over 8-view blocks that gather
// the packed (row, channel) taps of every posed voxel and carry num and den
// volumes).  Each view evaluates the voxel at its world position under the
// view's rigid pose: (x, y) -> (cos phi x - sin phi y + dx, sin phi x +
// cos phi y + dy) in the JAX order without FMAs (pose() below), z -> z +
// dz.  Then K11's (K32) or K12's (K33) taps on the posed position: a view
// on the detector adds 1 to den (K33: only inside its window) and, inside
// the fan, its bilinear tap times 1 / h^2 to num; out = (den > 0 ? num /
// max(den, 1e-30) : 0) 2 pi, the accumulated-coverage normalisation that
// keeps z motion from shading the slices it pushes off the rows.
// K32: zt = (z + dz) sid inv_h, ridx = zt / row_h - 0.5 + R/2, every view.
// K33: zv = z + dz, zt = (zv - src_z[v]) sid inv_h, ridx as K32; the 2 pi
// window |beta[v] - bc_v| <= pi is centred per view on bc_v = beta_mid +
// (2 pi zv) / pitch, the source's passage of the voxel's posed z.
//
// What bounds them on the card: as K11/K12, one atan2, one square root,
// three divisions and ~45 other float ops per (pixel, slice, view) plus the
// taps, so arithmetic.  (The in-plane part, ~35 of them, depends only on
// the pixel and the view: one thread per (pixel, slice) recomputes it for
// each slice, where the function needs it once per (pixel, view).)
// Design: K11's and K12's, one thread per (disc
// pixel, slice) and the sums in registers; one kernel, templated on the
// window.  It stages the view angles and the poses in shared memory
// (kChunk views at a time).  K32 visits every view.  K33 visits only the
// views whose window can reach its slice: with the centre moving by 2 pi
// dz_v / pitch, that is beta in [bc + shift_lo - pi, bc + shift_hi + pi]
// (bc the centre at dz = 0; shift_lo and shift_hi the least and largest
// 2 pi dz_v / pitch, computed on the host), with K12's two-view margin;
// the exact per-view window test decides the rest.

// The posed in-plane position of (x, y) at one view.
__device__ __forceinline__ void pose(float x, float y, float cp, float sp,
                                     float dx, float dy, float& xv,
                                     float& yv) {
  xv = __fadd_rn(__fsub_rn(__fmul_rn(cp, x), __fmul_rn(sp, y)), dx);
  yv = __fadd_rn(__fadd_rn(__fmul_rn(sp, x), __fmul_rn(cp, y)), dy);
}

// out[k] = (den > 0 ? num[k] / max(den, 1e-30) : 0) 2 pi at (slice, pixel).
template <int K>
__device__ __forceinline__ void store_normalised(float* __restrict__ out,
                                                 const float* num, float den,
                                                 long long dst,
                                                 long long vol) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float o = den > 0.0f ? __fdiv_rn(num[k], fmaxf(den, 1e-30f)) : 0.0f;
    out[k * vol + dst] = __fmul_rn(o, kTwoPi);
  }
}

// K32 (kWindow false: every view, src_z 0) and K33 (kWindow true: the
// views that the slice's moving window can reach, each tested).
template <int K, bool kWindow>
__global__ void motion_backproject_kernel(
    const float* __restrict__ qs, const float* __restrict__ cos_b,
    const float* __restrict__ sin_b, const float* __restrict__ betas,
    const float* __restrict__ src_z, const float* __restrict__ cos_p,
    const float* __restrict__ sin_p, const float* __restrict__ dxs,
    const float* __restrict__ dys, const float* __restrict__ dzs,
    const float* __restrict__ X, const float* __restrict__ Y,
    const long long* __restrict__ sel, const float* __restrict__ zc,
    float* __restrict__ out, int V, int R, int C, int P, long long plane,
    float sid, float dgamma, float row_h, float pitch, float beta_mid,
    float dbeta, float shift_lo, float shift_hi) {
  __shared__ float s_cb[kChunk];
  __shared__ float s_sb[kChunk];
  __shared__ float s_cp[kChunk];
  __shared__ float s_sp[kChunk];
  __shared__ float s_dx[kChunk];
  __shared__ float s_dy[kChunk];
  __shared__ float s_dz[kChunk];
  __shared__ float s_b[kWindow ? kChunk : 1];
  __shared__ float s_sz[kWindow ? kChunk : 1];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int iz = blockIdx.y;
  const bool valid = p < P;
  const float x = valid ? X[p] : 0.0f;
  const float y = valid ? Y[p] : 0.0f;
  const float z = zc[iz];
  const Detector d = make_detector(V, R, C);
  int v_lo = 0, v_hi = V - 1;
  if (kWindow) {
    // the views within pi of the window centre under any pose, with a
    // two-view margin (one range per slice, so per block), from the views'
    // origin betas[0]
    const float beta0 = __ldg(betas);
    const float bc = beta_mid + kTwoPi * z / pitch;
    v_lo = max(0, (int)floorf((bc + shift_lo - kPi - beta0) / dbeta) - 2);
    v_hi = min(V - 1, (int)ceilf((bc + shift_hi + kPi - beta0) / dbeta) + 2);
  }

  float num[K];
#pragma unroll
  for (int k = 0; k < K; ++k) num[k] = 0.0f;
  float den = 0.0f;

  for (int v0 = v_lo; v0 <= v_hi; v0 += kChunk) {
    const int nv = min(kChunk, v_hi + 1 - v0);
    __syncthreads();
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      s_cb[i] = cos_b[v0 + i];
      s_sb[i] = sin_b[v0 + i];
      s_cp[i] = cos_p[v0 + i];
      s_sp[i] = sin_p[v0 + i];
      s_dx[i] = dxs[v0 + i];
      s_dy[i] = dys[v0 + i];
      s_dz[i] = dzs[v0 + i];
      if (kWindow) {
        s_b[i] = betas[v0 + i];
        s_sz[i] = src_z[v0 + i];
      }
    }
    __syncthreads();
    if (!valid) continue;
    for (int j = 0; j < nv; ++j) {
      const float zv = __fadd_rn(z, s_dz[j]);
      if (kWindow) {
        const float bcv =
            __fadd_rn(beta_mid, __fdiv_rn(__fmul_rn(kTwoPi, zv), pitch));
        if (!(fabsf(__fsub_rn(s_b[j], bcv)) <= kPi)) continue;
      }
      float xv, yv;
      pose(x, y, s_cp[j], s_sp[j], s_dx[j], s_dy[j], xv, yv);
      const ViewTap t = view_tap(xv, yv, s_cb[j], s_sb[j], sid);
      const float zs = kWindow ? __fsub_rn(zv, s_sz[j]) : zv;
      const float zt = __fmul_rn(__fmul_rn(zs, sid), t.inv_h);
      const float ridx = __fadd_rn(__fsub_rn(__fdiv_rn(zt, row_h), 0.5f),
                                   d.r_shift);
      if (!on_detector(ridx, d)) continue;
      den += 1.0f;  // on the detector (and in the window), in the fan or not
      const float c = channel(t, dgamma, d);
      if (!in_fan(c, d)) continue;
      add_taps<K>(qs, d, v0 + j, c, ridx, __fdiv_rn(1.0f, t.h2), num);
    }
  }
  if (!valid) return;
  store_normalised<K>(out, num, den, (long long)iz * plane + sel[p],
                      (long long)gridDim.y * plane);
}

// Calls launch(std::integral_constant<int, K>) for K = n_images in 1..4.
template <typename Launch>
int for_images(int n_images, Launch&& launch) {
  switch (n_images) {
    case 1: launch(std::integral_constant<int, 1>{}); break;
    case 2: launch(std::integral_constant<int, 2>{}); break;
    case 3: launch(std::integral_constant<int, 3>{}); break;
    case 4: launch(std::integral_constant<int, 4>{}); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

constexpr int kThreads = 128;

}  // namespace

extern "C" int dexct_fdk_backproject(const void* packed, const void* cos_b,
                                     const void* sin_b, const void* X,
                                     const void* Y, const void* sel,
                                     const void* zc, void* out, int n_images,
                                     int V, int R, int C, int P, int nz,
                                     long long plane, float sid, float dgamma,
                                     float row_h, float dbeta, void* stream) {
  if (P <= 0 || nz <= 0) return (int)cudaGetLastError();
  // the packed taps are addressed with 32-bit element offsets
  const long long width = n_images == 3 ? 4 : n_images;
  if (C < 2 || R < 1 || (long long)V * R * C * width >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const dim3 blocks((P + kThreadsK11 - 1) / kThreadsK11,
                    (nz + kGroupK11 - 1) / kGroupK11);
  if (blocks.y > 65535) return (int)cudaErrorInvalidValue;
  return for_images(n_images, [&](auto k) {
    fdk_backproject_kernel<decltype(k)::value>
        <<<blocks, kThreadsK11, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(packed),
            static_cast<const float*>(cos_b),
            static_cast<const float*>(sin_b), static_cast<const float*>(X),
            static_cast<const float*>(Y), static_cast<const long long*>(sel),
            static_cast<const float*>(zc), static_cast<float*>(out), V, R, C,
            P, nz, plane, sid, dgamma, row_h, dbeta);
  });
}

extern "C" int dexct_helical_backproject(
    const void* packed, const void* cos_b, const void* sin_b, const void* betas,
    const void* src_z, const void* row_off, const void* beta_c, const void* X,
    const void* Y, const void* sel, const void* zc, void* out, int n_images,
    int weighting, int V, int R, int C, int P, int nz, long long plane,
    float sid, float dgamma, float row_h, float dbeta, float hwpi,
    float pitch, float qp, float nqp, float taper, float hmax, float gm,
    float pi_2gm, float two_sid, float hdet, float scale, void* stream) {
  if (P <= 0 || nz <= 0) return (int)cudaGetLastError();
  // the packed taps are addressed with 32-bit element offsets
  const long long width = n_images == 3 ? 4 : n_images;
  if (C < 2 || R < 1 || !(dbeta > 0.0f) || weighting < 0 ||
      weighting > kPair || (long long)V * R * C * width >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const Window win{hwpi, pitch, qp, nqp, taper, hmax, gm, pi_2gm, two_sid,
                   hdet, scale};
  const dim3 blocks((P + kThreadsK12 - 1) / kThreadsK12,
                    (nz + kGroup - 1) / kGroup);
  if (blocks.y > 65535) return (int)cudaErrorInvalidValue;
  return for_images(n_images, [&](auto k) {
    constexpr int kK = decltype(k)::value;
    auto* kern = helical_backproject_kernel<kK, kFull>;
    switch (weighting) {
      case kFeather: kern = helical_backproject_kernel<kK, kFeather>; break;
      case kTd: kern = helical_backproject_kernel<kK, kTd>; break;
      case kCosz: kern = helical_backproject_kernel<kK, kCosz>; break;
      case kShort: kern = helical_backproject_kernel<kK, kShort>; break;
      case kPair: kern = helical_backproject_kernel<kK, kPair>; break;
      default: break;
    }
    kern<<<blocks, kThreadsK12, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(packed), static_cast<const float*>(cos_b),
        static_cast<const float*>(sin_b), static_cast<const float*>(betas),
        static_cast<const float*>(src_z), static_cast<const float*>(row_off),
        static_cast<const float*>(beta_c), static_cast<const float*>(X),
        static_cast<const float*>(Y), static_cast<const long long*>(sel),
        static_cast<const float*>(zc), static_cast<float*>(out), V, R, C, P,
        nz, plane, sid, dgamma, row_h, dbeta, win);
  });
}

extern "C" int dexct_flat_backproject(const void* qs, const void* cos_b,
                                      const void* sin_b, const void* X,
                                      const void* Y, const void* sel,
                                      const void* zc, void* out, int n_images,
                                      int V, int R, int C, int P, int nz,
                                      long long plane, float sid, float du,
                                      float dv, float off_c, float off_r,
                                      float dbeta, void* stream) {
  if (P <= 0 || nz <= 0) return (int)cudaGetLastError();
  if (C < 2 || R < 1 || nz > 65535) return (int)cudaErrorInvalidValue;
  const dim3 blocks((P + kThreads - 1) / kThreads, nz);
  return for_images(n_images, [&](auto k) {
    flat_backproject_kernel<decltype(k)::value>
        <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(qs), static_cast<const float*>(cos_b),
            static_cast<const float*>(sin_b), static_cast<const float*>(X),
            static_cast<const float*>(Y), static_cast<const long long*>(sel),
            static_cast<const float*>(zc), static_cast<float*>(out), V, R, C,
            P, plane, sid, du, dv, off_c, off_r, dbeta);
  });
}

extern "C" int dexct_katsevich_backproject(
    const void* gf, const void* cos_b, const void* sin_b, const void* src_z,
    const void* X, const void* Y, const void* sel, const void* zc, void* out,
    int n_images, int cubic, int V, int R, int C, int P, int nz,
    long long plane, float sid, float dgamma, float row_h, float qp,
    float taper, float scale, float sz0, float dzv, float z_reach,
    void* stream) {
  if (P <= 0 || nz <= 0) return (int)cudaGetLastError();
  if (C < 2 || R < 1 || nz > 65535 || (z_reach > 0.0f && !(dzv != 0.0f)))
    return (int)cudaErrorInvalidValue;
  const dim3 blocks((P + kThreads - 1) / kThreads, nz);
  return for_images(n_images, [&](auto k) {
    constexpr int kK = decltype(k)::value;
    auto* kern = cubic ? katsevich_backproject_kernel<kK, true>
                       : katsevich_backproject_kernel<kK, false>;
    kern<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(gf), static_cast<const float*>(cos_b),
        static_cast<const float*>(sin_b), static_cast<const float*>(src_z),
        static_cast<const float*>(X), static_cast<const float*>(Y),
        static_cast<const long long*>(sel), static_cast<const float*>(zc),
        static_cast<float*>(out), V, R, C, P, plane, sid, dgamma, row_h, qp,
        taper, scale, sz0, dzv, z_reach);
  });
}

// Launches K32 (window false) or K33 over K = n_images stacks.
template <bool kWindow>
int launch_motion(const void* qs, const void* cos_b, const void* sin_b,
                  const void* betas, const void* src_z, const void* cos_p,
                  const void* sin_p, const void* dx, const void* dy,
                  const void* dz, const void* X, const void* Y,
                  const void* sel, const void* zc, void* out, int n_images,
                  int V, int R, int C, int P, int nz, long long plane,
                  float sid, float dgamma, float row_h, float pitch,
                  float beta_mid, float dbeta, float shift_lo,
                  float shift_hi, void* stream) {
  if (P <= 0 || nz <= 0) return (int)cudaGetLastError();
  if (C < 2 || R < 1 || nz > 65535) return (int)cudaErrorInvalidValue;
  const dim3 blocks((P + kThreads - 1) / kThreads, nz);
  return for_images(n_images, [&](auto k) {
    motion_backproject_kernel<decltype(k)::value, kWindow>
        <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(qs), static_cast<const float*>(cos_b),
            static_cast<const float*>(sin_b),
            static_cast<const float*>(betas),
            static_cast<const float*>(src_z),
            static_cast<const float*>(cos_p),
            static_cast<const float*>(sin_p), static_cast<const float*>(dx),
            static_cast<const float*>(dy), static_cast<const float*>(dz),
            static_cast<const float*>(X), static_cast<const float*>(Y),
            static_cast<const long long*>(sel),
            static_cast<const float*>(zc), static_cast<float*>(out), V, R, C,
            P, plane, sid, dgamma, row_h, pitch, beta_mid, dbeta, shift_lo,
            shift_hi);
  });
}

extern "C" int dexct_fdk_backproject_motion(
    const void* qs, const void* cos_b, const void* sin_b, const void* cos_p,
    const void* sin_p, const void* dx, const void* dy, const void* dz,
    const void* X, const void* Y, const void* sel, const void* zc, void* out,
    int n_images, int V, int R, int C, int P, int nz, long long plane,
    float sid, float dgamma, float row_h, void* stream) {
  return launch_motion<false>(qs, cos_b, sin_b, nullptr, nullptr, cos_p,
                              sin_p, dx, dy, dz, X, Y, sel, zc, out,
                              n_images, V, R, C, P, nz, plane, sid, dgamma,
                              row_h, 1.0f, 0.0f, 1.0f, 0.0f, 0.0f, stream);
}

extern "C" int dexct_helical_backproject_motion(
    const void* qs, const void* cos_b, const void* sin_b, const void* betas,
    const void* src_z, const void* cos_p, const void* sin_p, const void* dx,
    const void* dy, const void* dz, const void* X, const void* Y,
    const void* sel, const void* zc, void* out, int n_images, int V, int R,
    int C, int P, int nz, long long plane, float sid, float dgamma,
    float row_h, float pitch, float beta_mid, float dbeta, float shift_lo,
    float shift_hi, void* stream) {
  if (!(dbeta > 0.0f) || pitch == 0.0f || !(shift_lo <= shift_hi))
    return (int)cudaErrorInvalidValue;
  return launch_motion<true>(qs, cos_b, sin_b, betas, src_z, cos_p, sin_p,
                             dx, dy, dz, X, Y, sel, zc, out, n_images, V, R,
                             C, P, nz, plane, sid, dgamma, row_h, pitch,
                             beta_mid, dbeta, shift_lo, shift_hi, stream);
}
