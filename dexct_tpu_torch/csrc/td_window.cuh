// The tapered Tam-Danielsson (TD) window shared by K12's `td` weighting and
// K15 (cone_backproject.cu) and by K20 (pi_backproject.cu), with the float32
// constants and the clamp they use.  A voxel seen at fan angle g lies inside
// the window when its row height h lies between bot = -qp (pi + 2 g) and top
// = qp (pi - 2 g) (qp = pitch / 4 pi; on the cylindrical detector K12 and
// K15 divide both by cos g), with a linear taper of width `taper` at each
// edge: clamp((h - bot) / taper [+ 0.5], 0, 1) clamp((top - h) / taper
// [+ 0.5], 0, 1), the 0.5 where the reference centres the taper on the edge
// (K15, K20).  Operation by operation as the reference, in float32 without
// fused multiply-adds (the _rn intrinsics).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace dexct_td {

constexpr double kPiD = 3.14159265358979323846;
constexpr float kPi = (float)kPiD;                // float32(pi)
constexpr float kHalfPi = (float)(0.5 * kPiD);    // float32(pi / 2)
constexpr float kTwoPi = (float)(2.0 * kPiD);     // float32(2 pi)

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// The window's edges at fan angle g: top = qp (pi - 2 g), bot = nqp (pi +
// 2 g) with nqp = -qp.
struct Bounds {
  float top, bot;
};

__device__ __forceinline__ Bounds bounds(float qp, float nqp, float g) {
  const float two_g = __fmul_rn(2.0f, g);
  return {__fmul_rn(qp, __fsub_rn(kPi, two_g)),
          __fmul_rn(nqp, __fadd_rn(kPi, two_g))};
}

// Both edges divided by cos g (the cylindrical detector's row heights).
__device__ __forceinline__ Bounds over_cos(Bounds b, float cg) {
  return {__fdiv_rn(b.top, cg), __fdiv_rn(b.bot, cg)};
}

// One edge's taper at x = (distance inside the edge) / taper.
template <bool kCentred>
__device__ __forceinline__ float ramp(float x) {
  return clampf(kCentred ? __fadd_rn(x, 0.5f) : x, 0.0f, 1.0f);
}

// The window's weight at row height h.
template <bool kCentred>
__device__ __forceinline__ float weight(float h, Bounds b, float taper) {
  return __fmul_rn(ramp<kCentred>(__fdiv_rn(__fsub_rn(h, b.bot), taper)),
                   ramp<kCentred>(__fdiv_rn(__fsub_rn(b.top, h), taper)));
}

}  // namespace dexct_td
