// The exact 2-D Siddon walk shared by K1 (siddon_trace.cu) and K17
// (siddon_trace_stack.cu): the ray setup of dexct_tpu/ops/siddon.py:
// _ray_setup in float32, operation by operation, without fused
// multiply-adds (the _rn intrinsics), and one traversal step.  Both kernels
// walk a ray through the same cells with the same segment lengths, so a
// slice of K17 equals K1 on that slice bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dexct_walk {

constexpr float kBig = 1e30f;

struct AxisSetup {
  bool ok;
  float safe_d, tmin, tmax;
};

__device__ __forceinline__ AxisSetup axis_setup(float p, float d, float g0,
                                                float g1) {
  AxisSetup s;
  s.ok = fabsf(d) > 1e-12f;
  s.safe_d = s.ok ? d : 1.0f;
  const float t_lo = __fdiv_rn(__fsub_rn(g0, p), s.safe_d);
  const float t_hi = __fdiv_rn(__fsub_rn(g1, p), s.safe_d);
  const bool inside = (p >= g0) && (p <= g1);
  s.tmin = s.ok ? fminf(t_lo, t_hi) : (inside ? -kBig : kBig);
  s.tmax = s.ok ? fmaxf(t_lo, t_hi) : (inside ? kBig : -kBig);
  return s;
}

__device__ __forceinline__ int entry_index(float p, float d, float t_in,
                                           float eps, float g0, float cell,
                                           int n) {
  const float e = __fadd_rn(p, __fmul_rn(__fadd_rn(t_in, eps), d));
  float f = floorf(__fdiv_rn(__fsub_rn(e, g0), cell));
  f = fminf(fmaxf(f, 0.0f), (float)(n - 1));
  return (int)f;
}

// DDA state of one ray: the current parameter t, the exit t_out, the cell
// (ix, iy), the next plane crossings and their increments, the steps.
struct Walk {
  float t, t_out, tnx, tny, dtx, dty;
  int ix, iy, sx, sy;
};

__device__ __forceinline__ Walk walk_init(float px, float py, float ux,
                                          float uy, int nx, int ny, float x0,
                                          float y0, float x1, float y1,
                                          float dx, float dy, float eps) {
  Walk w;
  const AxisSetup ax = axis_setup(px, ux, x0, x1);
  const AxisSetup ay = axis_setup(py, uy, y0, y1);
  w.t = fmaxf(fmaxf(ax.tmin, ay.tmin), 0.0f);
  w.t_out = fminf(ax.tmax, ay.tmax);
  if (!(w.t < w.t_out)) w.t_out = w.t;  // miss: zero-length traversal

  w.ix = entry_index(px, ux, w.t, eps, x0, dx, nx);
  w.iy = entry_index(py, uy, w.t, eps, y0, dy, ny);

  // next plane crossings and per-step increments
  w.tnx = kBig, w.dtx = kBig, w.tny = kBig, w.dty = kBig;
  w.sx = 0, w.sy = 0;
  if (ax.ok) {
    const float plane =
        __fadd_rn(x0, __fmul_rn((float)(w.ix + (ux > 0.0f)), dx));
    w.tnx = __fdiv_rn(__fsub_rn(plane, px), ax.safe_d);
    w.dtx = __fdiv_rn(dx, fabsf(ax.safe_d));
    w.sx = ux > 0.0f ? 1 : -1;
  }
  if (ay.ok) {
    const float plane =
        __fadd_rn(y0, __fmul_rn((float)(w.iy + (uy > 0.0f)), dy));
    w.tny = __fdiv_rn(__fsub_rn(plane, py), ay.safe_d);
    w.dty = __fdiv_rn(dy, fabsf(ay.safe_d));
    w.sy = uy > 0.0f ? 1 : -1;
  }
  return w;
}

// The end of the current segment, clamped into [t, t_out].
__device__ __forceinline__ float walk_next(const Walk& w) {
  return fmaxf(fminf(fminf(w.tnx, w.tny), w.t_out), w.t);
}

// Cross the nearer plane (ties go to x) and move t to ``t_next``.
__device__ __forceinline__ void walk_advance(Walk& w, float t_next, int nx,
                                             int ny) {
  if (w.tnx <= w.tny) {
    w.ix = min(max(w.ix + w.sx, 0), nx - 1);
    w.tnx = __fadd_rn(w.tnx, w.dtx);
  } else {
    w.iy = min(max(w.iy + w.sy, 0), ny - 1);
    w.tny = __fadd_rn(w.tny, w.dty);
  }
  w.t = t_next;
}

}  // namespace dexct_walk
