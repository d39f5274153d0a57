// The exact 3-D Siddon walk shared by K10 (siddon_trace_3d.cu), K18 and K19
// (siddon_project_3d.cu): the ray set-up of dexct_tpu/ops/conebeam.py:
// trace_paths_3d (axis_setup / cell_and_crossing; project_volume_3d's are
// the same operations) in float32, operation by operation, without fused
// multiply-adds (the _rn intrinsics), and one traversal step: |d| <= 1e-12
// axes with the +-1e30 bounds, the entry nudge eps = 1e-6 (dx + dy + dz),
// the index clamps, the tie rule (x, then y, then z) and t_next clamped into
// [t, t_out].  The kernels walk a ray through the same cells with the same
// segment lengths (K18 repeats walk_step's operations with 32-bit cell
// offsets, siddon_project_3d.cu: step32), so K18 on a volume of per-label
// values equals K10's paths times those values, and K19 scatters exactly
// the segments K18 gathers.

#pragma once

#include <cuda_runtime.h>

namespace dexct_walk3d {

constexpr float kBig = 1e30f;

// The voxel grid, centred on the origin: dims, near and far edges, cells,
// entry nudge.
struct Grid {
  int nx, ny, nz;
  float x0, y0, z0, x1, y1, z1, dx, dy, dz, eps;
};

struct Axis {
  bool ok;
  float safe_d, tmin, tmax;
};

__device__ __forceinline__ Axis axis_setup(float p, float d, float g0,
                                           float g1) {
  Axis s;
  s.ok = fabsf(d) > 1e-12f;
  s.safe_d = s.ok ? d : 1.0f;
  const float t_lo = __fdiv_rn(__fsub_rn(g0, p), s.safe_d);
  const float t_hi = __fdiv_rn(__fsub_rn(g1, p), s.safe_d);
  const bool inside = (p >= g0) && (p <= g1);
  s.tmin = s.ok ? fminf(t_lo, t_hi) : (inside ? -kBig : kBig);
  s.tmax = s.ok ? fmaxf(t_lo, t_hi) : (inside ? kBig : -kBig);
  return s;
}

struct AxisWalk {
  int idx, step;
  float t_next, dt;
};

__device__ __forceinline__ AxisWalk cell_and_crossing(const Axis& ax, float p,
                                                      float d, float t_in,
                                                      float eps, float g0,
                                                      float cell, int n) {
  AxisWalk w;
  const float e = __fadd_rn(p, __fmul_rn(__fadd_rn(t_in, eps), d));
  float f = floorf(__fdiv_rn(__fsub_rn(e, g0), cell));
  f = fminf(fmaxf(f, 0.0f), (float)(n - 1));
  w.idx = (int)f;
  w.t_next = kBig;
  w.dt = kBig;
  w.step = 0;
  if (ax.ok) {
    const float plane =
        __fadd_rn(g0, __fmul_rn((float)(w.idx + (d > 0.0f)), cell));
    w.t_next = __fdiv_rn(__fsub_rn(plane, p), ax.safe_d);
    w.dt = __fdiv_rn(cell, fabsf(ax.safe_d));
    w.step = d > 0.0f ? 1 : (d < 0.0f ? -1 : 0);
  }
  return w;
}

// One ray's walk state: the current parameter t, the exit t_out, the cell
// and each axis's next crossing, crossing spacing and index step.
struct Walk {
  float t, t_out, tnx, tny, tnz, dtx, dty, dtz;
  int ix, iy, iz, sx, sy, sz;
};

// The walk of the ray from (px, py, pz) along the unit (ux, uy, uz); a ray
// that misses the grid gets t_out = t (no segment).
__device__ __forceinline__ Walk walk_start(const Grid& g, float px, float py,
                                           float pz, float ux, float uy,
                                           float uz) {
  const Axis ax = axis_setup(px, ux, g.x0, g.x1);
  const Axis ay = axis_setup(py, uy, g.y0, g.y1);
  const Axis az = axis_setup(pz, uz, g.z0, g.z1);
  Walk w;
  w.t = fmaxf(fmaxf(ax.tmin, fmaxf(ay.tmin, az.tmin)), 0.0f);
  w.t_out = fminf(ax.tmax, fminf(ay.tmax, az.tmax));
  if (!(w.t < w.t_out)) w.t_out = w.t;  // miss: zero-length traversal
  const AxisWalk wx = cell_and_crossing(ax, px, ux, w.t, g.eps, g.x0, g.dx,
                                        g.nx);
  const AxisWalk wy = cell_and_crossing(ay, py, uy, w.t, g.eps, g.y0, g.dy,
                                        g.ny);
  const AxisWalk wz = cell_and_crossing(az, pz, uz, w.t, g.eps, g.z0, g.dz,
                                        g.nz);
  w.ix = wx.idx, w.iy = wy.idx, w.iz = wz.idx;
  w.sx = wx.step, w.sy = wy.step, w.sz = wz.step;
  w.tnx = wx.t_next, w.tny = wy.t_next, w.tnz = wz.t_next;
  w.dtx = wx.dt, w.dty = wy.dt, w.dtz = wz.dt;
  return w;
}

// One traversal step: sets ``cell`` to the flat [z, y, x] index of the
// current voxel, returns the segment length inside it and advances the walk
// to the next voxel.  Callers loop while w.t < w.t_out (from there on every
// segment of the fixed-trip walk is 0) and at most n_steps times.
__device__ __forceinline__ float walk_step(Walk& w, const Grid& g,
                                           long long& cell) {
  const float t_next =
      fmaxf(fminf(fminf(fminf(w.tnx, w.tny), w.tnz), w.t_out), w.t);
  const float seg = __fsub_rn(t_next, w.t);
  cell = ((long long)w.iz * g.ny + w.iy) * g.nx + w.ix;
  if (w.tnx <= fminf(w.tny, w.tnz)) {
    w.ix = min(max(w.ix + w.sx, 0), g.nx - 1);
    w.tnx = __fadd_rn(w.tnx, w.dtx);
  } else if (w.tny <= w.tnz) {
    w.iy = min(max(w.iy + w.sy, 0), g.ny - 1);
    w.tny = __fadd_rn(w.tny, w.dty);
  } else {
    w.iz = min(max(w.iz + w.sz, 0), g.nz - 1);
    w.tnz = __fadd_rn(w.tnz, w.dtz);
  }
  w.t = t_next;
  return seg;
}

}  // namespace dexct_walk3d
