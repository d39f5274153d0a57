// The exact 3-D Siddon walk shared by K10 (siddon_trace_3d.cu), K18 and K19
// (siddon_project_3d.cu): the ray set-up of dexct_tpu/ops/conebeam.py:
// trace_paths_3d (axis_setup / cell_and_crossing; project_volume_3d's are
// the same operations) in float32, operation by operation, without fused
// multiply-adds (the _rn intrinsics), and one traversal step: |d| <= 1e-12
// axes with the +-1e30 bounds, the entry nudge eps = 1e-6 (dx + dy + dz),
// the index clamps, the tie rule (x, then y, then z) and t_next clamped into
// [t, t_out].  walk_step takes that step on a 64-bit cell index (K19's
// table builds); K10 and K18 take it as step32, the same operations on a
// 32-bit cell offset with the axis chosen by selects, and walk32_run loops
// it over a ray.  So every kernel walks a ray through the same cells with
// the same segment lengths: K18 on a volume of per-label values equals
// K10's paths times those values, and K19 scatters exactly the segments
// K18 gathers.

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
// segment of the fixed-trip walk is 0) and at most n_steps times.  K19's
// table builds walk with it.
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

// K10's and K18's walk in 32 bits over one of two layouts of the volume.
// A lane's cell is the sum of three signed offsets, one an axis (index x
// stride), and a step moves one of them by its stride, clamped into the
// axis's range: walk_step's float operations, tie rule and clamps, with the
// address in 32-bit integers (the volume holds fewer than 2^31 cells) and
// the three-way choice as selects.
struct Walk32 {
  float t, t_out, tnx, tny, tnz, dtx, dty, dtz;
  int ox, oy, oz, stx, sty, stz, capx, capy, capz;
};

// The walk w over the layout whose x and y strides are sx_stride and
// sy_stride (1 and nx as it is, [nz, ny, nx]; ny and 1 swapped, [nz, nx,
// ny]).
__device__ __forceinline__ Walk32 walk32(const Walk& w, const Grid& g,
                                         int sx_stride, int sy_stride) {
  const int sz_stride = g.nx * g.ny;
  Walk32 v;
  v.t = w.t, v.t_out = w.t_out;
  v.tnx = w.tnx, v.tny = w.tny, v.tnz = w.tnz;
  v.dtx = w.dtx, v.dty = w.dty, v.dtz = w.dtz;
  v.ox = w.ix * sx_stride, v.oy = w.iy * sy_stride, v.oz = w.iz * sz_stride;
  v.stx = w.sx * sx_stride, v.sty = w.sy * sy_stride;
  v.stz = w.sz * sz_stride;
  v.capx = (g.nx - 1) * sx_stride, v.capy = (g.ny - 1) * sy_stride;
  v.capz = (g.nz - 1) * sz_stride;
  return v;
}

// one instruction on sm_90 (VIADDMNMX.RELU)
__device__ __forceinline__ int clamp_step(int o, int step, int cap) {
  return max(min(o + step, cap), 0);
}

// One step: visit(seg, offset) with the segment inside the current cell
// and that cell's offset, then the walk advances.  fminf is exact, so
// min(tnx, min(tny, tnz)) is walk_step's min(min(tnx, tny), tnz) up to the
// sign of a zero, which changes no sum.  kMax: t_next = max(that, t), as
// walk_step takes it; once no crossing lies behind t none ever does again
// (a step moves t to the least crossing and that crossing forward), and the
// max is t_next itself.
template <bool kMax, class Visit>
__device__ __forceinline__ void step32(Walk32& w, Visit& visit) {
  const float m_yz = fminf(w.tny, w.tnz);
  const float m = fminf(fminf(w.tnx, m_yz), w.t_out);
  const float t_next = kMax ? fmaxf(m, w.t) : m;
  visit(__fsub_rn(t_next, w.t), w.ox + w.oy + w.oz);
  const bool tx = w.tnx <= m_yz;
  const bool ty = !tx && w.tny <= w.tnz;
  const bool tz = !tx && !ty;
  w.ox = tx ? clamp_step(w.ox, w.stx, w.capx) : w.ox;
  w.oy = ty ? clamp_step(w.oy, w.sty, w.capy) : w.oy;
  w.oz = tz ? clamp_step(w.oz, w.stz, w.capz) : w.oz;
  w.tnx = tx ? __fadd_rn(w.tnx, w.dtx) : w.tnx;
  w.tny = ty ? __fadd_rn(w.tny, w.dty) : w.tny;
  w.tnz = tz ? __fadd_rn(w.tnz, w.dtz) : w.tnz;
  w.t = t_next;
}

// steps between tests of the exit: past t_out a step visits seg = +0,
// which leaves every sum as it is (K18: 16 against 4 and 8, 0.456 against
// 0.481 and 0.464 ms at the cone protocol, H100, 700 W)
constexpr int kExitEvery = 16;

// A ray's whole walk: at most n_steps steps, each step32's; the max with t
// while a crossing lies behind t (the first steps), then the exit tested
// once every kExit steps, then the remaining steps one at a time.
template <int kExit, class Visit>
__device__ __forceinline__ void walk32_run(Walk32& w, int n_steps,
                                           Visit& visit) {
  int k = 0;
  for (; k < n_steps && w.t < w.t_out &&
         fminf(fminf(w.tnx, w.tny), w.tnz) < w.t; ++k)
    step32<true>(w, visit);
  for (; k + kExit <= n_steps && w.t < w.t_out; k += kExit) {
#pragma unroll
    for (int u = 0; u < kExit; ++u) step32<false>(w, visit);
  }
  for (; k < n_steps && w.t < w.t_out; ++k) step32<false>(w, visit);
}

// Whether the ray from (px, py) along (ux, uy) enters the grid through an
// x plane: it reaches the x range last (a tie votes x).  A warp's 32
// neighbouring channels enter through one face and, step for step, lie
// spread along it, so the kernels read the layout whose fast axis runs
// along that face, by a vote of the warp's rays.
__device__ __forceinline__ bool enters_by_x(const Grid& g, float px,
                                            float py, float ux, float uy) {
  return axis_setup(px, ux, g.x0, g.x1).tmin >=
         axis_setup(py, uy, g.y0, g.y1).tmin;
}

// x and y of each slice swapped through 32 x 32 tiles in shared memory:
// vol [nz, ny, nx] -> out [nz, nx, ny] (K18's float volume, K10's uint8
// labels).  Bound by bytes.
constexpr int kSwapTile = 32;

template <class T>
__global__ void swap_xy_kernel(const T* __restrict__ vol, T* __restrict__ out,
                               int nx, int ny, int nz) {
  __shared__ T tile[kSwapTile][kSwapTile + 1];
  const int x0 = blockIdx.x * kSwapTile, y0 = blockIdx.y * kSwapTile;
  for (int z = blockIdx.z; z < nz; z += gridDim.z) {
    const T* s = vol + (long long)z * nx * ny;
    T* d = out + (long long)z * nx * ny;
    for (int j = threadIdx.y; j < kSwapTile; j += blockDim.y) {
      const int x = x0 + threadIdx.x, y = y0 + j;
      if (x < nx && y < ny) tile[j][threadIdx.x] = s[y * nx + x];
    }
    __syncthreads();
    for (int j = threadIdx.y; j < kSwapTile; j += blockDim.y) {
      const int y = y0 + threadIdx.x, x = x0 + j;
      if (x < nx && y < ny) d[x * ny + y] = tile[threadIdx.x][j];
    }
    __syncthreads();
  }
}

template <class T>
inline cudaError_t launch_swap_xy(const T* vol, T* out, int nx, int ny,
                                  int nz, cudaStream_t stream) {
  if ((long long)nx * ny * nz <= 0) return cudaGetLastError();
  const dim3 grid((nx + kSwapTile - 1) / kSwapTile,
                  (ny + kSwapTile - 1) / kSwapTile, nz < 65535 ? nz : 65535);
  swap_xy_kernel<T><<<grid, dim3(kSwapTile, 8), 0, stream>>>(vol, out, nx,
                                                             ny, nz);
  return cudaGetLastError();
}

}  // namespace dexct_walk3d
