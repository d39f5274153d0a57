// K10 siddon_trace_3d: exact per-material Siddon path lengths of 3-D rays.
//
// Replaces the TPU programs of dexct_tpu/ops/conebeam.py that the fused cone
// pipeline traces with: _trace_cone_dominant (a dominant-axis walk over
// 3-bit packed per-z-layer label windows in ray-plan order) and its bundled
// form (one shared-window gather for 8 adjacent channels), and the plain
// fixed-trip trace_paths_3d (an Nx+Ny+Nz+2-step lax.scan).  They compute
// the same numbers; the packed forms exist because a TPU pays per gather.
//
// What bounds it on the card: one dependent label load per traversal step
// (latency: the uint8 volume, 3 MB for 256 x 256 x 48, stays in L2) plus
// ~20 float ops; the total work is the number of voxels the rays cross.
// Design: one thread per ray walks only its own steps (the loop ends at
// t_out instead of running the fixed trip), labels are uint8 read through
// the read-only cache, the M per-material sums live in registers (M is a
// template parameter, a label adds its segment through an unrolled select),
// and the output is written in natural [V, R, C, M] order, so the TPU
// path's inverse ray-plan permute is gone.  Neighbouring threads are
// neighbouring channels of one detector row, whose walks are alike.
//
// The ray set-up reproduces trace_paths_3d's axis_setup / cell_and_crossing
// in float32 operation by operation (no fused multiply-add, via the _rn
// intrinsics): |d| <= 1e-12 axes with the +-1e30 bounds, the entry nudge
// eps = 1e-6 (dx + dy + dz), the index clamps, the tie rule (x, then y,
// then z) and t_next clamped into [t, t_out].  Stopping at t_out is exact:
// from there on every segment of the fixed-trip walk is 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;

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

struct Walk {
  int idx, step;
  float t_next, dt;
};

__device__ __forceinline__ Walk cell_and_crossing(const Axis& ax, float p,
                                                  float d, float t_in,
                                                  float eps, float g0,
                                                  float cell, int n) {
  Walk w;
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

template <int M>
__global__ void siddon_trace_3d_kernel(
    const uint8_t* __restrict__ labels, const float* __restrict__ src,
    const float* __restrict__ dirs, float* __restrict__ out, long long n_rays,
    int nx, int ny, int nz, int n_out, float x0, float y0, float z0,
    float x1, float y1, float z1, float dx, float dy, float dz, float eps,
    int n_steps) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float px = src[3 * r], py = src[3 * r + 1], pz = src[3 * r + 2];
  const float ux = dirs[3 * r], uy = dirs[3 * r + 1], uz = dirs[3 * r + 2];

  const Axis ax = axis_setup(px, ux, x0, x1);
  const Axis ay = axis_setup(py, uy, y0, y1);
  const Axis az = axis_setup(pz, uz, z0, z1);
  float t = fmaxf(fmaxf(ax.tmin, fmaxf(ay.tmin, az.tmin)), 0.0f);
  float t_out = fminf(ax.tmax, fminf(ay.tmax, az.tmax));
  if (!(t < t_out)) t_out = t;  // miss: zero-length traversal

  Walk wx = cell_and_crossing(ax, px, ux, t, eps, x0, dx, nx);
  Walk wy = cell_and_crossing(ay, py, uy, t, eps, y0, dy, ny);
  Walk wz = cell_and_crossing(az, pz, uz, t, eps, z0, dz, nz);
  int ix = wx.idx, iy = wy.idx, iz = wz.idx;
  float tnx = wx.t_next, tny = wy.t_next, tnz = wz.t_next;

  float acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.0f;

  for (int k = 0; k < n_steps && t < t_out; ++k) {
    const float t_next = fmaxf(fminf(fminf(fminf(tnx, tny), tnz), t_out), t);
    const float seg = __fsub_rn(t_next, t);
    const int lab =
        __ldg(labels + (((long long)iz * ny + iy) * nx + ix));
#pragma unroll
    for (int m = 0; m < M; ++m) acc[m] += (lab == m) ? seg : 0.0f;
    if (tnx <= fminf(tny, tnz)) {
      ix = min(max(ix + wx.step, 0), nx - 1);
      tnx = __fadd_rn(tnx, wx.dt);
    } else if (tny <= tnz) {
      iy = min(max(iy + wy.step, 0), ny - 1);
      tny = __fadd_rn(tny, wy.dt);
    } else {
      iz = min(max(iz + wz.step, 0), nz - 1);
      tnz = __fadd_rn(tnz, wz.dt);
    }
    t = t_next;
  }
  float* o = out + r * n_out;
#pragma unroll
  for (int m = 0; m < M; ++m)  // unrolled: acc[] never leaves registers
    if (m < n_out) o[m] = acc[m];
}

template <int M>
void launch(const uint8_t* labels, const float* src, const float* dirs,
            float* out, long long n_rays, int nx, int ny, int nz, int n_out,
            float x0, float y0, float z0, float x1, float y1, float z1,
            float dx, float dy, float dz, float eps, int n_steps,
            cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (n_rays + threads - 1) / threads;
  siddon_trace_3d_kernel<M><<<(unsigned)blocks, threads, 0, stream>>>(
      labels, src, dirs, out, n_rays, nx, ny, nz, n_out, x0, y0, z0, x1, y1,
      z1, dx, dy, dz, eps, n_steps);
}

}  // namespace

extern "C" int dexct_siddon_trace_3d(
    const void* labels, const void* src, const void* dirs, void* out,
    long long n_rays, int nx, int ny, int nz, int n_materials, float x0,
    float y0, float z0, float x1, float y1, float z1, float dx, float dy,
    float dz, float eps, int n_steps, void* stream) {
  const uint8_t* l = static_cast<const uint8_t*>(labels);
  const float* s = static_cast<const float*>(src);
  const float* d = static_cast<const float*>(dirs);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_rays <= 0) return (int)cudaGetLastError();
#define DEXCT_CASE(MM)                                                     \
  launch<MM>(l, s, d, o, n_rays, nx, ny, nz, n_materials, x0, y0, z0, x1, \
             y1, z1, dx, dy, dz, eps, n_steps, st)
  switch (n_materials) {
    case 1: DEXCT_CASE(1); break;
    case 2: DEXCT_CASE(2); break;
    case 3: DEXCT_CASE(3); break;
    case 4: DEXCT_CASE(4); break;
    case 5: DEXCT_CASE(5); break;
    case 6: DEXCT_CASE(6); break;
    case 7: DEXCT_CASE(7); break;
    case 8: DEXCT_CASE(8); break;
    default:
      if (n_materials <= 16) {
        DEXCT_CASE(16);
      } else if (n_materials <= 32) {
        DEXCT_CASE(32);
      } else {
        return (int)cudaErrorInvalidValue;
      }
  }
#undef DEXCT_CASE
  return (int)cudaGetLastError();
}
