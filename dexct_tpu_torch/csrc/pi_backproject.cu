// K20 pi_backproject: the Tam-Danielsson-window backprojection of the
// cone-parallel PI method, with a partition of unity over the helix copies
// of each line.
//
// Replaces dexct_tpu/ops/helical_pi.py:_pi_backproject, the TPU program
// that scans blocks of theta lines, packs each line's (t, t + 1) taps of all
// R rows into one row-2R gather (a t-pair-packed table) and selects the two
// detector rows with one-hot contractions over R, for every slice at once
// (lax.map).  The packed table and the one-hot selects are gather-count
// layouts of four taps.
//
// What bounds it on the card: arithmetic.  Per (disc pixel, slice, line) an
// arcsine, a square root and a few divisions place the voxel on the line;
// where the voxel lies on the detector and in its own copy's tapered TD
// window, the eight other helix copies (theta + m pi, 0 < |m| <= 4) add
// their windows to the partition's sum (~15 operations and two divisions
// each).  The filtered data (nT x nt x R floats, 23.6 MB at 720 x 512 x 16)
// stay in the 50 MB L2.  Design: one thread per (disc pixel, output slice)
// loops over the lines and keeps its sum in a register, so the output is
// written once with no atomics; neighbouring threads are neighbouring disc
// pixels of one slice, whose taps sit on neighbouring t of the same lines.
// A line that misses the t grid, the detector rows or its own window adds
// an exact zero in the reference (its weight is 0) and is skipped before
// the copies are summed.  The reference's den sum is never used and is not
// formed.
//
// Per line, in float32 without fused multiply-adds, as the reference: t =
// x cos + y sin, s = -x sin + y cos, sg = clamp(t / sid, -0.999, 0.999),
// gam = asin(sg), cg = sqrt(1 - sg^2), L = max(sid cg - s, 1e-3), beta =
// theta + pi/2 - gam, z_s = z0 + pitch beta / 2 pi, h = (z - z_s) sid / L;
// K(h, g) = clamp((h - bot) / taper + 0.5, 0, 1) clamp((top - h) / taper +
// 0.5, 0, 1) [|h| <= hdet] with top = qp (pi - 2 g), bot = -qp (pi + 2 g);
// copy m (odd m: gamma -> -gamma and L -> max(sid cg + s, 1e-3)) sits at
// beta + m pi (+ 2 gam for odd m) and counts when theta + m pi lies within
// the scanned lines; the weight is K_0 / max(sum_m K_m, 1e-6); the tap is
// bilinear in (t, row) with rows r0 and min(r0 + 1, R - 1).  The sum is
// multiplied by dtheta.

#include <cuda_runtime.h>
#include <math.h>

#include "td_window.cuh"

namespace {

using dexct_td::clampf;
using dexct_td::kHalfPi;
using dexct_td::kPiD;
using dexct_td::kTwoPi;

struct TdWindow {
  float qp, nqp, taper, hdet;
};

// The tapered TD window (td_window.cuh, centred tapers) of row height h at
// fan angle g, zero beyond the detector's half-height hdet.
__device__ __forceinline__ float kfun(const TdWindow& k, float h, float g) {
  return __fmul_rn(
      dexct_td::weight<true>(h, dexct_td::bounds(k.qp, k.nqp, g), k.taper),
      fabsf(h) <= k.hdet ? 1.0f : 0.0f);
}

__device__ __forceinline__ float source_z(float z0_src, float pitch,
                                          float beta) {
  return __fadd_rn(z0_src, __fdiv_rn(__fmul_rn(pitch, beta), kTwoPi));
}

__global__ void pi_backproject_kernel(
    const float* __restrict__ par, const float* __restrict__ thetas,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    const float* __restrict__ X, const float* __restrict__ Y,
    const long long* __restrict__ sel, const float* __restrict__ zc,
    float* __restrict__ out, int nT, int nt, int R, int P, long long plane,
    float sid, float row_h, float pitch, float z0_src, float t0, float dt,
    float dtheta, TdWindow k, float th_lo, float th_hi) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int iz = blockIdx.y;
  if (p >= P) return;
  const float x = X[p], y = Y[p];
  const float z = zc[iz];
  const float c_max = (float)(nt - 1);
  const float c0_max = (float)(nt - 2);
  const float r_shift = 0.5f * (float)R;
  const float r_hi = (float)R - 0.5f;
  const float r0_max = (float)(R >= 2 ? R - 2 : 0);

  float acc = 0.0f;
  for (int j = 0; j < nT; ++j) {
    const float ct = __ldg(cos_t + j), st = __ldg(sin_t + j);
    const float t = __fadd_rn(__fmul_rn(x, ct), __fmul_rn(y, st));
    const float cidx = __fdiv_rn(__fsub_rn(t, t0), dt);
    if (!(cidx >= 0.0f && cidx <= c_max)) continue;
    const float s = __fadd_rn(__fmul_rn(-x, st), __fmul_rn(y, ct));
    const float sg = clampf(__fdiv_rn(t, sid), -0.999f, 0.999f);
    const float gam = asinf(sg);
    const float cg = __fsqrt_rn(__fsub_rn(1.0f, __fmul_rn(sg, sg)));
    const float scg = __fmul_rn(sid, cg);
    const float L = fmaxf(__fsub_rn(scg, s), 1e-3f);
    const float th = __ldg(thetas + j);
    const float beta = __fsub_rn(__fadd_rn(th, kHalfPi), gam);
    const float h = __fdiv_rn(
        __fmul_rn(__fsub_rn(z, source_z(z0_src, pitch, beta)), sid), L);
    const float ridx =
        __fadd_rn(__fsub_rn(__fdiv_rn(h, row_h), 0.5f), r_shift);
    if (!(ridx >= -0.5f && ridx <= r_hi)) continue;
    const float k0 = kfun(k, h, gam);
    if (k0 == 0.0f) continue;
    const float L_odd = fmaxf(__fadd_rn(scg, s), 1e-3f);
    const float two_g = __fmul_rn(2.0f, gam);
    float ksum = k0;
#pragma unroll
    for (int m = -4; m <= 4; ++m) {
      if (m == 0) continue;
      const bool odd = (m & 1) != 0;
      const float m_pi = (float)(m * kPiD);
      const float beta_m =
          __fadd_rn(__fadd_rn(beta, m_pi), odd ? two_g : 0.0f);
      const float hm = __fdiv_rn(
          __fmul_rn(__fsub_rn(z, source_z(z0_src, pitch, beta_m)), sid),
          odd ? L_odd : L);
      const float th_m = __fadd_rn(th, m_pi);
      if (th_m >= th_lo && th_m <= th_hi)
        ksum = __fadd_rn(ksum, kfun(k, hm, odd ? -gam : gam));
    }
    const float w_td = __fdiv_rn(k0, fmaxf(ksum, 1e-6f));

    const float c0 = fminf(fmaxf(floorf(cidx), 0.0f), c0_max);
    const float fc = clampf(__fsub_rn(cidx, c0), 0.0f, 1.0f);
    const float r0 = fminf(fmaxf(floorf(ridx), 0.0f), r0_max);
    const float fr = clampf(__fsub_rn(ridx, r0), 0.0f, 1.0f);
    const int ir0 = (int)r0;
    const int ir1 = min(ir0 + 1, R - 1);
    const long long base = ((long long)j * nt + (int)c0) * R;
    const float v00 = __ldg(par + base + ir0);
    const float v01 = __ldg(par + base + ir1);
    const float v10 = __ldg(par + base + R + ir0);
    const float v11 = __ldg(par + base + R + ir1);
    const float gc = __fsub_rn(1.0f, fc);
    const float val = __fadd_rn(
        __fmul_rn(__fadd_rn(__fmul_rn(v00, gc), __fmul_rn(v10, fc)),
                  __fsub_rn(1.0f, fr)),
        __fmul_rn(__fadd_rn(__fmul_rn(v01, gc), __fmul_rn(v11, fc)), fr));
    acc += val * w_td;
  }
  out[(long long)iz * plane + sel[p]] = __fmul_rn(acc, dtheta);
}

constexpr int kThreads = 128;

}  // namespace

// par [nT, nt, R] -> out [nz, N*N] (the caller zeroes out; disc pixels
// only)
extern "C" int dexct_pi_backproject(
    const void* par, const void* thetas, const void* cos_t, const void* sin_t,
    const void* X, const void* Y, const void* sel, const void* zc, void* out,
    int nT, int nt, int R, int P, int nz, long long plane, float sid,
    float row_h, float pitch, float z0_src, float t0, float dt, float dtheta,
    float qp, float nqp, float taper, float hdet, float th_lo, float th_hi,
    void* stream) {
  if (P <= 0 || nz <= 0 || nT <= 0) return (int)cudaGetLastError();
  if (nt < 2 || R < 1 || nz > 65535) return (int)cudaErrorInvalidValue;
  const TdWindow k{qp, nqp, taper, hdet};
  const dim3 blocks((P + kThreads - 1) / kThreads, nz);
  pi_backproject_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(par), static_cast<const float*>(thetas),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<const float*>(X), static_cast<const float*>(Y),
      static_cast<const long long*>(sel), static_cast<const float*>(zc),
      static_cast<float*>(out), nT, nt, R, P, plane, sid, row_h, pitch,
      z0_src, t0, dt, dtheta, k, th_lo, th_hi);
  return (int)cudaGetLastError();
}
