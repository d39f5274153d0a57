// The shared body of the single-scatter kernels K26 (fan beam) and K27
// (cone beam): the slab-clipped fixed-step label march, the incident
// fluence of a vertex and the Compton + Rayleigh terms of one (vertex,
// element) pair.  Both kernels instantiate these templates, the fan with
// THREE_D = false (bilinear in the z = 0 plane), the cone with true
// (trilinear), so an N_rows = 1 cone runs the fan's arithmetic.
//
// The operation order follows dexct_tpu/ops/scatter_physics.py's march
// (:185), incident stage (:233-261) and per-block body (:275-343), with
// one change of formulation: the scattering angle enters as
// one_m = 1 - cos(theta) = |u_in - u_out|^2 / 2.  The JAX program forms
// 1 - u_in . u_out, which near the forward direction keeps only the last
// bits of the dot product; at MeV energies the Rayleigh form factor
// F(q ~ E sqrt(one_m)) amplifies them to ~0.4 % of the sinogram (its
// float32 result against the same program run in float64), where this
// form stays within 2e-5 of that float64 result.  The only hard gate, the fan test |g_v| <= g_half, is
// computed in the JAX program's order with no fused multiply-add;
// everything else is continuous in position and energy.

#pragma once

#include <cuda_runtime.h>

namespace dexct_scatter {

// the label grid and the march's constants (float32, computed on the host
// as the JAX program computes them)
struct Grid {
  const unsigned char* labels;  // [nz, ny, nx]
  int nx, ny, nz;
  float inv_dx, inv_dy, inv_dz;  // 1 / voxel size
  float hx, hy, hz;              // slab half extents (n/2 + 0.5) d
  float cx, cy, cz;              // n/2 - 0.5: the index of coordinate 0
};

// Segment p0 -> p1 against the box |p| <= h per axis: the JAX _slab_clip
// (:102), one axis at a time.
__device__ __forceinline__ void clip_axis(float pa, float sa, float h,
                                          float& lo, float& hi) {
  const float s = fabsf(sa) < 1e-20f ? 1e-20f : sa;
  const float inv = 1.0f / s;
  const float ta = (-h - pa) * inv;
  const float tb = (h - pa) * inv;
  lo = fmaxf(lo, fminf(ta, tb));
  hi = fminf(hi, fmaxf(ta, tb));
}

// Material path lengths [MAXK] along p0 -> p1 with n_steps midpoint
// samples of the bilinear (trilinear) label occupancy inside the slab
// clip; labels >= MAXK (and the host's zero-padded tables for K <= k <
// MAXK) contribute nothing.
template <int MAXK, bool THREE_D>
__device__ __forceinline__ void march(const Grid& g, float p0x, float p0y,
                                      float p0z, float p1x, float p1y,
                                      float p1z, int n_steps,
                                      float (&occ)[MAXK]) {
#pragma unroll
  for (int k = 0; k < MAXK; ++k) occ[k] = 0.0f;
  const float sx = p1x - p0x, sy = p1y - p0y;
  const float sz = THREE_D ? p1z - p0z : 0.0f;
  const float length = sqrtf(sx * sx + sy * sy + sz * sz);
  float lo = 0.0f, hi = 1.0f;
  clip_axis(p0x, sx, g.hx, lo, hi);
  clip_axis(p0y, sy, g.hy, lo, hi);
  if (THREE_D) clip_axis(p0z, sz, g.hz, lo, hi);
  const float t0 = fminf(fmaxf(lo, 0.0f), 1.0f);
  const float t1 = fmaxf(fminf(fmaxf(hi, 0.0f), 1.0f), t0);
  const float span = t1 - t0;
  const float inv_n = 1.0f / (float)n_steps;
  const size_t plane = (size_t)g.nx * g.ny;
  for (int s = 0; s < n_steps; ++s) {
    const float frac = t0 + span * (((float)s + 0.5f) * inv_n);
    const float fx = (p0x + sx * frac) * g.inv_dx + g.cx;
    const float fy = (p0y + sy * frac) * g.inv_dy + g.cy;
    const float ix0f = floorf(fx), iy0f = floorf(fy);
    const float wx = fx - ix0f, wy = fy - iy0f;
    const int ix0 = (int)ix0f, iy0 = (int)iy0f;
    int iz0 = 0;
    float wz = 0.0f;
    if (THREE_D) {
      const float fz = (p0z + sz * frac) * g.inv_dz + g.cz;
      const float iz0f = floorf(fz);
      wz = fz - iz0f;
      iz0 = (int)iz0f;
    }
#pragma unroll
    for (int tz = 0; tz < (THREE_D ? 2 : 1); ++tz) {
      const int iz = iz0 + tz;
      if (THREE_D && (iz < 0 || iz >= g.nz)) continue;
      const float w_z = THREE_D ? (tz ? wz : 1.0f - wz) : 1.0f;
      const unsigned char* layer = g.labels + (size_t)iz * plane;
#pragma unroll
      for (int ty = 0; ty < 2; ++ty) {
        const int iy = iy0 + ty;
        if (iy < 0 || iy >= g.ny) continue;
        const float w_y = w_z * (ty ? wy : 1.0f - wy);
#pragma unroll
        for (int tx = 0; tx < 2; ++tx) {
          const int ix = ix0 + tx;
          if (ix < 0 || ix >= g.nx) continue;
          const float w = w_y * (tx ? wx : 1.0f - wx);
          const int lab = __ldg(layer + (size_t)iy * g.nx + ix);
#pragma unroll
          for (int k = 0; k < MAXK; ++k) occ[k] += (lab == k) ? w : 0.0f;
        }
      }
    }
  }
  const float scale = length * span * inv_n;
#pragma unroll
  for (int k = 0; k < MAXK; ++k) occ[k] *= scale;
}

// The fan angle of a vertex seen from the source, in the JAX program's
// order without fused multiply-adds: the fan gate |g_v| <= g_half must
// flip where the plain program's does.
__device__ __forceinline__ float fan_angle(float relx, float rely, float d0x,
                                           float d0y) {
  const float num = __fsub_rn(__fmul_rn(d0x, rely), __fmul_rn(d0y, relx));
  const float den = __fadd_rn(__fmul_rn(relx, d0x), __fmul_rn(rely, d0y));
  return atan2f(num, den);
}

// the per-launch constants of the exit stage's energy terms
struct Terms {
  int G, F, Q, coherent;
  float ef0, inv_def, f_max, q_max;  // fine grid origin, 1 / step, F-1.001
  float a_det, c_r2, inv_hc, dq_inv; // element area, r_e^2 / 2, 1 / hc
};

// Compton (weighted by w_x) and Rayleigh (weighted by col) detected signal
// of one (vertex, element) pair, summed over the G incident bins.
// t_ex: the exit paths; one_m: 1 - cos(theta); phi: the vertex's fluence, stride phi_stride
// between bins; f2: the cell's coherent table [Q]; shared tables: mu [MAXK
// x F], resp [F], e_g, k_g = e_g / m_e c^2, resp_g, and the elastic
// exit's fine-grid bin fic0 and fraction wfc per bin.
template <int MAXK>
__device__ __forceinline__ float pair_terms(
    const Terms& t, const float (&t_ex)[MAXK], float one_m, float d_omega,
    float w_x, float col, const float* __restrict__ phi, size_t phi_stride,
    const float* __restrict__ f2, const float* s_mu, const float* s_resp,
    const float* s_eg, const float* s_kg, const float* s_respg,
    const int* s_fic0, const float* s_wfc) {
  const float cos_t = 1.0f - one_m;
  const float sin2 = one_m * (2.0f - one_m);
  float comp = 0.0f, coh = 0.0f;
  float q_half = 0.0f, ray0 = 0.0f;
  if (t.coherent) {
    q_half = sqrtf(fminf(fmaxf(one_m * 0.5f, 0.0f), 1.0f)) * t.inv_hc;
    ray0 = t.c_r2 * (1.0f + cos_t * cos_t);
  }
  for (int g = 0; g < t.G; ++g) {
    const float ph = __ldg(phi + g * phi_stride);
    const float e = s_eg[g];
    // Compton: KN at the shifted energy E', exit attenuation and
    // detector response interpolated on the fine grid at E'
    const float ratio = 1.0f / (1.0f + s_kg[g] * one_m);
    const float e_p = e * ratio;
    const float kn = t.c_r2 * ratio * ratio * (ratio + 1.0f / ratio - sin2);
    const float fi = fminf(fmaxf((e_p - t.ef0) * t.inv_def, 0.0f), t.f_max);
    const float fi0f = floorf(fi);
    const float wf = fi - fi0f;
    const int fi0 = (int)fi0f;
    float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
    for (int k = 0; k < MAXK; ++k) {
      l0 += t_ex[k] * s_mu[k * t.F + fi0];
      l1 += t_ex[k] * s_mu[k * t.F + fi0 + 1];
    }
    const float l_ex = l0 + (l1 - l0) * wf;
    const float resp = s_resp[fi0] + (s_resp[fi0 + 1] - s_resp[fi0]) * wf;
    comp += ph * kn * resp * expf(-fminf(fmaxf(l_ex, 0.0f), 60.0f))
            * d_omega;
    if (t.coherent) {
      // Rayleigh: elastic; F^2 of the cell at q = E sin(theta/2) / hc,
      // exit attenuation and detector response at the unshifted energy
      const float qi = fminf(fmaxf(q_half * e * t.dq_inv, 0.0f), t.q_max);
      const float qi0f = floorf(qi);
      const float wq = qi - qi0f;
      const int qi0 = (int)qi0f;
      const float f0 = __ldg(f2 + qi0);
      const float f2v = f0 + (__ldg(f2 + qi0 + 1) - f0) * wq;
      const int c0 = s_fic0[g];
      float m0 = 0.0f, m1 = 0.0f;
#pragma unroll
      for (int k = 0; k < MAXK; ++k) {
        m0 += t_ex[k] * s_mu[k * t.F + c0];
        m1 += t_ex[k] * s_mu[k * t.F + c0 + 1];
      }
      const float l_exc = m0 + (m1 - m0) * s_wfc[g];
      coh += ph * (ray0 * f2v) * s_respg[g]
             * expf(-fminf(fmaxf(l_exc, 0.0f), 60.0f)) * d_omega;
    }
  }
  return comp * w_x + coh * col;
}

}  // namespace dexct_scatter
