// K26 scatter_2d and K27 scatter_3d: first-principles single scatter
// (Klein-Nishina Compton + form-factor Rayleigh) of a fan-beam and a
// cone-beam scan.
//
// Replaces the TPU programs dexct_tpu/ops/scatter_physics.py:_scatter_scan
// (:128) and _scatter_scan_cone (:1229): a lax.scan over views whose body
// marches every (vertex, element) segment in [x_block, c_block, s_out]
// blocks under nested lax.maps, contracts the paths onto a [K, F] fine
// energy table with the MXU and gathers the 2G bins it needs from the
// [x_block, c_block, F] result.
//
// What bounds it on the card: operations.  Per view, X vertices x D
// evaluated elements x s_out march steps x 4 (fan) or 8 (cone) corners,
// each a label load (uint8, L1/L2 resident) and MAXK compare-adds, then per
// (vertex, element, energy bin) two K-dot products, one exp and ~30 float
// operations (twice that with the Rayleigh term).  At the reference
// protocol (4096 vertices, 101 elements, s_out 64, 20 views) that is
// ~5e8 steps and ~1e8 energy terms; nothing is reused between views, so
// the work is arithmetic on registers.
//
// Design: the math of the JAX programs, none of their TPU layout.
// Launch (a), incident: one thread per (view, vertex) marches s_in steps
// from the source, applies the fan gate (and, on the cone, the fractional
// overlap with the collimated slab) and writes phi [view, G, vertex] (bin
// major, so launch (b)'s threads read it coalesced) and (z, w_x, col) per
// (view, vertex).  Launch (b), exit: one block per (view, element) pair,
// one thread per vertex in a strided loop over all vertices; each thread
// marches its exit segment into MAXK material paths in registers and
// evaluates the Compton and Rayleigh terms only at the two fine-grid bins
// each energy needs (not the whole [F] row the TPU program forms); the
// fine mu table, the response and the per-bin constants sit in shared
// memory; the block sums its threads in a fixed order (warp shuffles,
// then one warp), so a call repeats bitwise and needs no atomics.
// Vertices outside the beam (col = 0: every term of theirs is a product
// with 0) skip the march.  The marches and energy terms are
// scatter_march.cuh's, shared by both kernels.

#include <cuda_runtime.h>

#include "scatter_march.cuh"

namespace {

using dexct_scatter::Grid;
using dexct_scatter::Terms;

constexpr int kThreads = 256;

template <int MAXK, bool THREE_D>
__global__ void incident_kernel(Grid grid, const float* __restrict__ cells,
                                const float* __restrict__ ne_w,
                                const float* __restrict__ src,
                                const float* __restrict__ d0,
                                const float* __restrict__ mu_gE,
                                const float* __restrict__ n0_g,
                                float* __restrict__ phi,
                                float* __restrict__ aux, int nv, int X, int G,
                                int s_in, float geom, float g_half,
                                float beam_a, float beam_b) {
  extern __shared__ float sm[];
  float* s_mu = sm;               // [MAXK, G]
  float* s_n0 = sm + MAXK * G;    // [G]
  for (int i = threadIdx.x; i < MAXK * G; i += blockDim.x) s_mu[i] = mu_gE[i];
  for (int i = threadIdx.x; i < G; i += blockDim.x) s_n0[i] = n0_g[i];
  __syncthreads();
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)nv * X) return;
  const int v = (int)(idx / X), x = (int)(idx % X);
  const int dims = THREE_D ? 3 : 2;
  const float px = cells[(size_t)x * dims], py = cells[(size_t)x * dims + 1];
  const float sx = src[v * 3], sy = src[v * 3 + 1], sz = src[v * 3 + 2];
  const float relx = __fsub_rn(px, sx), rely = __fsub_rn(py, sy);
  const float r_ip = sqrtf(relx * relx + rely * rely);
  const bool in_fan = fabsf(dexct_scatter::fan_angle(
                          relx, rely, d0[v * 2], d0[v * 2 + 1])) <= g_half;
  float pz = 0.0f, col;
  if (THREE_D) {
    // the cell's overlap with the slab |z| < t_half r_ip, at its midpoint
    const float cz = cells[(size_t)x * 3 + 2];
    const float bh = beam_a * r_ip;
    const float z_lo = fmaxf(cz - beam_b, -bh);
    const float z_hi = fminf(cz + beam_b, bh);
    pz = 0.5f * (z_lo + z_hi);
    col = in_fan ? fmaxf(z_hi - z_lo, 0.0f) : 0.0f;
  } else {
    col = in_fan ? beam_a * r_ip : 0.0f;  // h_over_sid r: the fan's height
  }
  float* a = aux + ((size_t)v * X + x) * 4;
  a[0] = pz;
  a[1] = ne_w[x] * col;
  a[2] = col;
  a[3] = 0.0f;
  float* ph = phi + (size_t)v * G * X + x;
  if (col == 0.0f) {  // not illuminated: launch (b) skips it
    for (int g = 0; g < G; ++g) ph[(size_t)g * X] = 0.0f;
    return;
  }
  float t_in[MAXK];
  dexct_scatter::march<MAXK, THREE_D>(grid, sx, sy, sz, px, py, pz, s_in,
                                      t_in);
  float pref;
  if (THREE_D) {
    const float rz = pz - sz;
    const float r_3 = sqrtf(relx * relx + rely * rely + rz * rz);
    pref = geom * (r_3 / r_ip) / (r_ip * r_ip);
  } else {
    pref = geom / (r_ip * r_ip);
  }
  for (int g = 0; g < G; ++g) {
    float L = 0.0f;
#pragma unroll
    for (int k = 0; k < MAXK; ++k) L += t_in[k] * s_mu[k * G + g];
    ph[(size_t)g * X] = pref * s_n0[g] * expf(-L);
  }
}

template <int MAXK, bool THREE_D>
__global__ void exit_kernel(Grid grid, Terms t, const float* __restrict__ cells,
                            const float* __restrict__ aux,
                            const float* __restrict__ phi,
                            const float* __restrict__ f2w,
                            const float* __restrict__ src,
                            const float* __restrict__ det,
                            const float* __restrict__ nrm,
                            const float* __restrict__ mu_fine,
                            const float* __restrict__ resp_fine,
                            const float* __restrict__ resp_g,
                            const float* __restrict__ e_g,
                            float* __restrict__ out, int X, int D, int s_out,
                            float inv_mec2) {
  extern __shared__ float sm[];
  const int G = t.G, F = t.F;
  float* s_mu = sm;                  // [MAXK, F]
  float* s_resp = s_mu + MAXK * F;   // [F]
  float* s_eg = s_resp + F;          // [G]
  float* s_kg = s_eg + G;            // [G]
  float* s_respg = s_kg + G;         // [G]
  float* s_wfc = s_respg + G;        // [G]
  int* s_fic0 = reinterpret_cast<int*>(s_wfc + G);  // [G]
  float* s_red = reinterpret_cast<float*>(s_fic0 + G);  // [32]
  for (int i = threadIdx.x; i < MAXK * F; i += blockDim.x)
    s_mu[i] = mu_fine[i];
  for (int i = threadIdx.x; i < F; i += blockDim.x) s_resp[i] = resp_fine[i];
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const float e = e_g[g];
    s_eg[g] = e;
    s_kg[g] = e * inv_mec2;
    s_respg[g] = resp_g[g];
    // the elastic exit reads the fine table at the unshifted energy
    const float fic = fminf(fmaxf((e - t.ef0) * t.inv_def, 0.0f), t.f_max);
    const float fic0 = floorf(fic);
    s_fic0[g] = (int)fic0;
    s_wfc[g] = fic - fic0;
  }
  __syncthreads();

  const int d = blockIdx.x, v = blockIdx.y;
  const float* dp = det + ((size_t)v * D + d) * 3;
  const float ex = dp[0], ey = dp[1], ez = THREE_D ? dp[2] : 0.0f;
  const float nx_ = nrm[((size_t)v * D + d) * 2];
  const float ny_ = nrm[((size_t)v * D + d) * 2 + 1];
  const float sx = src[v * 3], sy = src[v * 3 + 1], sz = src[v * 3 + 2];
  const int dims = THREE_D ? 3 : 2;
  float acc = 0.0f;
  for (int x = threadIdx.x; x < X; x += blockDim.x) {
    const float* a = aux + ((size_t)v * X + x) * 4;
    const float col = a[2];
    if (col == 0.0f) continue;
    const float w_x = a[1];
    const float px = cells[(size_t)x * dims], py = cells[(size_t)x * dims + 1];
    const float pz = THREE_D ? a[0] : 0.0f;
    float t_ex[MAXK];
    dexct_scatter::march<MAXK, THREE_D>(grid, px, py, pz, ex, ey, ez, s_out,
                                        t_ex);
    const float rx = px - sx, ry = py - sy;
    const float rz = THREE_D ? pz - sz : 0.0f;
    const float r_in = sqrtf(rx * rx + ry * ry + rz * rz);
    const float dvx = ex - px, dvy = ey - py;
    const float dvz = THREE_D ? ez - pz : 0.0f;
    const float r_d = sqrtf(dvx * dvx + dvy * dvy + dvz * dvz);
    const float ox = dvx / r_d, oy = dvy / r_d;
    const float oz = THREE_D ? dvz / r_d : 0.0f;
    // 1 - cos(theta) = |u_in - u_out|^2 / 2, free of the cancellation of
    // 1 - u_in . u_out near the forward direction (scatter_march.cuh)
    const float dux = rx / r_in - ox, duy = ry / r_in - oy;
    const float duz = THREE_D ? rz / r_in - oz : 0.0f;
    const float one_m = 0.5f * (dux * dux + duy * duy + duz * duz);
    const float cos_inc = fabsf(ox * nx_ + oy * ny_);
    const float d_omega = t.a_det * cos_inc / (r_d * r_d);
    acc += dexct_scatter::pair_terms<MAXK>(
        t, t_ex, one_m, d_omega, w_x, col, phi + (size_t)v * G * X + x,
        (size_t)X, f2w + (size_t)x * t.Q, s_mu, s_resp, s_eg, s_kg, s_respg,
        s_fic0, s_wfc);
  }
  // block sum in a fixed order: each warp by shuffles, then warp 0
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_red[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    float s = lane < n_warps ? s_red[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) out[(size_t)v * D + d] = s;
  }
}

template <int MAXK, bool THREE_D>
int launch(const Grid& grid, const Terms& t, const float* cells,
           const float* ne_w, const float* f2w, const float* mu_gE,
           const float* mu_fine, const float* resp_fine, const float* resp_g,
           const float* n0_g, const float* e_g, const float* src,
           const float* d0, const float* det, const float* nrm, float* phi,
           float* aux, float* out, int nv, int X, int D, int s_in, int s_out,
           float geom, float g_half, float beam_a, float beam_b,
           float inv_mec2, cudaStream_t stream) {
  const int G = t.G, F = t.F;
  const size_t smem_a = sizeof(float) * (size_t)(MAXK + 1) * G;
  const size_t smem_b = sizeof(float) * ((size_t)(MAXK + 1) * F + 5 * G + 32);
  if (smem_a > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        incident_kernel<MAXK, THREE_D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
    if (e != cudaSuccess) return (int)e;
  }
  if (smem_b > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        exit_kernel<MAXK, THREE_D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
    if (e != cudaSuccess) return (int)e;
  }
  const long long n_a = (long long)nv * X;
  incident_kernel<MAXK, THREE_D>
      <<<(unsigned)((n_a + kThreads - 1) / kThreads), kThreads, smem_a,
         stream>>>(grid, cells, ne_w, src, d0, mu_gE, n0_g, phi, aux, nv, X,
                   G, s_in, geom, g_half, beam_a, beam_b);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  exit_kernel<MAXK, THREE_D><<<dim3(D, nv), kThreads, smem_b, stream>>>(
      grid, t, cells, aux, phi, f2w, src, det, nrm, mu_fine, resp_fine,
      resp_g, e_g, out, X, D, s_out, inv_mec2);
  return (int)cudaGetLastError();
}

template <bool THREE_D>
int scatter(const void* labels, const void* cells, const void* ne_w,
            const void* f2w, const void* mu_gE, const void* mu_fine,
            const void* resp_fine, const void* resp_g, const void* n0_g,
            const void* e_g, const void* src, const void* d0, const void* det,
            const void* nrm, void* phi, void* aux, void* out, int maxk,
            int nv, int X, int D, int G, int F, int Q, int nx, int ny, int nz,
            int s_in, int s_out, int coherent, float dx, float dy, float dz,
            float hx, float hy, float hz, float cx, float cy, float cz,
            float geom, float g_half, float beam_a, float beam_b, float ef0,
            float def, float f_max, float q_max, float a_det, float dq_inv,
            float c_r2, float inv_hc, float inv_mec2, void* stream) {
  if (nv <= 0 || X <= 0 || D <= 0) return (int)cudaGetLastError();
  if (G <= 0 || F < 2 || Q < 1 || s_in <= 0 || s_out <= 0)
    return (int)cudaErrorInvalidValue;
  Grid grid;
  grid.labels = static_cast<const unsigned char*>(labels);
  grid.nx = nx;
  grid.ny = ny;
  grid.nz = nz;
  grid.inv_dx = 1.0f / dx;
  grid.inv_dy = 1.0f / dy;
  grid.inv_dz = 1.0f / dz;
  grid.hx = hx;
  grid.hy = hy;
  grid.hz = hz;
  grid.cx = cx;
  grid.cy = cy;
  grid.cz = cz;
  Terms t;
  t.G = G;
  t.F = F;
  t.Q = Q;
  t.coherent = coherent;
  t.ef0 = ef0;
  t.inv_def = 1.0f / def;
  t.f_max = f_max;
  t.q_max = q_max;
  t.a_det = a_det;
  t.c_r2 = c_r2;
  t.inv_hc = inv_hc;
  t.dq_inv = dq_inv;
#define DEXCT_ARGS                                                          \
  grid, t, static_cast<const float*>(cells), static_cast<const float*>(ne_w), \
      static_cast<const float*>(f2w), static_cast<const float*>(mu_gE),     \
      static_cast<const float*>(mu_fine),                                   \
      static_cast<const float*>(resp_fine),                                 \
      static_cast<const float*>(resp_g), static_cast<const float*>(n0_g),   \
      static_cast<const float*>(e_g), static_cast<const float*>(src),       \
      static_cast<const float*>(d0), static_cast<const float*>(det),        \
      static_cast<const float*>(nrm), static_cast<float*>(phi),             \
      static_cast<float*>(aux), static_cast<float*>(out), nv, X, D, s_in,   \
      s_out, geom, g_half, beam_a, beam_b, inv_mec2,                        \
      static_cast<cudaStream_t>(stream)
  switch (maxk) {
    case 4: return launch<4, THREE_D>(DEXCT_ARGS);
    case 8: return launch<8, THREE_D>(DEXCT_ARGS);
    case 16: return launch<16, THREE_D>(DEXCT_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DEXCT_ARGS
}

}  // namespace

#define DEXCT_SCATTER_PARAMS                                                   \
  const void *labels, const void *cells, const void *ne_w, const void *f2w,    \
      const void *mu_gE, const void *mu_fine, const void *resp_fine,           \
      const void *resp_g, const void *n0_g, const void *e_g, const void *src,  \
      const void *d0, const void *det, const void *nrm, void *phi, void *aux,  \
      void *out, int maxk, int nv, int X, int D, int G, int F, int Q, int nx,  \
      int ny, int nz, int s_in, int s_out, int coherent, float dx, float dy,   \
      float dz, float hx, float hy, float hz, float cx, float cy, float cz,    \
      float geom, float g_half, float beam_a, float beam_b, float ef0,         \
      float def, float f_max, float q_max, float a_det, float dq_inv,          \
      float c_r2, float inv_hc, float inv_mec2, void *stream
#define DEXCT_SCATTER_NAMES                                                    \
  labels, cells, ne_w, f2w, mu_gE, mu_fine, resp_fine, resp_g, n0_g, e_g, src, \
      d0, det, nrm, phi, aux, out, maxk, nv, X, D, G, F, Q, nx, ny, nz, s_in,  \
      s_out, coherent, dx, dy, dz, hx, hy, hz, cx, cy, cz, geom, g_half,       \
      beam_a, beam_b, ef0, def, f_max, q_max, a_det, dq_inv, c_r2, inv_hc,     \
      inv_mec2, stream

// K26: the fan beam (labels [1, ny, nx], cells [X, 2], det [nv, D, 3] at
// z = 0; beam_a = h_iso / SID, beam_b unused)
extern "C" int dexct_scatter_2d(DEXCT_SCATTER_PARAMS) {
  return scatter<false>(DEXCT_SCATTER_NAMES);
}

// K27: the cone beam (labels [nz, ny, nx], cells [X, 3]; beam_a = the
// beam's half-height tangent t_half, beam_b = half a cell's z extent)
extern "C" int dexct_scatter_3d(DEXCT_SCATTER_PARAMS) {
  return scatter<true>(DEXCT_SCATTER_NAMES);
}
