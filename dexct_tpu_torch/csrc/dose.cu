// K23 dose_2d and K24 dose_3d: per-voxel absorbed dose of a fan-beam or
// cone-beam scan, two launches per block of views.
//
// K23 replaces dexct_tpu/ops/dose.py:_dose_accumulate, K24
// dexct_tpu/ops/dose.py:_dose_accumulate_3d: a lax.scan over views that
// samples the bit-packed labels on a polar grid around the source, takes a
// cumsum along r into the partial material paths T, gathers each voxel's T
// and contracts exp(-T . mu(E)) with its material's deposition
// coefficients (MXU matmuls over voxel blocks).  Here each block of views
// runs:
//
// 1. The polar pass: one thread per (view, gamma) line (per (view, t,
//    gamma) in 3-D).  It walks r, forms the bilinear (trilinear) occupancy
//    of the uint8 labels with the JAX program's bounds tests and corner
//    order, keeps the midpoint running sum (cumsum - occ / 2) dr (times
//    sec t in 3-D) in registers and writes T [view][r][(t,) gamma][K]:
//    neighbouring threads write neighbouring lines, so the stores coalesce.
// 2. The voxel pass: one thread per voxel looping over the block's views
//    in order, so each voxel's dose sums in the JAX program's view order
//    with no atomics.  It forms (gamma, (t,) r) of the voxel in the JAX
//    operation order (clips at n - 1.001, the in-fan / in-beam gate), reads
//    T bilinearly (trilinearly), and loops over the energies with mu,
//    mu_dep and the fluence weights in shared memory; only the voxel's own
//    material's mu_dep is read (the JAX one-hot contraction picks that
//    column).  Out of the beam the view adds an exact zero and is skipped.
//    In 3-D a view covers only its z slab (k0 per view, the JAX program's
//    z_window).  The deposited energy is a per-thread float64 sum, reduced
//    per thread block in a fixed order into one slot per block; the host
//    adds the slots.
//
// What bounds it on the card: per (voxel, view, energy) one exp and K + 2
// float32 operations; the reference protocol's 2-D map is ~1e10 of those
// (65536 voxels x 1000 views x ~80 live energies), the cone config's ~6e10.
// T is 6.3 MB per 2-D view (512 x 512 x K = 6) and 0.26 GB per 3-D view
// (512 x 36 x 512 x K = 7): the host sizes the view blocks to ~1 GB.
// expf (IEEE-accurate), not __expf: the tests hold the map to 1e-4 of its
// maximum.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// occ[lab] += w for lab < K, with constant register indices
template <int MAXK>
__device__ __forceinline__ void add_occ(float (&occ)[MAXK], int lab, int K,
                                        float w) {
#pragma unroll
  for (int k = 0; k < MAXK; ++k)
    if (k < K && k == lab) occ[k] = __fadd_rn(occ[k], w);
}

// sum_E i0w(E) exp(-t . mu(E)) mu_dep_own(E)
template <int MAXK>
__device__ __forceinline__ float own_deposit(const float (&t)[MAXK], int K,
                                             int E, const float* muT,
                                             const float* i0w,
                                             const float* dep) {
  float c = 0.0f;
  for (int e = 0; e < E; ++e) {
    const float* m = muT + e * K;
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < MAXK; ++k)
      if (k < K) s = fmaf(t[k], m[k], s);
    c = fmaf(expf(-s) * i0w[e], dep[e], c);
  }
  return c;
}

__device__ void load_tables(float* sh, const float* muT, const float* dep,
                            const float* i0w, int K, int E) {
  for (int i = threadIdx.x; i < E * K; i += blockDim.x) {
    sh[i] = muT[i];
    sh[E * K + i] = dep[i];
  }
  for (int i = threadIdx.x; i < E; i += blockDim.x) sh[2 * E * K + i] = i0w[i];
  __syncthreads();
}

// the block's float64 sum, in a fixed order, added into its own slot
__device__ void add_block_sum(double v, double* slot) {
  __shared__ double warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
    *slot += s;
  }
}

// the voxel's (gamma, r) frame of one view: r_v and gamma_v in the JAX
// program's operation order
__device__ __forceinline__ void voxel_frame(float vx, float vy, float s0,
                                            float s1, float sid, float* r_v,
                                            float* g_v) {
  const float relx = __fsub_rn(vx, s0), rely = __fsub_rn(vy, s1);
  const float r = sqrtf(__fadd_rn(__fmul_rn(relx, relx),
                                  __fmul_rn(rely, rely)));
  const float d0x = -s0 / sid, d0y = -s1 / sid;
  const float dotp =
      __fadd_rn(__fmul_rn(relx, d0x), __fmul_rn(rely, d0y)) / r;
  const float crossp =
      __fsub_rn(__fmul_rn(d0x, rely), __fmul_rn(d0y, relx)) / r;
  *r_v = r;
  *g_v = atan2f(crossp, dotp);
}

// clip((x - x0) / dx, 0, xmax): the cell index and its fraction
__device__ __forceinline__ int grid_pos(float x, float x0, float dx,
                                        float xmax, float* frac) {
  const float f = fminf(fmaxf(__fsub_rn(x, x0) / dx, 0.0f), xmax);
  const float fl = floorf(f);
  *frac = __fsub_rn(f, fl);
  return (int)fl;
}

__device__ __forceinline__ float lerp(float a, float b, float w) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, w)), __fmul_rn(b, w));
}

template <int MAXK>
__global__ void polar_2d_kernel(const unsigned char* __restrict__ labels,
                                const float* __restrict__ src,
                                const float* __restrict__ ca,
                                const float* __restrict__ sa,
                                const float* __restrict__ rs,
                                float* __restrict__ T, int nv, int n_g,
                                int n_r, int K, int nx, int ny, float dx,
                                float dy, float cx, float cy, float dr) {
  const long long line = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (line >= (long long)nv * n_g) return;
  const int v = (int)(line / n_g), g = (int)(line % n_g);
  const float s0 = src[2 * v], s1 = src[2 * v + 1];
  const float c = ca[line], s = sa[line];
  float cum[MAXK];
#pragma unroll
  for (int k = 0; k < MAXK; ++k) cum[k] = 0.0f;
  float* Tv = T + (size_t)v * n_r * n_g * K;
  for (int r = 0; r < n_r; ++r) {
    const float rr = __ldg(rs + r);
    const float fx = __fadd_rn(__fsub_rn(s0, __fmul_rn(c, rr)) / dx, cx);
    const float fy = __fadd_rn(__fsub_rn(s1, __fmul_rn(s, rr)) / dy, cy);
    const float flx = floorf(fx), fly = floorf(fy);
    const int ix0 = (int)flx, iy0 = (int)fly;
    const float wx = __fsub_rn(fx, flx), wy = __fsub_rn(fy, fly);
    float occ[MAXK];
#pragma unroll
    for (int k = 0; k < MAXK; ++k) occ[k] = 0.0f;
#pragma unroll
    for (int ty = 0; ty < 2; ++ty) {
#pragma unroll
      for (int tx = 0; tx < 2; ++tx) {
        const int iy = iy0 + ty, ix = ix0 + tx;
        if (iy < 0 || iy >= ny || ix < 0 || ix >= nx) continue;
        const float w = __fmul_rn(ty ? wy : __fsub_rn(1.0f, wy),
                                  tx ? wx : __fsub_rn(1.0f, wx));
        add_occ<MAXK>(occ, __ldg(labels + (size_t)iy * nx + ix), K, w);
      }
    }
    float* out = Tv + ((size_t)r * n_g + g) * K;
#pragma unroll
    for (int k = 0; k < MAXK; ++k) {
      if (k >= K) break;
      cum[k] = __fadd_rn(cum[k], occ[k]);
      out[k] = __fmul_rn(__fsub_rn(cum[k], __fmul_rn(0.5f, occ[k])), dr);
    }
  }
}

template <int MAXK>
__global__ void voxel_2d_kernel(
    const float* __restrict__ T, const float* __restrict__ src,
    const float* __restrict__ vw, const float* __restrict__ vox,
    const float* __restrict__ rho, const unsigned char* __restrict__ lab,
    const float* __restrict__ muT, const float* __restrict__ mu_dep,
    const float* __restrict__ i0w, float* __restrict__ dose,
    double* __restrict__ edep, int nv, int n_g, int n_r, int K, int E,
    long long n_vox, float sid, float g0, float dg, float gmax, float r0,
    float dr, float rmax, float geom, float g_half, float h_over_sid,
    float dxdy) {
  extern __shared__ float sh[];
  load_tables(sh, muT, mu_dep, i0w, K, E);
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  double e_sum = 0.0;
  if (j < n_vox) {
    const float vx = vox[2 * j], vy = vox[2 * j + 1], rj = rho[j];
    const int lj = lab[j];
    const float* dep = sh + E * K + (lj < K ? lj : 0) * E;
    float acc = dose[j];
    for (int v = 0; v < nv && lj < K; ++v) {
      const float s0 = src[2 * v], s1 = src[2 * v + 1];
      float r_v, g_v;
      voxel_frame(vx, vy, s0, s1, sid, &r_v, &g_v);
      if (!(fabsf(g_v) <= g_half)) continue;  // out of the fan: adds 0
      float wg, wr;
      const int gi = grid_pos(g_v, g0, dg, gmax, &wg);
      const int ri = grid_pos(r_v, r0, dr, rmax, &wr);
      const float* a = T + (size_t)v * n_r * n_g * K
                       + ((size_t)ri * n_g + gi) * K;  // (g, r)
      const float* b = a + (size_t)n_g * K;            // (g, r + 1)
      float t[MAXK];
#pragma unroll
      for (int k = 0; k < MAXK; ++k) {
        if (k >= K) break;
        t[k] = lerp(lerp(a[k], b[k], wr), lerp(a[K + k], b[K + k], wr), wg);
      }
      const float phi0 = geom / __fmul_rn(r_v, r_v);
      const float e_vol = __fmul_rn(phi0, own_deposit<MAXK>(
          t, K, E, sh, sh + 2 * E * K, dep));
      acc = __fadd_rn(acc, __fmul_rn(vw[v], e_vol / rj));
      e_sum += (double)__fmul_rn(
          vw[v], __fmul_rn(__fmul_rn(e_vol, dxdy),
                           __fmul_rn(h_over_sid, r_v)));
    }
    dose[j] = acc;
  }
  add_block_sum(e_sum, edep + blockIdx.x);
}

template <int MAXK>
__global__ void polar_3d_kernel(const unsigned char* __restrict__ labels,
                                const float* __restrict__ src,
                                const float* __restrict__ src_z,
                                const float* __restrict__ ca,
                                const float* __restrict__ sa,
                                const float* __restrict__ ts,
                                const float* __restrict__ sec,
                                const float* __restrict__ rs,
                                float* __restrict__ T, int nv, int n_g,
                                int n_t, int n_r, int K, int nx, int ny,
                                int nz, float dx, float dy, float dz,
                                float cx, float cy, float cz, float dr) {
  const long long line = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (line >= (long long)nv * n_t * n_g) return;
  const int g = (int)(line % n_g);
  const int t = (int)((line / n_g) % n_t);
  const int v = (int)(line / ((long long)n_g * n_t));
  const float s0 = src[2 * v], s1 = src[2 * v + 1], zs = src_z[v];
  const float c = ca[(size_t)v * n_g + g], s = sa[(size_t)v * n_g + g];
  const float tt = ts[t], st = sec[t];
  float cum[MAXK];
#pragma unroll
  for (int k = 0; k < MAXK; ++k) cum[k] = 0.0f;
  float* Tv = T + (size_t)v * n_r * n_t * n_g * K;
  for (int r = 0; r < n_r; ++r) {
    const float rr = __ldg(rs + r);
    const float fx = __fadd_rn(__fsub_rn(s0, __fmul_rn(c, rr)) / dx, cx);
    const float fy = __fadd_rn(__fsub_rn(s1, __fmul_rn(s, rr)) / dy, cy);
    const float fz = __fadd_rn(__fadd_rn(zs, __fmul_rn(tt, rr)) / dz, cz);
    const float flx = floorf(fx), fly = floorf(fy), flz = floorf(fz);
    const int ix0 = (int)flx, iy0 = (int)fly, iz0 = (int)flz;
    const float wx = __fsub_rn(fx, flx), wy = __fsub_rn(fy, fly);
    const float wz = __fsub_rn(fz, flz);
    float occ[MAXK];
#pragma unroll
    for (int k = 0; k < MAXK; ++k) occ[k] = 0.0f;
#pragma unroll
    for (int tz = 0; tz < 2; ++tz) {
      const int iz = iz0 + tz;
      if (iz < 0 || iz >= nz) continue;
      const float w_z = tz ? wz : __fsub_rn(1.0f, wz);
#pragma unroll
      for (int ty = 0; ty < 2; ++ty) {
#pragma unroll
        for (int tx = 0; tx < 2; ++tx) {
          const int iy = iy0 + ty, ix = ix0 + tx;
          if (iy < 0 || iy >= ny || ix < 0 || ix >= nx) continue;
          const float w = __fmul_rn(
              __fmul_rn(w_z, ty ? wy : __fsub_rn(1.0f, wy)),
              tx ? wx : __fsub_rn(1.0f, wx));
          add_occ<MAXK>(occ,
                        __ldg(labels + ((size_t)iz * ny + iy) * nx + ix), K,
                        w);
        }
      }
    }
    float* out = Tv + (((size_t)r * n_t + t) * n_g + g) * K;
#pragma unroll
    for (int k = 0; k < MAXK; ++k) {
      if (k >= K) break;
      cum[k] = __fadd_rn(cum[k], occ[k]);
      out[k] = __fmul_rn(
          __fmul_rn(__fsub_rn(cum[k], __fmul_rn(0.5f, occ[k])), dr), st);
    }
  }
}

template <int MAXK>
__global__ void voxel_3d_kernel(
    const float* __restrict__ T, const float* __restrict__ src,
    const float* __restrict__ src_z, const float* __restrict__ vw,
    const int* __restrict__ k0s, const float* __restrict__ vox,
    const float* __restrict__ rho, const unsigned char* __restrict__ lab,
    const float* __restrict__ muT, const float* __restrict__ mu_dep,
    const float* __restrict__ i0w, float* __restrict__ dose,
    double* __restrict__ edep, int nv, int n_g, int n_t, int n_r, int K,
    int E, int nynx, int depth, long long n_vox, float sid, float g0,
    float dg, float gmax, float t0, float dt, float tmax, float r0, float dr,
    float rmax, float geom, float g_half, float t_half, float dvol) {
  extern __shared__ float sh[];
  load_tables(sh, muT, mu_dep, i0w, K, E);
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  double e_sum = 0.0;
  if (j < n_vox) {
    const float vx = vox[3 * j], vy = vox[3 * j + 1], vz = vox[3 * j + 2];
    const float rj = rho[j];
    const int lj = lab[j];
    const int kz = (int)(j / nynx);
    const float* dep = sh + E * K + (lj < K ? lj : 0) * E;
    const size_t sr = (size_t)n_t * n_g * K;  // r + 1
    const size_t st = (size_t)n_g * K;        // t + 1
    float acc = dose[j];
    for (int v = 0; v < nv && lj < K; ++v) {
      const int k0 = k0s[v];
      if (kz < k0 || kz >= k0 + depth) continue;  // outside the view's slab
      const float s0 = src[2 * v], s1 = src[2 * v + 1];
      float r_v, g_v;
      voxel_frame(vx, vy, s0, s1, sid, &r_v, &g_v);
      const float t_v = __fsub_rn(vz, src_z[v]) / r_v;
      if (!(fabsf(g_v) <= g_half && fabsf(t_v) <= t_half)) continue;
      float wg, wt, wr;
      const int gi = grid_pos(g_v, g0, dg, gmax, &wg);
      const int ti = grid_pos(t_v, t0, dt, tmax, &wt);
      const int ri = grid_pos(r_v, r0, dr, rmax, &wr);
      const float* a = T + (size_t)v * n_r * sr
                       + ((size_t)ri * n_t + ti) * n_g * K + (size_t)gi * K;
      float tv[MAXK];
#pragma unroll
      for (int k = 0; k < MAXK; ++k) {
        if (k >= K) break;
        // lerp over r of the (g, t), (g, t + 1), (g + 1, t), (g + 1, t + 1)
        // rows, then t, then g, as the JAX program
        const float l00 = lerp(a[k], a[sr + k], wr);
        const float l01 = lerp(a[st + k], a[sr + st + k], wr);
        const float l10 = lerp(a[K + k], a[sr + K + k], wr);
        const float l11 = lerp(a[st + K + k], a[sr + st + K + k], wr);
        tv[k] = lerp(lerp(l00, l01, wt), lerp(l10, l11, wt), wg);
      }
      const float sec_v =
          sqrtf(__fadd_rn(1.0f, __fmul_rn(t_v, t_v)));
      const float phi0 = __fmul_rn(geom, sec_v) / __fmul_rn(r_v, r_v);
      const float e_vol = __fmul_rn(phi0, own_deposit<MAXK>(
          tv, K, E, sh, sh + 2 * E * K, dep));
      acc = __fadd_rn(acc, __fmul_rn(vw[v], e_vol / rj));
      e_sum += (double)__fmul_rn(vw[v], __fmul_rn(e_vol, dvol));
    }
    dose[j] = acc;
  }
  add_block_sum(e_sum, edep + blockIdx.x);
}

template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int MAXK>
int launch_2d(const unsigned char* labels, const float* src, const float* ca,
              const float* sa, const float* vw, const float* rs,
              const float* vox, const float* rho, const unsigned char* lab,
              const float* muT, const float* mu_dep, const float* i0w,
              float* T, float* dose, double* edep, int nv, int n_g, int n_r,
              int K, int E, int nx, int ny, long long n_vox, float sid,
              float dx, float dy, float cx, float cy, float g0, float dg,
              float gmax, float r0, float dr, float rmax, float geom,
              float g_half, float h_over_sid, float dxdy,
              cudaStream_t stream) {
  const long long lines = (long long)nv * n_g;
  polar_2d_kernel<MAXK><<<(unsigned)((lines + kThreads - 1) / kThreads),
                          kThreads, 0, stream>>>(
      labels, src, ca, sa, rs, T, nv, n_g, n_r, K, nx, ny, dx, dy, cx, cy,
      dr);
  const size_t smem = (size_t)(2 * E * K + E) * sizeof(float);
  cudaError_t err = allow_smem(voxel_2d_kernel<MAXK>, smem);
  if (err != cudaSuccess) return (int)err;
  voxel_2d_kernel<MAXK><<<(unsigned)((n_vox + kThreads - 1) / kThreads),
                          kThreads, smem, stream>>>(
      T, src, vw, vox, rho, lab, muT, mu_dep, i0w, dose, edep, nv, n_g, n_r,
      K, E, n_vox, sid, g0, dg, gmax, r0, dr, rmax, geom, g_half,
      h_over_sid, dxdy);
  return (int)cudaGetLastError();
}

template <int MAXK>
int launch_3d(const unsigned char* labels, const float* src,
              const float* src_z, const float* ca, const float* sa,
              const float* vw, const int* k0s, const float* ts,
              const float* sec, const float* rs, const float* vox,
              const float* rho, const unsigned char* lab, const float* muT,
              const float* mu_dep, const float* i0w, float* T, float* dose,
              double* edep, int nv, int n_g, int n_t, int n_r, int K, int E,
              int nx, int ny, int nz, int depth, long long n_vox, float sid,
              float dx, float dy, float dz, float cx, float cy, float cz,
              float g0, float dg, float gmax, float t0, float dt, float tmax,
              float r0, float dr, float rmax, float geom, float g_half,
              float t_half, float dvol, cudaStream_t stream) {
  const long long lines = (long long)nv * n_t * n_g;
  polar_3d_kernel<MAXK><<<(unsigned)((lines + kThreads - 1) / kThreads),
                          kThreads, 0, stream>>>(
      labels, src, src_z, ca, sa, ts, sec, rs, T, nv, n_g, n_t, n_r, K, nx,
      ny, nz, dx, dy, dz, cx, cy, cz, dr);
  const size_t smem = (size_t)(2 * E * K + E) * sizeof(float);
  cudaError_t err = allow_smem(voxel_3d_kernel<MAXK>, smem);
  if (err != cudaSuccess) return (int)err;
  voxel_3d_kernel<MAXK><<<(unsigned)((n_vox + kThreads - 1) / kThreads),
                          kThreads, smem, stream>>>(
      T, src, src_z, vw, k0s, vox, rho, lab, muT, mu_dep, i0w, dose, edep,
      nv, n_g, n_t, n_r, K, E, nx * ny, depth, n_vox, sid, g0, dg, gmax, t0,
      dt, tmax, r0, dr, rmax, geom, g_half, t_half, dvol);
  return (int)cudaGetLastError();
}

}  // namespace

// One block of nv views of a fan-beam dose map.  labels [ny, nx] uint8;
// src [nv, 2]; ca, sa [nv, n_g]; vw [nv]; rs [n_r]; vox [n_vox, 2]; rho
// [n_vox]; lab [n_vox] uint8; muT [E, K]; mu_dep [K, E]; i0w [E]; T
// scratch [nv, n_r, n_g, K]; dose [n_vox] and edep [ceil(n_vox / 256)]
// (float64) accumulated into.  maxk: 4, 8 or 16 >= K.
extern "C" int dexct_dose_2d(
    const void* labels, const void* src, const void* ca, const void* sa,
    const void* vw, const void* rs, const void* vox, const void* rho,
    const void* lab, const void* muT, const void* mu_dep, const void* i0w,
    void* T, void* dose, void* edep, int maxk, int nv, int n_g, int n_r,
    int K, int E, int nx, int ny, long long n_vox, float sid, float dx,
    float dy, float cx, float cy, float g0, float dg, float gmax, float r0,
    float dr, float rmax, float geom, float g_half, float h_over_sid,
    float dxdy, void* stream) {
  if (nv <= 0 || n_vox <= 0) return (int)cudaGetLastError();
#define DEXCT_DOSE_2D(M)                                                     \
  launch_2d<M>(static_cast<const unsigned char*>(labels),                    \
               static_cast<const float*>(src), static_cast<const float*>(ca), \
               static_cast<const float*>(sa), static_cast<const float*>(vw), \
               static_cast<const float*>(rs), static_cast<const float*>(vox), \
               static_cast<const float*>(rho),                               \
               static_cast<const unsigned char*>(lab),                       \
               static_cast<const float*>(muT),                               \
               static_cast<const float*>(mu_dep),                            \
               static_cast<const float*>(i0w), static_cast<float*>(T),       \
               static_cast<float*>(dose), static_cast<double*>(edep), nv,    \
               n_g, n_r, K, E, nx, ny, n_vox, sid, dx, dy, cx, cy, g0, dg,   \
               gmax, r0, dr, rmax, geom, g_half, h_over_sid, dxdy,           \
               static_cast<cudaStream_t>(stream))
  switch (maxk) {
    case 4:
      return DEXCT_DOSE_2D(4);
    case 8:
      return DEXCT_DOSE_2D(8);
    case 16:
      return DEXCT_DOSE_2D(16);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DEXCT_DOSE_2D
}

// One block of nv views of a cone-beam dose map.  labels [nz, ny, nx]
// uint8; src [nv, 2]; src_z, vw [nv]; k0s [nv] int32 (first slice of each
// view's slab of `depth` slices); ts, sec [n_t]; rs [n_r]; vox [n_vox, 3];
// T scratch [nv, n_r, n_t, n_g, K]; the rest as dexct_dose_2d.
extern "C" int dexct_dose_3d(
    const void* labels, const void* src, const void* src_z, const void* ca,
    const void* sa, const void* vw, const void* k0s, const void* ts,
    const void* sec, const void* rs, const void* vox, const void* rho,
    const void* lab, const void* muT, const void* mu_dep, const void* i0w,
    void* T, void* dose, void* edep, int maxk, int nv, int n_g, int n_t,
    int n_r, int K, int E, int nx, int ny, int nz, int depth, long long n_vox,
    float sid, float dx, float dy, float dz, float cx, float cy, float cz,
    float g0, float dg, float gmax, float t0, float dt, float tmax, float r0,
    float dr, float rmax, float geom, float g_half, float t_half, float dvol,
    void* stream) {
  if (nv <= 0 || n_vox <= 0) return (int)cudaGetLastError();
#define DEXCT_DOSE_3D(M)                                                     \
  launch_3d<M>(static_cast<const unsigned char*>(labels),                    \
               static_cast<const float*>(src),                               \
               static_cast<const float*>(src_z),                             \
               static_cast<const float*>(ca), static_cast<const float*>(sa), \
               static_cast<const float*>(vw), static_cast<const int*>(k0s),  \
               static_cast<const float*>(ts), static_cast<const float*>(sec), \
               static_cast<const float*>(rs), static_cast<const float*>(vox), \
               static_cast<const float*>(rho),                               \
               static_cast<const unsigned char*>(lab),                       \
               static_cast<const float*>(muT),                               \
               static_cast<const float*>(mu_dep),                            \
               static_cast<const float*>(i0w), static_cast<float*>(T),       \
               static_cast<float*>(dose), static_cast<double*>(edep), nv,    \
               n_g, n_t, n_r, K, E, nx, ny, nz, depth, n_vox, sid, dx, dy,   \
               dz, cx, cy, cz, g0, dg, gmax, t0, dt, tmax, r0, dr, rmax,     \
               geom, g_half, t_half, dvol, static_cast<cudaStream_t>(stream))
  switch (maxk) {
    case 4:
      return DEXCT_DOSE_3D(4);
    case 8:
      return DEXCT_DOSE_3D(8);
    case 16:
      return DEXCT_DOSE_3D(16);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DEXCT_DOSE_3D
}
