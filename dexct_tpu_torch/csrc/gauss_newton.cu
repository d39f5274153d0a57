// K3 gauss_newton: per-pixel two-material Gauss-Newton decomposition.
//
// Replaces the TPU program dexct_tpu/ops/matdecomp.py:gauss_newton_solve
// -> _solve_block -> _solve_spd for M = K = 2 (two spectra, two basis
// materials).  The TPU form iterates all pixels at once as [B, E] x [E, k]
// matrix products, writing a [B, E] attenuation array to HBM every
// iteration.
//
// What bounds it on the card: arithmetic, not memory.  Each pixel reads
// two counts and writes two floats, but runs n_iters passes over the
// energy tables with one exp and 8 FMAs per (iteration, energy).  Design:
// one thread per sinogram pixel keeps its iterate, its log counts and
// every iteration in registers; the energy tables sit in shared memory
// (rows of 8 floats: mu_0, mu_1, i0_0, i0_1, g_00, g_01, g_10, g_11; the
// full union grid for the polish, then the warm-phase table), read by all
// threads of the block at the same address (broadcast, no bank conflict);
// the 2x2 system is solved in closed form.  No [B, E] array exists.
//
// Schedule, as _solve_block runs it for M == K: counts normalised by
// scale = max(i0); a = eps_init; n_warm log-residual Newton steps on the
// warm table, then n_pol log-residual polish steps (the M == K polish is
// the log step too, not the MLE step) on the full table in float32; both
// with a trust radius of 10 * step_max and the lower clamp max(a_lo, -1);
// exp argument clipped to [-clip, 20]; nu floored at 1e-35, log y with
// max(y, 1e-35); residuals clipped to +-30; a dead Hessian (max |H| <
// 1e-30) takes a zero step; a clipped to [a_lo, a_hi] bounds.
//
// The warm phase of the JAX package runs in bfloat16 on the moment-
// compressed table (warm_nodes = 32 nodes).  With warm_bf16 set this kernel
// rounds exactly where that program rounds (the iterate and the table to
// bf16, the attenuation exponent and exp to bf16, sums in float32), so it
// tracks the plain version's iterates rather than only its fixed point.
//
// K29 gauss_newton_grouped: the same per-pixel solve over fluence groups.
//
// Replaces the TPU program jax.vmap(gauss_newton_solve) over the groups of
// dexct_tpu/ops/bowtie.py:decompose_sinograms_bowtie (bowtie thickness
// levels) and dexct_tpu/ops/heel.py:decompose_cone_sinograms_heel
// (detector rows): each group has its own i0 table, and so its own scale
// and its own full and warm tables.  The vmap pads every group to the
// largest one (31 bowtie groups x 308 channels for 800 channels at the
// reference protocol, 11.9x the work).  Here the wrapper sorts the pixels
// into group order and pads each group only to a whole block of 128
// pixels with copies of the group's first pixel; each block reads its
// group id, loads that group's tables into shared memory and runs K3's
// per-pixel schedule (solve_pixel, shared with K3).  Bound and design are
// K3's: arithmetic, one exp and 8 FMAs per (iteration, energy).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRow = 8;

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Moments {
  float nu0, nu1, g00, g01, g10, g11;
};

template <bool kBf16>
__device__ __forceinline__ Moments moments(const float* tab, int n, float a0,
                                           float a1, float clip) {
  Moments s = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (kBf16) {
    a0 = bf16r(a0);
    a1 = bf16r(a1);
  }
  for (int e = 0; e < n; ++e) {
    const float* row = tab + kRow * e;
    float L = a0 * row[0] + a1 * row[1];
    if (kBf16) L = bf16r(L);
    float at = expf(fminf(fmaxf(-L, -clip), 20.0f));
    if (kBf16) at = bf16r(at);
    s.nu0 += at * row[2];
    s.nu1 += at * row[3];
    s.g00 += at * row[4];
    s.g01 += at * row[5];
    s.g10 += at * row[6];
    s.g11 += at * row[7];
  }
  return s;
}

// Newton step on the log residuals r_m = ln y_m - ln nu_m with Jacobian
// J_mi = g_mi / nu_m, through the normal equations JtJ d = Jt r.
__device__ __forceinline__ void log_step(float& a0, float& a1,
                                         const Moments& s, float ly0,
                                         float ly1, float smax, float lo,
                                         float hi) {
  const float n0 = fmaxf(s.nu0, 1e-35f), n1 = fmaxf(s.nu1, 1e-35f);
  const float j00 = s.g00 / n0, j01 = s.g01 / n0;
  const float j10 = s.g10 / n1, j11 = s.g11 / n1;
  const float r0 = fminf(fmaxf(ly0 - logf(n0), -30.0f), 30.0f);
  const float r1 = fminf(fmaxf(ly1 - logf(n1), -30.0f), 30.0f);
  float f0 = r0 * j00 + r1 * j10;
  float f1 = r0 * j01 + r1 * j11;
  float h00 = j00 * j00 + j10 * j10;
  float h01 = j00 * j01 + j10 * j11;
  float h11 = j01 * j01 + j11 * j11;
  // _solve_spd: normalise by max|H|; a dead Hessian takes a zero step
  const float m_raw = fmaxf(fmaxf(fabsf(h00), fabsf(h01)), fabsf(h11));
  const bool dead = m_raw < 1e-30f;
  const float m = dead ? 1.0f : m_raw;
  h00 /= m;
  h01 /= m;
  h11 /= m;
  f0 = dead ? 0.0f : f0 / m;
  f1 = dead ? 0.0f : f1 / m;
  float det = h00 * h11 - h01 * h01;
  if (fabsf(det) < 1e-30f) det = 1e-30f;
  float d0 = (h11 * f0 - h01 * f1) / det;
  float d1 = (h00 * f1 - h01 * f0) / det;
  // trust region
  const float norm = sqrtf(d0 * d0 + d1 * d1);
  const float sc = fminf(1.0f, smax / fmaxf(norm, 1e-30f));
  d0 *= sc;
  d1 *= sc;
  a0 = fminf(fmaxf(a0 - d0, lo), hi);
  a1 = fminf(fmaxf(a1 - d1, lo), hi);
}

// K3's per-pixel schedule on one pixel's raw counts (c0, c1), with the
// full and warm tables in shared memory; writes a[0..1] to out.
__device__ __forceinline__ void solve_pixel(
    float c0, float c1, const float* full, const float* warm, int e_full,
    int e_warm, int n_warm, int n_pol, int warm_bf16, float scale,
    float a_lo, float a_hi, float step_max, float eps_init, float clip,
    float* out) {
  const float y0 = c0 / scale;
  const float y1 = c1 / scale;
  const float ly0 = logf(fmaxf(y0, 1e-35f));
  const float ly1 = logf(fmaxf(y1, 1e-35f));
  const float lo = fmaxf(a_lo, -1.0f);
  const float smax = 10.0f * step_max;
  float a0 = eps_init, a1 = eps_init;
  for (int it = 0; it < n_warm; ++it) {
    const Moments s = warm_bf16 ? moments<true>(warm, e_warm, a0, a1, clip)
                                : moments<false>(warm, e_warm, a0, a1, clip);
    log_step(a0, a1, s, ly0, ly1, smax, lo, a_hi);
  }
  for (int it = 0; it < n_pol; ++it) {
    const Moments s = moments<false>(full, e_full, a0, a1, clip);
    log_step(a0, a1, s, ly0, ly1, smax, lo, a_hi);
  }
  out[0] = a0;
  out[1] = a1;
}

__global__ void gauss_newton_kernel(const float* __restrict__ counts,
                                    const float* __restrict__ tables,
                                    float* __restrict__ out, long long n_pix,
                                    int e_full, int e_warm, int n_warm,
                                    int n_pol, int warm_bf16, float scale,
                                    float a_lo, float a_hi, float step_max,
                                    float eps_init, float clip) {
  extern __shared__ float tab[];
  const int n_tab = kRow * (e_full + e_warm);
  for (int i = threadIdx.x; i < n_tab; i += blockDim.x) tab[i] = tables[i];
  __syncthreads();
  const long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  solve_pixel(counts[p], counts[n_pix + p], tab, tab + kRow * e_full, e_full,
              e_warm, n_warm, n_pol, warm_bf16, scale, a_lo, a_hi, step_max,
              eps_init, clip, out + 2 * p);
}

// counts [2, n_pix] in group order, n_pix a multiple of blockDim.x; block
// b solves group block_group[b] with tables + g * n_tab and scales[g].
__global__ void gauss_newton_grouped_kernel(
    const float* __restrict__ counts, const int* __restrict__ block_group,
    const float* __restrict__ scales, const float* __restrict__ tables,
    float* __restrict__ out, long long n_pix, int e_full, int e_warm,
    int n_warm, int n_pol, int warm_bf16, float a_lo, float a_hi,
    float step_max, float eps_init, float clip) {
  extern __shared__ float tab[];
  const int g = block_group[blockIdx.x];
  const int n_tab = kRow * (e_full + e_warm);
  const float* src = tables + (long long)g * n_tab;
  for (int i = threadIdx.x; i < n_tab; i += blockDim.x) tab[i] = src[i];
  __syncthreads();
  const long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  solve_pixel(counts[p], counts[n_pix + p], tab, tab + kRow * e_full, e_full,
              e_warm, n_warm, n_pol, warm_bf16, scales[g], a_lo, a_hi,
              step_max, eps_init, clip, out + 2 * p);
}

}  // namespace

extern "C" int dexct_gauss_newton(const void* counts, const void* tables,
                                  void* out, long long n_pix, int e_full,
                                  int e_warm, int n_warm, int n_pol,
                                  int warm_bf16, float scale, float a_lo,
                                  float a_hi, float step_max, float eps_init,
                                  float clip, void* stream) {
  if (n_pix <= 0) return (int)cudaGetLastError();
  const size_t shmem = sizeof(float) * kRow * (size_t)(e_full + e_warm);
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gauss_newton_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = 128;
  const long long blocks = (n_pix + threads - 1) / threads;
  gauss_newton_kernel<<<(unsigned)blocks, threads, shmem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(counts), static_cast<const float*>(tables),
      static_cast<float*>(out), n_pix, e_full, e_warm, n_warm, n_pol,
      warm_bf16, scale, a_lo, a_hi, step_max, eps_init, clip);
  return (int)cudaGetLastError();
}

extern "C" int dexct_gauss_newton_grouped(
    const void* counts, const void* block_group, const void* scales,
    const void* tables, void* out, long long n_pix, int block, int e_full,
    int e_warm, int n_warm, int n_pol, int warm_bf16, float a_lo, float a_hi,
    float step_max, float eps_init, float clip, void* stream) {
  if (n_pix <= 0) return (int)cudaGetLastError();
  if (block <= 0 || n_pix % block != 0) return (int)cudaErrorInvalidValue;
  const size_t shmem = sizeof(float) * kRow * (size_t)(e_full + e_warm);
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gauss_newton_grouped_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = n_pix / block;
  gauss_newton_grouped_kernel<<<(unsigned)blocks, block, shmem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(counts), static_cast<const int*>(block_group),
      static_cast<const float*>(scales), static_cast<const float*>(tables),
      static_cast<float*>(out), n_pix, e_full, e_warm, n_warm, n_pol,
      warm_bf16, a_lo, a_hi, step_max, eps_init, clip);
  return (int)cudaGetLastError();
}
