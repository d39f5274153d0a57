// K3 gauss_newton: per-pixel two-material Gauss-Newton decomposition.
//
// Replaces the TPU program dexct_tpu/ops/matdecomp.py:gauss_newton_solve
// -> _solve_block -> _solve_spd for M = K = 2 (two spectra, two basis
// materials).  The TPU form iterates all pixels at once as [B, E] x [E, k]
// matrix products, writing a [B, E] attenuation array to HBM every
// iteration.
//
// What bounds it on the card: instruction issue, not memory.  Each pixel
// reads two counts and writes two floats, but runs n_iters passes over
// the energy tables with one exp and 8 FMAs per (iteration, energy): ~21
// instructions a node that belong to the pixel (the exponent, its clamp,
// expf's range reduction and MUFU.EX2, six sums, in the bf16 phase the
// roundings) and ~7 that do not (the row's shared loads, loop control).
// Design: each thread solves kPix = 4 pixels at once and keeps their
// iterates, log counts and every iteration in registers; the energy tables
// sit in shared memory (rows of 8 floats: mu_0, mu_1, i0_0, i0_1, g_00,
// g_01, g_10, g_11; the full union grid for the polish, then the warm-phase
// table), each row read once for the thread's pixels in two 16-byte loads
// at the same address for the whole block (broadcast, no bank conflict),
// the node loop unrolled by kUnroll = 2; the pixels' exp chains are
// independent and hide each other's latency; in the bf16 phase two pixels'
// values round in one packed conversion.  The 2x2 system is solved in
// closed form per pixel.  No [B, E] array exists.  Every product, sum and
// contraction is written out as nvcc compiled the first K3 (one pixel a
// thread; its SASS), so a pixel's result is bit for bit that kernel's
// whatever P (tools/probe_k3_steps.py, K3_PINNED_SHA1).  A thread's slots
// past the last pixel solve its first pixel again and store nothing.
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
// per-pixel schedule (solve_pixels, shared with K3) at one pixel a thread.
// Bound and design are K3's: one exp and 8 FMAs per (iteration, energy).
//
// K35 gauss_newton_general: the general per-pixel Newton decomposition.
//
// Replaces the TPU program dexct_tpu/ops/matdecomp.py:gauss_newton_solve
// -> _solve_block -> _solve_spd for every case K3 does not take: K in
// {2, 3, 4} basis materials, M >= K measurements (the bins of a photon-
// counting detector), method "gn" or "newton", lm_damping, and a warm phase
// of log-residual or Poisson-MLE steps.  The TPU form iterates all pixels
// at once as [B, E] x [E, M + M K (+ M T)] matrix products.
//
// What bounds it: arithmetic, as K3.  Per (iteration, energy) a pixel
// forms its exponent (K FMAs), one exp, and M (1 + K) moment sums (plus
// M T Hessian weights with "newton", T = K (K + 1) / 2).  Design: K3's, one
// thread per pixel with every iteration in registers and the energy tables
// in shared memory, read at the same address by all threads.  A table row
// holds [mu_k (K), i0_m (M), g_mi = i0_m mu_i (M K), and with "newton"
// h_m,ij = i0_m mu_i mu_j (M T)] floats; the full grid for the polish, then
// the warm table (the log warm phase's moment-compressed nodes; rounded to
// bf16 by the wrapper when the warm phase runs in bf16).  The kernel is
// templated on K and on a compile-time maximum of M (4 or 8, the port's
// MAX_BINS), so the per-measurement accumulators are registers indexed by
// unrolled loops; at M = 8, K = 4 with "newton" that is 120 accumulators
// and the kernel spills.  The closed-form 2x2, 3x3 and 4x4 adjugate solves
// follow the JAX package's cofactor expressions with every operation
// rounded on its own (__fmul_rn, __fadd_rn): the 4x4 determinant cancels
// heavily, and FMA contraction would move its rounding away from the plain
// version's.  The schedule, floors, clamps and trust regions are
// _solve_block's: log steps floor nu at 1e-35 and use 10 x step_max and the
// lower clamp max(a_lo, -1); MLE steps floor nu at 1e-17 and use step_max
// and a_lo; lm_damping scales the Hessian's diagonal by 1 + lm_damping.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRow = 8;
// K3's launch: threads a block, pixels a thread (P) and how far the node
// loop is unrolled (U); P = 4, U = 2 were the fastest of P in {1, 2, 4}
// and U in {1, 2, 4} at the paths' shapes (tools/probe_k3_steps.py)
constexpr int kThreads = 128;
constexpr int kPix = 4;
constexpr int kUnroll = 2;

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// lo and hi each rounded to bf16 as bf16r rounds it, by one packed
// conversion; the halves are unpacked with a shift and a mask
__device__ __forceinline__ void bf16r_pair(float& lo, float& hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  const unsigned int u = *reinterpret_cast<const unsigned int*>(&h);
  lo = __uint_as_float(u << 16);
  hi = __uint_as_float(u & 0xffff0000u);
}

// x[0..P) each rounded to bf16 as bf16r rounds it, two values to a
// packed conversion
template <int P>
__device__ __forceinline__ void bf16r_all(float (&x)[P]) {
#pragma unroll
  for (int p = 0; p + 1 < P; p += 2) bf16r_pair(x[p], x[p + 1]);
  if (P % 2) x[P - 1] = bf16r(x[P - 1]);
}

struct Moments {
  float nu0, nu1, g00, g01, g10, g11;
};

// One table row (two 16-byte shared loads: mu_0, mu_1, i0_0, i0_1, then
// g_00, g_01, g_10, g_11) added into the sums of P pixels at their
// iterates (b0, b1), already rounded to bf16 in a bf16 phase.  The
// operations are the first K3's, contraction for contraction (its SASS):
// the exponent fma(a0, mu0, a1 * mu1), the sums fma(at, w, s).
template <int P, bool kBf16>
__device__ __forceinline__ void add_row(const float4* row,
                                        const float (&b0)[P],
                                        const float (&b1)[P], float clip,
                                        Moments (&s)[P]) {
  const float4 mi = row[0];
  const float4 g = row[1];
  float L[P], at[P];
#pragma unroll
  for (int p = 0; p < P; ++p)
    L[p] = __fmaf_rn(b0[p], mi.x, __fmul_rn(b1[p], mi.y));
  if (kBf16) bf16r_all(L);
#pragma unroll
  for (int p = 0; p < P; ++p) at[p] = expf(fminf(fmaxf(-L[p], -clip), 20.0f));
  if (kBf16) bf16r_all(at);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    s[p].nu0 = __fmaf_rn(at[p], mi.z, s[p].nu0);
    s[p].nu1 = __fmaf_rn(at[p], mi.w, s[p].nu1);
    s[p].g00 = __fmaf_rn(at[p], g.x, s[p].g00);
    s[p].g01 = __fmaf_rn(at[p], g.y, s[p].g01);
    s[p].g10 = __fmaf_rn(at[p], g.z, s[p].g10);
    s[p].g11 = __fmaf_rn(at[p], g.w, s[p].g11);
  }
}

// The six energy sums of P pixels at their iterates over the n rows of a
// table in shared memory, in row order; each row is read once for all P
// pixels, U rows to a pass of the loop.
template <int P, int U, bool kBf16>
__device__ __forceinline__ void moments(const float4* tab, int n,
                                        const float (&a0)[P],
                                        const float (&a1)[P], float clip,
                                        Moments (&s)[P]) {
  float b0[P], b1[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    b0[p] = a0[p];
    b1[p] = a1[p];
    if (kBf16) bf16r_pair(b0[p], b1[p]);  // the iterate as the phase sees it
    s[p] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  }
  const float4* row = tab;
  for (const float4* end = tab + 2 * (n - n % U); row != end; row += 2 * U) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      add_row<P, kBf16>(row + 2 * u, b0, b1, clip, s);
  }
  for (const float4* end = tab + 2 * n; row != end; row += 2)
    add_row<P, kBf16>(row, b0, b1, clip, s);
}

// Newton step on the log residuals r_m = ln y_m - ln nu_m with Jacobian
// J_mi = g_mi / nu_m, through the normal equations JtJ d = Jt r; each
// product and sum as the first K3 contracted it (its SASS).
__device__ __forceinline__ void log_step(float& a0, float& a1,
                                         const Moments& s, float ly0,
                                         float ly1, float smax, float lo,
                                         float hi) {
  const float n0 = fmaxf(s.nu0, 1e-35f), n1 = fmaxf(s.nu1, 1e-35f);
  const float j00 = s.g00 / n0, j01 = s.g01 / n0;
  const float j10 = s.g10 / n1, j11 = s.g11 / n1;
  const float r0 = fminf(fmaxf(__fsub_rn(ly0, logf(n0)), -30.0f), 30.0f);
  const float r1 = fminf(fmaxf(__fsub_rn(ly1, logf(n1)), -30.0f), 30.0f);
  float f0 = __fmaf_rn(r0, j00, __fmul_rn(r1, j10));
  float f1 = __fmaf_rn(r0, j01, __fmul_rn(r1, j11));
  float h00 = __fmaf_rn(j00, j00, __fmul_rn(j10, j10));
  float h01 = __fmaf_rn(j00, j01, __fmul_rn(j10, j11));
  float h11 = __fmaf_rn(j01, j01, __fmul_rn(j11, j11));
  // _solve_spd: normalise by max|H|; a dead Hessian takes a zero step
  const float m_raw = fmaxf(fmaxf(fabsf(h00), fabsf(h01)), fabsf(h11));
  const bool dead = m_raw < 1e-30f;
  const float m = dead ? 1.0f : m_raw;
  h00 /= m;
  h01 /= m;
  h11 /= m;
  f0 = dead ? 0.0f : f0 / m;
  f1 = dead ? 0.0f : f1 / m;
  float det = __fmaf_rn(h00, h11, -__fmul_rn(h01, h01));
  if (fabsf(det) < 1e-30f) det = 1e-30f;
  const float d0 = __fmaf_rn(h11, f0, -__fmul_rn(h01, f1)) / det;
  const float d1 = __fmaf_rn(h00, f1, -__fmul_rn(h01, f0)) / det;
  // trust region
  const float norm = sqrtf(__fmaf_rn(d0, d0, __fmul_rn(d1, d1)));
  const float sc = fminf(1.0f, smax / fmaxf(norm, 1e-30f));
  a0 = fminf(fmaxf(__fmaf_rn(-d0, sc, a0), lo), hi);
  a1 = fminf(fmaxf(__fmaf_rn(-d1, sc, a1), lo), hi);
}

// K3's per-pixel schedule on P pixels' raw counts (c0, c1) at once, with
// the full and warm tables in shared memory; each pixel's arithmetic is
// the one-pixel schedule's, so its result does not depend on P.
template <int P, int U>
__device__ __forceinline__ void solve_pixels(
    const float (&c0)[P], const float (&c1)[P], const float4* full,
    const float4* warm, int e_full, int e_warm, int n_warm, int n_pol,
    int warm_bf16, float scale, float a_lo, float a_hi, float step_max,
    float eps_init, float clip, float (&a0)[P], float (&a1)[P]) {
  float ly0[P], ly1[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    ly0[p] = logf(fmaxf(c0[p] / scale, 1e-35f));
    ly1[p] = logf(fmaxf(c1[p] / scale, 1e-35f));
    a0[p] = eps_init;
    a1[p] = eps_init;
  }
  const float lo = fmaxf(a_lo, -1.0f);
  const float smax = 10.0f * step_max;
  Moments s[P];
  for (int it = 0; it < n_warm; ++it) {
    if (warm_bf16)
      moments<P, U, true>(warm, e_warm, a0, a1, clip, s);
    else
      moments<P, U, false>(warm, e_warm, a0, a1, clip, s);
#pragma unroll
    for (int p = 0; p < P; ++p)
      log_step(a0[p], a1[p], s[p], ly0[p], ly1[p], smax, lo, a_hi);
  }
  for (int it = 0; it < n_pol; ++it) {
    moments<P, U, false>(full, e_full, a0, a1, clip, s);
#pragma unroll
    for (int p = 0; p < P; ++p)
      log_step(a0[p], a1[p], s[p], ly0[p], ly1[p], smax, lo, a_hi);
  }
}

// The table rows of ``src`` (n_tab float4s, 16-byte aligned) into shared
// memory.
__device__ __forceinline__ void stage_table(float4* tab,
                                            const float4* __restrict__ src,
                                            int n_tab) {
  for (int i = threadIdx.x; i < n_tab; i += blockDim.x) tab[i] = src[i];
  __syncthreads();
}

// counts [2, n_pix]; tables: the full rows, then the warm rows (16-byte
// aligned); scale: the count scale, one float on the card (read, never
// copied to the host); out [n_pix, 2].  Block b, thread t solves pixels
// b * kThreads * P + t + p * kThreads, p < P; a slot past the last pixel
// solves the thread's first pixel again and stores nothing.
template <int P, int U>
__global__ void __launch_bounds__(kThreads) gauss_newton_kernel(
    const float* __restrict__ counts, const float4* __restrict__ tables,
    const float* __restrict__ scale, float2* __restrict__ out,
    long long n_pix, int e_full, int e_warm, int n_warm, int n_pol,
    int warm_bf16, float a_lo, float a_hi, float step_max, float eps_init,
    float clip) {
  extern __shared__ float4 k3_tab[];
  stage_table(k3_tab, tables, 2 * (e_full + e_warm));
  const long long first =
      blockIdx.x * (long long)(kThreads * P) + threadIdx.x;
  if (first >= n_pix) return;
  float c0[P], c1[P], a0[P], a1[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const long long q = first + (long long)p * kThreads;
    const long long r = q < n_pix ? q : first;
    c0[p] = counts[r];
    c1[p] = counts[n_pix + r];
  }
  solve_pixels<P, U>(c0, c1, k3_tab, k3_tab + 2 * e_full, e_full, e_warm,
                     n_warm, n_pol, warm_bf16, __ldg(scale), a_lo, a_hi,
                     step_max, eps_init, clip, a0, a1);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const long long q = first + (long long)p * kThreads;
    if (q < n_pix) out[q] = make_float2(a0[p], a1[p]);
  }
}

// counts [2, n_pix] in group order, n_pix a multiple of blockDim.x; block
// b solves group block_group[b] with tables + g * n_tab and scales[g],
// one pixel a thread (K3's body at P = 1, U = 1: nvcc unrolls the node
// loop by 2 itself; the fastest at P = 1, tools/probe_k3_steps.py).
__global__ void gauss_newton_grouped_kernel(
    const float* __restrict__ counts, const int* __restrict__ block_group,
    const float* __restrict__ scales, const float4* __restrict__ tables,
    float2* __restrict__ out, long long n_pix, int e_full, int e_warm,
    int n_warm, int n_pol, int warm_bf16, float a_lo, float a_hi,
    float step_max, float eps_init, float clip) {
  extern __shared__ float4 k29_tab[];
  const int g = block_group[blockIdx.x];
  const int n_tab = 2 * (e_full + e_warm);
  stage_table(k29_tab, tables + (long long)g * n_tab, n_tab);
  const long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  const float c0[1] = {counts[p]}, c1[1] = {counts[n_pix + p]};
  float a0[1], a1[1];
  solve_pixels<1, 1>(c0, c1, k29_tab, k29_tab + 2 * e_full, e_full, e_warm,
                     n_warm, n_pol, warm_bf16, scales[g], a_lo, a_hi,
                     step_max, eps_init, clip, a0, a1);
  out[p] = make_float2(a0[0], a1[0]);
}

// K3 at P pixels a thread and the node loop unrolled by U (the library's
// entry takes kPix, kUnroll)
template <int P, int U>
int launch_gauss_newton(const float* counts, const float4* tables,
                        const float* scale, float2* out, long long n_pix,
                        int e_full, int e_warm, int n_warm, int n_pol,
                        int warm_bf16, float a_lo, float a_hi,
                        float step_max, float eps_init, float clip,
                        cudaStream_t stream) {
  const size_t shmem = sizeof(float) * kRow * (size_t)(e_full + e_warm);
  auto kernel = gauss_newton_kernel<P, U>;
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long per_block = (long long)kThreads * P;
  const long long blocks = (n_pix + per_block - 1) / per_block;
  kernel<<<(unsigned)blocks, kThreads, shmem, stream>>>(
      counts, tables, scale, out, n_pix, e_full, e_warm, n_warm, n_pol,
      warm_bf16, a_lo, a_hi, step_max, eps_init, clip);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

// ---- K35 ------------------------------------------------------------------

__device__ __forceinline__ float rmul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float radd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float rsub(float a, float b) {
  return __fsub_rn(a, b);
}

template <int K>
struct Tri {
  static constexpr int T = K * (K + 1) / 2;
};

// _solve_spd: normalise H (upper triangle, row order) and dF by max|H|, a
// dead Hessian takes a zero step, then the closed-form adjugate solve in
// the JAX package's cofactor expressions.
template <int K>
__device__ __forceinline__ void solve_spd(float* H, float* f, float* x) {
  constexpr int T = Tri<K>::T;
  float m_raw = 0.0f;
#pragma unroll
  for (int t = 0; t < T; ++t) m_raw = fmaxf(m_raw, fabsf(H[t]));
  const bool dead = m_raw < 1e-30f;
  const float m = dead ? 1.0f : m_raw;
#pragma unroll
  for (int t = 0; t < T; ++t) H[t] = H[t] / m;
#pragma unroll
  for (int k = 0; k < K; ++k) f[k] = dead ? 0.0f : f[k] / m;
  if constexpr (K == 2) {
    const float H00 = H[0], H01 = H[1], H11 = H[2];
    float det = rsub(rmul(H00, H11), rmul(H01, H01));
    if (fabsf(det) < 1e-30f) det = 1e-30f;
    x[0] = rsub(rmul(H11, f[0]), rmul(H01, f[1])) / det;
    x[1] = rsub(rmul(H00, f[1]), rmul(H01, f[0])) / det;
  } else if constexpr (K == 3) {
    // H = [[a, b, c], [b, d, e], [c, e, f]]
    const float a = H[0], b = H[1], c = H[2], d = H[3], e = H[4], ff = H[5];
    const float A00 = rsub(rmul(d, ff), rmul(e, e));
    const float A01 = rsub(rmul(c, e), rmul(b, ff));
    const float A02 = rsub(rmul(b, e), rmul(c, d));
    const float A11 = rsub(rmul(a, ff), rmul(c, c));
    const float A12 = rsub(rmul(b, c), rmul(a, e));
    const float A22 = rsub(rmul(a, d), rmul(b, b));
    float det = radd(radd(rmul(a, A00), rmul(b, A01)), rmul(c, A02));
    if (fabsf(det) < 1e-30f) det = 1e-30f;
    x[0] = radd(radd(rmul(A00, f[0]), rmul(A01, f[1])), rmul(A02, f[2])) /
           det;
    x[1] = radd(radd(rmul(A01, f[0]), rmul(A11, f[1])), rmul(A12, f[2])) /
           det;
    x[2] = radd(radd(rmul(A02, f[0]), rmul(A12, f[1])), rmul(A22, f[2])) /
           det;
  } else {
    // H = [[a, b, c, d], [b, e, f, g], [c, f, h, i], [d, g, i, j]]
    const float a = H[0], b = H[1], c = H[2], d = H[3], e = H[4], ff = H[5],
                g = H[6], h = H[7], i = H[8], j = H[9];
    // the 2x2 minors of the cofactors, each as the JAX expression writes
    // it (x * y - z * w)
    const float hj_ii = rsub(rmul(h, j), rmul(i, i));
    const float fj_gi = rsub(rmul(ff, j), rmul(g, i));
    const float fi_gh = rsub(rmul(ff, i), rmul(g, h));
    const float cj_id = rsub(rmul(c, j), rmul(i, d));
    const float ci_hd = rsub(rmul(c, i), rmul(h, d));
    const float fj_ig = rsub(rmul(ff, j), rmul(i, g));
    const float cg_fd = rsub(rmul(c, g), rmul(ff, d));
    const float fi_hg = rsub(rmul(ff, i), rmul(h, g));
    const float ej_gg = rsub(rmul(e, j), rmul(g, g));
    const float bj_gd = rsub(rmul(b, j), rmul(g, d));
    const float bg_ed = rsub(rmul(b, g), rmul(e, d));
    const float ei_fg = rsub(rmul(e, i), rmul(ff, g));
    const float bi_fd = rsub(rmul(b, i), rmul(ff, d));
    const float eh_ff = rsub(rmul(e, h), rmul(ff, ff));
    const float bh_fc = rsub(rmul(b, h), rmul(ff, c));
    const float bf_ec = rsub(rmul(b, ff), rmul(e, c));
    const float A00 =
        radd(rsub(rmul(e, hj_ii), rmul(ff, fj_gi)), rmul(g, fi_gh));
    const float A01 =
        -radd(rsub(rmul(b, hj_ii), rmul(ff, cj_id)), rmul(g, ci_hd));
    const float A02 =
        radd(rsub(rmul(b, fj_ig), rmul(e, cj_id)), rmul(g, cg_fd));
    const float A03 =
        -radd(rsub(rmul(b, fi_hg), rmul(e, ci_hd)), rmul(ff, cg_fd));
    const float A11 =
        radd(rsub(rmul(a, hj_ii), rmul(c, cj_id)), rmul(d, ci_hd));
    const float A12 =
        -radd(rsub(rmul(a, fj_ig), rmul(b, cj_id)), rmul(d, cg_fd));
    const float A13 =
        radd(rsub(rmul(a, fi_hg), rmul(b, ci_hd)), rmul(c, cg_fd));
    const float A22 =
        radd(rsub(rmul(a, ej_gg), rmul(b, bj_gd)), rmul(d, bg_ed));
    const float A23 =
        -radd(rsub(rmul(a, ei_fg), rmul(b, bi_fd)), rmul(c, bg_ed));
    const float A33 =
        radd(rsub(rmul(a, eh_ff), rmul(b, bh_fc)), rmul(c, bf_ec));
    float det = radd(radd(radd(rmul(a, A00), rmul(b, A01)), rmul(c, A02)),
                     rmul(d, A03));
    if (fabsf(det) < 1e-30f) det = 1e-30f;
    x[0] = radd(radd(radd(rmul(A00, f[0]), rmul(A01, f[1])),
                     rmul(A02, f[2])), rmul(A03, f[3])) / det;
    x[1] = radd(radd(radd(rmul(A01, f[0]), rmul(A11, f[1])),
                     rmul(A12, f[2])), rmul(A13, f[3])) / det;
    x[2] = radd(radd(radd(rmul(A02, f[0]), rmul(A12, f[1])),
                     rmul(A22, f[2])), rmul(A23, f[3])) / det;
    x[3] = radd(radd(radd(rmul(A03, f[0]), rmul(A13, f[1])),
                     rmul(A23, f[2])), rmul(A33, f[3])) / det;
  }
}

// The energy sums at iterate a over n rows of the table: nu[m], g[m][i]
// and, with kHess, h[m][t].  Rounded as the plain version rounds them: the
// exponent is the K products summed in order, each operation rounded on
// its own; in float32 steps the attenuation is the float64 exp of that
// exponent and the sums are float64 (rounded to float32 by the caller);
// in bf16 steps the iterate, the exponent and the attenuation are bf16
// values.  The 4x4 Poisson-MLE step amplifies any difference in these
// sums on the hardest rays, so the kernel keeps them to the plain
// version's own rounding.
template <int K, int MAXM, bool kHess, bool kBf16>
__device__ __forceinline__ void moments_general(
    const float* tab, int n, int row, int M, const float* a_in, double* nu,
    double (*g)[K], double (*h)[Tri<K>::T], float clip) {
  constexpr int T = Tri<K>::T;
  float a[K];
#pragma unroll
  for (int k = 0; k < K; ++k) a[k] = kBf16 ? bf16r(a_in[k]) : a_in[k];
#pragma unroll
  for (int m = 0; m < MAXM; ++m) {
    nu[m] = 0.0;
#pragma unroll
    for (int i = 0; i < K; ++i) g[m][i] = 0.0;
    if (kHess) {
#pragma unroll
      for (int t = 0; t < T; ++t) h[m][t] = 0.0;
    }
  }
  const int o_i0 = K, o_g = K + M, o_h = K + M + M * K;
  for (int e = 0; e < n; ++e) {
    const float* r = tab + row * e;
    float L = rmul(a[0], r[0]);
#pragma unroll
    for (int k = 1; k < K; ++k) L = radd(L, rmul(a[k], r[k]));
    double at;
    if (kBf16) {
      L = bf16r(L);
      at = bf16r(expf(fminf(fmaxf(-L, -clip), 20.0f)));
    } else {
      at = exp((double)fminf(fmaxf(-L, -clip), 20.0f));
    }
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      if (m < M) {
        nu[m] += at * r[o_i0 + m];
#pragma unroll
        for (int i = 0; i < K; ++i) g[m][i] += at * r[o_g + m * K + i];
        if (kHess) {
#pragma unroll
          for (int t = 0; t < T; ++t) h[m][t] += at * r[o_h + m * T + t];
        }
      }
    }
  }
}

// One Newton step of _solve_block's _gn_body from the moments: the log
// residual step (log_step) or the Poisson-MLE step (Fisher scoring, or with
// kNewton the full Newton Hessian); then lm_damping, the solve, the trust
// region and the clamps.
template <int K, int MAXM, bool kNewton>
__device__ __forceinline__ void step_general(
    float* a, const double* nu, double (*g)[K], double (*h)[Tri<K>::T],
    const float* y, const float* ly, int M, bool log_step, float lm,
    float step_max, float a_lo, float a_hi) {
  constexpr int T = Tri<K>::T;
  float dF[K], H[T];
#pragma unroll
  for (int i = 0; i < K; ++i) dF[i] = 0.0f;
#pragma unroll
  for (int t = 0; t < T; ++t) H[t] = 0.0f;
  if (log_step) {
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      if (m < M) {
        const float n = fmaxf((float)nu[m], 1e-35f);
        const float r =
            fminf(fmaxf(ly[m] - (float)log((double)n), -30.0f), 30.0f);
        float J[K];
#pragma unroll
        for (int i = 0; i < K; ++i) J[i] = (float)g[m][i] / n;
#pragma unroll
        for (int i = 0; i < K; ++i) dF[i] = radd(dF[i], rmul(r, J[i]));
        int t = 0;
#pragma unroll
        for (int i = 0; i < K; ++i) {
#pragma unroll
          for (int j = i; j < K; ++j, ++t) H[t] = radd(H[t], rmul(J[i], J[j]));
        }
      }
    }
  } else {
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      if (m < M) {
        const float n = fmaxf((float)nu[m], 1e-17f);
        const float r = y[m] / n - 1.0f;
        const float yv2 = y[m] / rmul(n, n);
        float gm[K];
#pragma unroll
        for (int i = 0; i < K; ++i) gm[i] = (float)g[m][i];
#pragma unroll
        for (int i = 0; i < K; ++i) dF[i] = radd(dF[i], rmul(r, gm[i]));
        int t = 0;
#pragma unroll
        for (int i = 0; i < K; ++i) {
#pragma unroll
          for (int j = i; j < K; ++j, ++t) {
            const float gg = rmul(gm[i], gm[j]);
            if (kNewton)
              H[t] = radd(H[t], rsub(rmul(r, (float)h[m][t]),
                                     rmul(yv2, gg)));
            else
              H[t] = radd(H[t], rmul(yv2, gg));
          }
        }
      }
    }
    if (kNewton) {
#pragma unroll
      for (int t = 0; t < T; ++t) H[t] = -H[t];
    }
  }
  if (lm != 0.0f) {
    // Levenberg-Marquardt: the diagonal entries sit at 0, K, 2K - 1, ...
    int t = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      H[t] = rmul(H[t], 1.0f + lm);
      t += K - i;
    }
  }
  float d[K];
  solve_spd<K>(H, dF, d);
  // trust region, then the bounds
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) ss = radd(ss, rmul(d[k], d[k]));
  const float smax = log_step ? 10.0f * step_max : step_max;
  const float sc =
      fminf(1.0f, smax / fmaxf((float)sqrt((double)ss), 1e-30f));
  const float lo = log_step ? fmaxf(a_lo, -1.0f) : a_lo;
#pragma unroll
  for (int k = 0; k < K; ++k)
    a[k] = fminf(fmaxf(rsub(a[k], rmul(d[k], sc)), lo), a_hi);
}

struct GeneralArgs {
  long long n_pix;
  int M, e_full, e_warm, n_warm, n_pol, warm_bf16, warm_log, polish_log;
  float lm, a_lo, a_hi, step_max, eps_init, clip;
};

// counts [M, n_pix]; tables: the full rows, then the warm rows; scale:
// the count scale, one float on the card; out [n_pix, K].
template <int K, int MAXM, bool kNewton>
__global__ void gauss_newton_general_kernel(const float* __restrict__ counts,
                                            const float* __restrict__ tables,
                                            const float* __restrict__ scale,
                                            float* __restrict__ out,
                                            GeneralArgs p) {
  constexpr int T = Tri<K>::T;
  extern __shared__ float tab[];
  const int M = p.M;
  const int row = K + M * (1 + K) + (kNewton ? M * T : 0);
  const int n_tab = row * (p.e_full + p.e_warm);
  for (int i = threadIdx.x; i < n_tab; i += blockDim.x) tab[i] = tables[i];
  __syncthreads();
  const long long px = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (px >= p.n_pix) return;
  const float* full = tab;
  const float* warm = tab + row * p.e_full;
  const float sc = __ldg(scale);
  float y[MAXM], ly[MAXM];
#pragma unroll
  for (int m = 0; m < MAXM; ++m) {
    y[m] = m < M ? counts[m * p.n_pix + px] / sc : 0.0f;
    ly[m] = (float)log((double)fmaxf(y[m], 1e-35f));
  }
  float a[K];
#pragma unroll
  for (int k = 0; k < K; ++k) a[k] = p.eps_init;
  double nu[MAXM], g[MAXM][K], h[kNewton ? MAXM : 1][T];
  for (int it = 0; it < p.n_warm; ++it) {
    if (p.warm_bf16)
      moments_general<K, MAXM, kNewton, true>(warm, p.e_warm, row, M, a, nu,
                                              g, h, p.clip);
    else
      moments_general<K, MAXM, kNewton, false>(warm, p.e_warm, row, M, a, nu,
                                               g, h, p.clip);
    step_general<K, MAXM, kNewton>(a, nu, g, h, y, ly, M, p.warm_log != 0,
                                   p.lm, p.step_max, p.a_lo, p.a_hi);
  }
  for (int it = 0; it < p.n_pol; ++it) {
    moments_general<K, MAXM, kNewton, false>(full, p.e_full, row, M, a, nu,
                                             g, h, p.clip);
    step_general<K, MAXM, kNewton>(a, nu, g, h, y, ly, M, p.polish_log != 0,
                                   p.lm, p.step_max, p.a_lo, p.a_hi);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) out[px * K + k] = a[k];
}

template <int K, int MAXM, bool kNewton>
int launch_general(const float* counts, const float* tables,
                   const float* scale, float* out, const GeneralArgs& p,
                   cudaStream_t stream) {
  constexpr int T = Tri<K>::T;
  const int row = K + p.M * (1 + K) + (kNewton ? p.M * T : 0);
  const size_t shmem = sizeof(float) * row * (size_t)(p.e_full + p.e_warm);
  auto kernel = gauss_newton_general_kernel<K, MAXM, kNewton>;
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = 128;
  const long long blocks = (p.n_pix + threads - 1) / threads;
  kernel<<<(unsigned)blocks, threads, shmem, stream>>>(counts, tables,
                                                       scale, out, p);
  return (int)cudaGetLastError();
}

template <int K>
int dispatch_general(const float* counts, const float* tables,
                     const float* scale, float* out, const GeneralArgs& p,
                     int newton, cudaStream_t stream) {
  if (p.M <= 4) {
    return newton ? launch_general<K, 4, true>(counts, tables, scale, out, p,
                                               stream)
                  : launch_general<K, 4, false>(counts, tables, scale, out,
                                                p, stream);
  }
  return newton ? launch_general<K, 8, true>(counts, tables, scale, out, p,
                                             stream)
                : launch_general<K, 8, false>(counts, tables, scale, out, p,
                                              stream);
}

}  // namespace

// scale: a pointer to the count scale on the card; tables 16-byte aligned
extern "C" int dexct_gauss_newton(const void* counts, const void* tables,
                                  const void* scale, void* out,
                                  long long n_pix, int e_full, int e_warm,
                                  int n_warm, int n_pol, int warm_bf16,
                                  float a_lo, float a_hi, float step_max,
                                  float eps_init, float clip, void* stream) {
  if (n_pix <= 0) return (int)cudaGetLastError();
  if (!aligned16(tables)) return (int)cudaErrorMisalignedAddress;
  return launch_gauss_newton<kPix, kUnroll>(
      static_cast<const float*>(counts), static_cast<const float4*>(tables),
      static_cast<const float*>(scale), static_cast<float2*>(out), n_pix,
      e_full, e_warm, n_warm, n_pol, warm_bf16, a_lo, a_hi, step_max,
      eps_init, clip, static_cast<cudaStream_t>(stream));
}

// tables: G groups' tables, 16-byte aligned
extern "C" int dexct_gauss_newton_grouped(
    const void* counts, const void* block_group, const void* scales,
    const void* tables, void* out, long long n_pix, int block, int e_full,
    int e_warm, int n_warm, int n_pol, int warm_bf16, float a_lo, float a_hi,
    float step_max, float eps_init, float clip, void* stream) {
  if (n_pix <= 0) return (int)cudaGetLastError();
  if (block <= 0 || n_pix % block != 0) return (int)cudaErrorInvalidValue;
  if (!aligned16(tables)) return (int)cudaErrorMisalignedAddress;
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
      static_cast<const float*>(scales), static_cast<const float4*>(tables),
      static_cast<float2*>(out), n_pix, e_full, e_warm, n_warm, n_pol,
      warm_bf16, a_lo, a_hi, step_max, eps_init, clip);
  return (int)cudaGetLastError();
}

// scale: a pointer to the count scale on the card
extern "C" int dexct_gauss_newton_general(
    const void* counts, const void* tables, const void* scale, void* out,
    long long n_pix, int n_meas, int n_mats, int newton, int e_full,
    int e_warm, int n_warm, int n_pol, int warm_bf16, int warm_log,
    int polish_log, float lm_damping, float a_lo, float a_hi, float step_max,
    float eps_init, float clip, void* stream) {
  if (n_pix <= 0) return (int)cudaGetLastError();
  if (n_meas < n_mats || n_meas > 8) return (int)cudaErrorInvalidValue;
  GeneralArgs p;
  p.n_pix = n_pix;
  p.M = n_meas;
  p.e_full = e_full;
  p.e_warm = e_warm;
  p.n_warm = n_warm;
  p.n_pol = n_pol;
  p.warm_bf16 = warm_bf16;
  p.warm_log = warm_log;
  p.polish_log = polish_log;
  p.lm = lm_damping;
  p.a_lo = a_lo;
  p.a_hi = a_hi;
  p.step_max = step_max;
  p.eps_init = eps_init;
  p.clip = clip;
  const float* c = static_cast<const float*>(counts);
  const float* t = static_cast<const float*>(tables);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_mats) {
    case 2:
      return dispatch_general<2>(c, t, sc, o, p, newton, st);
    case 3:
      return dispatch_general<3>(c, t, sc, o, p, newton, st);
    case 4:
      return dispatch_general<4>(c, t, sc, o, p, newton, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
