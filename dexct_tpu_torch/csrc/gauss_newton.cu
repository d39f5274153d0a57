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
// What bounds it: arithmetic in float64.  Per (iteration, energy) a pixel
// forms its exponent (K float products), one exp, and M (1 + K) float64
// moment sums (plus M T Hessian weights with "newton", T = K (K + 1) / 2):
// the sums stay float64 to keep the plain version's rounding (the 4x4 MLE
// polish is chaotic on the hardest rays).  Summed from a float table,
// every weight would be converted to a double per pixel and table node
// (F2F.F64.F32, 16 a clock per SM against the DFMAs' 64), at four times
// the sums' cost.  Design: the wrapper casts the table to float64 once
// (exact), and each block stages a phase's rows in shared
// memory before that phase's steps (the warm table, then the full grid),
// the sums' weights as doubles and the exponent's mu_k as floats, every row
// read at the same address by all threads (broadcast) in 16-byte loads, so
// a pixel-node costs its DFMAs and the one conversion of its attenuation.
// A phase larger than a block's shared memory is staged in chunks of rows,
// every pass walking them in row order.  One thread solves one pixel with
// every iteration in registers, the registers left to ptxas.
// tools/probe_k35.py --steps measured the alternatives at the paths' shapes:
// 2 pixels a thread, 2 or 4 lanes sharing each row, 4 or 5 blocks an SM
// (128 or 102 registers) and weights read from the card's memory were all
// slower.  A table row holds [mu_k (K), i0_m (M), g_mi =
// i0_m mu_i (M K), and with "newton" h_m,ij = i0_m mu_i mu_j (M T)]; the
// full grid for the polish, then the warm table (the log warm phase's
// moment-compressed nodes; rounded to bf16 by the wrapper when the warm
// phase runs in bf16).  The kernel is templated on K and on M itself at the
// paths' shapes (M = 6 with K = 4, M = 4 with K = 2), else on a maximum M
// of 4 or 8 (the port's MAX_BINS) with the sums of the measurements past M
// skipped, so the per-measurement accumulators are registers indexed by
// unrolled loops; at M = 8, K = 4 with "newton" that is 120 accumulators
// and the kernel spills.  The closed-form 2x2, 3x3 and 4x4 adjugate solves
// follow the JAX package's cofactor expressions with every operation
// rounded on its own (__fmul_rn, __fadd_rn): the 4x4 determinant cancels
// heavily, and FMA contraction would move its rounding away from the plain
// version's.  The schedule, floors, clamps and trust regions are
// _solve_block's: log steps floor nu at 1e-35 and use 10 x step_max and the
// lower clamp max(a_lo, -1); MLE steps floor nu at 1e-17 and use step_max
// and a_lo; lm_damping scales the Hessian's diagonal by 1 + lm_damping.
// Every sum is the fma(at, w, s) the first K35 compiled to, so the output
// is that kernel's bit for bit (K35_PINNED_SHA1, K35_PATH_SHA1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

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

// K35's threads a block
constexpr int kThreads35 = 128;

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

// The sums of one pixel in shared memory's column order: nu_m at [0, MAXM),
// g_mi at MAXM + m K + i, and with kHess h_m,t at MAXM (1 + K) + m T + t.
// W is even, so that a row is read in 16-byte loads.
template <int K, int MAXM, bool kHess>
struct Cols {
  static constexpr int G = MAXM;
  static constexpr int H = MAXM * (1 + K);
  static constexpr int W = H + (kHess ? MAXM * Tri<K>::T : 0);
  static_assert(W % 2 == 0, "a row of an odd number of sums");
  // the measurement whose sum column j holds
  static constexpr __host__ __device__ int meas(int j) {
    return j < G ? j : j < H ? (j - G) / K : (j - H) / Tri<K>::T;
  }
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

// The K exponent coefficients of one table row (mu_k, float)
template <int K>
__device__ __forceinline__ void load_mu(const float* mu, float (&m)[K]) {
  if constexpr (K == 4) {
    const float4 v = *reinterpret_cast<const float4*>(mu);
    m[0] = v.x, m[1] = v.y, m[2] = v.z, m[3] = v.w;
  } else if constexpr (K == 2) {
    const float2 v = *reinterpret_cast<const float2*>(mu);
    m[0] = v.x, m[1] = v.y;
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) m[k] = mu[k];
  }
}

// A pixel's attenuation at one table row, at its iterate b (already
// rounded to bf16 in a bf16 step), rounded as the plain version rounds it:
// the exponent is the K products summed in order, each operation rounded
// on its own; in float32 steps the attenuation is the float64 exp of that
// exponent; in bf16 steps the exponent and the attenuation are bf16 values.
template <int K, bool kBf16>
__device__ __forceinline__ double attenuation(const float (&b)[K],
                                              const float* mu, float clip) {
  float m[K];
  load_mu<K>(mu, m);
  float L = rmul(b[0], m[0]);
#pragma unroll
  for (int k = 1; k < K; ++k) L = radd(L, rmul(b[k], m[k]));
  if (kBf16) {
    L = bf16r(L);
    return bf16r(expf(fminf(fmaxf(-L, -clip), 20.0f)));
  }
  return exp((double)fminf(fmaxf(-L, -clip), 20.0f));
}

// n table rows added in row order into one pixel's sums s at its iterate
// b: the weights w (Cols::W a row, 16-byte aligned, read two at a time)
// and mu (K a row).  Each sum is the fma(at, w, s) that nvcc made of the
// first K35's `s += at * (double)w` (its SASS): the weights were floats,
// so reading them as the doubles they convert to exactly keeps the bits.
// The 4x4 Poisson-MLE step amplifies any difference in these sums on the
// hardest rays, so the kernel keeps them to the plain version's own
// rounding.  Without kExact, the sums of measurements M..MAXM-1 are not
// formed.
template <int K, int MAXM, bool kHess, bool kExact, bool kBf16>
__device__ __forceinline__ void add_rows(
    const double* w, const float* mu, int n, int M, const float (&b)[K],
    double (&s)[Cols<K, MAXM, kHess>::W], float clip) {
  using C = Cols<K, MAXM, kHess>;
  for (int e = 0; e < n; ++e, w += C::W, mu += K) {
    const double at = attenuation<K, kBf16>(b, mu, clip);
    const double2* w2 = reinterpret_cast<const double2*>(w);
#pragma unroll
    for (int j = 0; j < C::W / 2; ++j) {
      if (kExact || C::meas(2 * j) < M) {
        const double2 v = w2[j];
        s[2 * j] = __fma_rn(at, v.x, s[2 * j]);
        s[2 * j + 1] = __fma_rn(at, v.y, s[2 * j + 1]);
      }
    }
  }
}

// One Newton step of _solve_block's _gn_body from one pixel's sums s
// (Cols' order): the log residual step (log_step) or the Poisson-MLE step
// (Fisher scoring, or with kNewton the full Newton Hessian); then
// lm_damping, the solve, the trust region and the clamps.
template <int K, int MAXM, bool kNewton>
__device__ __forceinline__ void step_general(
    float* a, const double* s, const float* y, const float* ly, int M,
    bool log_step, float lm, float step_max, float a_lo, float a_hi) {
  using C = Cols<K, MAXM, kNewton>;
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
        const float n = fmaxf((float)s[m], 1e-35f);
        const float r =
            fminf(fmaxf(ly[m] - (float)log((double)n), -30.0f), 30.0f);
        float J[K];
#pragma unroll
        for (int i = 0; i < K; ++i) J[i] = (float)s[C::G + m * K + i] / n;
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
        const float n = fmaxf((float)s[m], 1e-17f);
        const float r = y[m] / n - 1.0f;
        const float yv2 = y[m] / rmul(n, n);
        float gm[K];
#pragma unroll
        for (int i = 0; i < K; ++i) gm[i] = (float)s[C::G + m * K + i];
#pragma unroll
        for (int i = 0; i < K; ++i) dF[i] = radd(dF[i], rmul(r, gm[i]));
        int t = 0;
#pragma unroll
        for (int i = 0; i < K; ++i) {
#pragma unroll
          for (int j = i; j < K; ++j, ++t) {
            const float gg = rmul(gm[i], gm[j]);
            if constexpr (kNewton)
              H[t] = radd(H[t], rsub(rmul(r, (float)s[C::H + m * T + t]),
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

// The table rows [r0, r0 + n) of ``tables`` (float64, rows of R = K + the
// M measurements' sums: mu_k, then the sums in the order nu, g, h) into
// shared memory at ``w``, Cols::W a row, the columns of measurements past M
// zero.
template <int K, int MAXM, bool kHess>
__device__ __forceinline__ void stage_rows(double* w,
                                           const double* __restrict__ tab,
                                           int r0, int n, int M, int R) {
  using C = Cols<K, MAXM, kHess>;
  constexpr int T = Tri<K>::T;
  for (int i = threadIdx.x; i < n * C::W; i += blockDim.x) {
    const int r = i / C::W, c = i % C::W;
    double v = 0.0;
    if (C::meas(c) < M) {
      const int src = c < C::G ? c
                      : c < C::H ? M + (c - C::G)
                                 : M * (1 + K) + C::meas(c) * T +
                                       (c - C::H) % T;
      v = tab[(long long)(r0 + r) * R + K + src];
    }
    w[i] = v;
  }
}

// The pixel's y and log y (normalised by the count scale) and its initial
// iterate; a thread past the last pixel solves the last one again (its
// lanes and barriers need it) and stores nothing.
template <int K, int MAXM>
__device__ __forceinline__ void load_pixel(const float* __restrict__ counts,
                                           const float* __restrict__ scale,
                                           long long n_pix, long long px,
                                           int M, float eps_init,
                                           float (&y)[MAXM],
                                           float (&ly)[MAXM], float (&a)[K]) {
  const float sc = __ldg(scale);
  const long long q = px < n_pix ? px : n_pix - 1;
#pragma unroll
  for (int m = 0; m < MAXM; ++m) {
    y[m] = m < M ? counts[m * n_pix + q] / sc : 0.0f;
    ly[m] = (float)log((double)fmaxf(y[m], 1e-35f));
  }
#pragma unroll
  for (int k = 0; k < K; ++k) a[k] = eps_init;
}

// counts [M, n_pix]; tables: float64 rows of R = K + M (1 + K) (+ M T)
// values, the full rows, then the warm rows; scale: the count scale, one
// float on the card; out [n_pix, K].  Thread t of block b solves pixel
// b kThreads35 + t.  The block stages every row's mu_k as floats once, and
// each phase's weights as doubles, Cols::W a row, before its steps (warm,
// then polish); ``cap`` rows fit the shared memory, and a phase of more
// rows is staged cap rows at a time in every pass, the passes walking the
// chunks in row order.
template <int K, int MAXM, bool kNewton, bool kExact>
__device__ __forceinline__ void solve_general(
    const float* __restrict__ counts, const double* __restrict__ tables,
    const float* __restrict__ scale, float* __restrict__ out,
    const GeneralArgs& p, int cap) {
  using C = Cols<K, MAXM, kNewton>;
  constexpr int T = Tri<K>::T;
  extern __shared__ double2 k35_smem[];
  const int M = kExact ? MAXM : p.M;
  const int R = K + M * (1 + K) + (kNewton ? M * T : 0);
  double* w = reinterpret_cast<double*>(k35_smem);
  float* mu = reinterpret_cast<float*>(w + (size_t)C::W * cap);
  for (int i = threadIdx.x; i < (p.e_full + p.e_warm) * K; i += blockDim.x)
    mu[i] = (float)tables[(long long)(i / K) * R + i % K];

  const long long px = blockIdx.x * (long long)kThreads35 + threadIdx.x;
  float y[MAXM], ly[MAXM], a[K];
  load_pixel<K, MAXM>(counts, scale, p.n_pix, px, M, p.eps_init, y, ly, a);
  double s[C::W];
  // ``iters`` steps on the rows [r0, r0 + n)
  auto phase = [&](int r0, int n, int iters, bool bf16, bool log) {
    if (iters <= 0) return;
    const bool once = n <= cap;
    if (once) {
      __syncthreads();
      stage_rows<K, MAXM, kNewton>(w, tables, r0, n, M, R);
      __syncthreads();
    }
    for (int it = 0; it < iters; ++it) {
      float b[K];
#pragma unroll
      for (int k = 0; k < K; ++k) b[k] = bf16 ? bf16r(a[k]) : a[k];
#pragma unroll
      for (int j = 0; j < C::W; ++j) s[j] = 0.0;
      for (int c0 = 0; c0 < n; c0 += cap) {
        const int nc = min(cap, n - c0);
        if (!once) {
          __syncthreads();
          stage_rows<K, MAXM, kNewton>(w, tables, r0 + c0, nc, M, R);
          __syncthreads();
        }
        const double* wc = w + (size_t)C::W * (once ? c0 : 0);
        if (bf16)
          add_rows<K, MAXM, kNewton, kExact, true>(wc, mu + (r0 + c0) * K,
                                                   nc, M, b, s, p.clip);
        else
          add_rows<K, MAXM, kNewton, kExact, false>(wc, mu + (r0 + c0) * K,
                                                    nc, M, b, s, p.clip);
      }
      step_general<K, MAXM, kNewton>(a, s, y, ly, M, log, p.lm, p.step_max,
                                     p.a_lo, p.a_hi);
    }
  };
  phase(p.e_full, p.e_warm, p.n_warm, p.warm_bf16 != 0, p.warm_log != 0);
  phase(0, p.e_full, p.n_pol, false, p.polish_log != 0);
  if (px < p.n_pix) {
#pragma unroll
    for (int k = 0; k < K; ++k) out[px * K + k] = a[k];
  }
}

template <int K, int MAXM, bool kNewton, bool kExact>
__global__ void __launch_bounds__(kThreads35) gauss_newton_general_kernel(
    const float* __restrict__ counts, const double* __restrict__ tables,
    const float* __restrict__ scale, float* __restrict__ out, GeneralArgs p,
    int cap) {
  solve_general<K, MAXM, kNewton, kExact>(counts, tables, scale, out, p,
                                          cap);
}

// Shared memory a block may take (the opt-in maximum of the current card)
int max_shared_per_block() {
  int dev = 0, bytes = 48 * 1024;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
  return bytes;
}

// Launch ``kernel`` (solve_general's) with rows of ``row_bytes`` weights:
// a phase's rows at once when they fit a block's shared memory beside
// every row's mu_k, else as many as fit.
template <typename Kernel>
int launch_solve(Kernel kernel, size_t row_bytes, int K,
                 const float* counts, const double* tables,
                 const float* scale, float* out, const GeneralArgs& p,
                 cudaStream_t stream) {
  const size_t mu_bytes = sizeof(float) * K * (size_t)(p.e_full + p.e_warm);
  const size_t limit = (size_t)max_shared_per_block();
  if (mu_bytes + row_bytes > limit) return (int)cudaErrorInvalidValue;
  const int cap = (int)std::min<size_t>(std::max(p.e_full, p.e_warm),
                                        (limit - mu_bytes) / row_bytes);
  const size_t shmem = row_bytes * cap + mu_bytes;
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (p.n_pix + kThreads35 - 1) / kThreads35;
  kernel<<<(unsigned)blocks, kThreads35, shmem, stream>>>(counts, tables,
                                                          scale, out, p, cap);
  return (int)cudaGetLastError();
}

template <int K, int MAXM, bool kNewton, bool kExact>
int launch_general(const float* counts, const double* tables,
                   const float* scale, float* out, const GeneralArgs& p,
                   cudaStream_t stream) {
  return launch_solve(gauss_newton_general_kernel<K, MAXM, kNewton, kExact>,
                      sizeof(double) * Cols<K, MAXM, kNewton>::W, K, counts,
                      tables, scale, out, p, stream);
}

// K35's instantiations: exact M at the paths' shapes (K = 4 with M = 6, the
// K-edge scans; K = 2 with M = 4, the packed PCD steps), else a maximum M
// of 4 or 8 (with kExactM false, every shape takes a maximum M)
template <int K, bool kExactM = true>
int dispatch_general(const float* counts, const double* tables,
                     const float* scale, float* out, const GeneralArgs& p,
                     int newton, cudaStream_t stream) {
  if constexpr (kExactM && K == 4) {
    if (!newton && p.M == 6)
      return launch_general<4, 6, false, true>(counts, tables, scale, out, p,
                                               stream);
  }
  if constexpr (kExactM && K == 2) {
    if (!newton && p.M == 4)
      return launch_general<2, 4, false, true>(counts, tables, scale, out, p,
                                               stream);
  }
  if (p.M <= 4) {
    return newton ? launch_general<K, 4, true, false>(counts, tables, scale,
                                                      out, p, stream)
                  : launch_general<K, 4, false, false>(counts, tables, scale,
                                                       out, p, stream);
  }
  return newton ? launch_general<K, 8, true, false>(counts, tables, scale,
                                                    out, p, stream)
                : launch_general<K, 8, false, false>(counts, tables, scale,
                                                     out, p, stream);
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

// tables: float64, 16-byte aligned; scale: a pointer to the count scale
// on the card
extern "C" int dexct_gauss_newton_general(
    const void* counts, const void* tables, const void* scale, void* out,
    long long n_pix, int n_meas, int n_mats, int newton, int e_full,
    int e_warm, int n_warm, int n_pol, int warm_bf16, int warm_log,
    int polish_log, float lm_damping, float a_lo, float a_hi, float step_max,
    float eps_init, float clip, void* stream) {
  if (n_pix <= 0) return (int)cudaGetLastError();
  if (n_meas < n_mats || n_meas > 8) return (int)cudaErrorInvalidValue;
  if (!aligned16(tables)) return (int)cudaErrorMisalignedAddress;
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
  const double* t = static_cast<const double*>(tables);
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
