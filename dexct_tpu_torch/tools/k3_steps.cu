// The steps of K3's redesign as kernel variants, for
// tools/probe_k3_steps.py (not part of the package's kernel library).
//
// Variant 0 is K3 as it stood before the redesign (csrc/gauss_newton.cu at
// that commit, copied below): one thread per pixel, the node loop left to
// nvcc (which unrolled it by 2), every contraction nvcc's choice.  The
// other variants are the library's kernel, gauss_newton_kernel<P, U>, at P
// pixels a thread and the node loop unrolled by U; the library's entry,
// dexct_gauss_newton, launches P = kPix, U = kUnroll.  All variants round
// each pixel's arithmetic as variant 0 does (the new kernel writes out
// every contraction nvcc made in variant 0), so they agree with it bit for
// bit.

#include "../csrc/gauss_newton.cu"

namespace parent {

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

// scale: the count scale, one float on the card (read, never copied to
// the host)
__global__ void parent_kernel(const float* __restrict__ counts,
                                    const float* __restrict__ tables,
                                    const float* __restrict__ scale,
                                    float* __restrict__ out, long long n_pix,
                                    int e_full, int e_warm, int n_warm,
                                    int n_pol, int warm_bf16, float a_lo,
                                    float a_hi, float step_max,
                                    float eps_init, float clip) {
  extern __shared__ float tab[];
  const int n_tab = kRow * (e_full + e_warm);
  for (int i = threadIdx.x; i < n_tab; i += blockDim.x) tab[i] = tables[i];
  __syncthreads();
  const long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  solve_pixel(counts[p], counts[n_pix + p], tab, tab + kRow * e_full, e_full,
              e_warm, n_warm, n_pol, warm_bf16, __ldg(scale), a_lo, a_hi,
              step_max, eps_init, clip, out + 2 * p);
}

}  // namespace parent

// variant 0: the parent; 1-8: (P, U) = (1, 1), (1, 2), (2, 1), (2, 2),
// (2, 4), (4, 1), (4, 2), (4, 4)
extern "C" int k3_step(int variant, const void* counts, const void* tables,
                       const void* scale, void* out, long long n_pix,
                       int e_full, int e_warm, int n_warm, int n_pol,
                       int warm_bf16, float a_lo, float a_hi, float step_max,
                       float eps_init, float clip, void* stream) {
  const float* c = static_cast<const float*>(counts);
  const float4* t = static_cast<const float4*>(tables);
  const float* s = static_cast<const float*>(scale);
  float2* o = static_cast<float2*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_pix <= 0) return (int)cudaGetLastError();
  if (variant == 0) {
    const size_t shmem = sizeof(float) * kRow * (size_t)(e_full + e_warm);
    const long long blocks = (n_pix + 127) / 128;
    parent::parent_kernel<<<(unsigned)blocks, 128, shmem, st>>>(
        c, static_cast<const float*>(tables), s, static_cast<float*>(out),
        n_pix, e_full, e_warm, n_warm, n_pol, warm_bf16, a_lo, a_hi,
        step_max, eps_init, clip);
    return (int)cudaGetLastError();
  }
#define K3_STEP(i, P, U)                                                    \
  if (variant == i)                                                         \
    return launch_gauss_newton<P, U>(c, t, s, o, n_pix, e_full, e_warm,     \
                                     n_warm, n_pol, warm_bf16, a_lo, a_hi, \
                                     step_max, eps_init, clip, st);
  K3_STEP(1, 1, 1)
  K3_STEP(2, 1, 2)
  K3_STEP(3, 2, 1)
  K3_STEP(4, 2, 2)
  K3_STEP(5, 2, 4)
  K3_STEP(6, 4, 1)
  K3_STEP(7, 4, 2)
  K3_STEP(8, 4, 4)
#undef K3_STEP
  return (int)cudaErrorInvalidValue;
}
