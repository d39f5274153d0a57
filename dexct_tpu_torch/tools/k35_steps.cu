// The steps of K35's redesign as kernel variants, for tools/probe_k35.py
// --steps (not part of the package's kernel library).
//
// Variant 0 is K35 as it stood before the redesign (csrc/gauss_newton.cu at
// that commit, copied below as namespace parent): a float table in shared
// memory, each weight converted to a double for its sum, per pixel and
// table node; one pixel a thread; templated on K and a maximum M of 4 or 8.
// Variants 1, 2, 4 and 5 run the library's kernel body, solve_general, on
// a float64 copy of the table: 1 at a maximum M for every shape; 2 (the
// library's dispatch) with exact M at the paths' shapes and no register
// cap; 4 and 5 with at least 4 and 5 blocks an SM there (at most 128 and
// 102 registers a thread).  Variant 3 solves 2 pixels a thread over each
// staged row, and variants 6 and 7 share each row's weights among 2 and 4
// lanes (4 blocks an SM), at exact M.  Variant 8 reads the
// weights from the float64 table in the card's memory at one address a
// warp, whatever the table's size, where its rows are the kernel's columns
// (M = 4 or 8 or a path's shape, K even; else it is variant 2); the
// library reads them from shared memory, a phase's rows at a time.  Every
// variant rounds each pixel's arithmetic as variant 0 does, so they agree
// with it bit for bit.

#include "../csrc/gauss_newton.cu"

namespace parent {

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


// counts [M, n_pix]; tables: the full rows, then the warm rows; scale:
// the count scale, one float on the card; out [n_pix, K].
template <int K, int MAXM, bool kNewton>
__global__ void parent_kernel(const float* __restrict__ counts,
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
  auto kernel = parent_kernel<K, MAXM, kNewton>;
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

}  // namespace parent

namespace {

// NP pixels' attenuations at added into their sums s with WQ weights w
// (16-byte aligned), each sum as the library's add_rows forms it; without
// kExact the sums of measurements past M are not formed.
template <int K, int MAXM, bool kHess, bool kExact, int NP, int WQ>
__device__ __forceinline__ void add_weights(const double* w,
                                            const double (&at)[NP],
                                            double (&s)[NP][WQ], int M) {
  using C = Cols<K, MAXM, kHess>;
  const double2* w2 = reinterpret_cast<const double2*>(w);
#pragma unroll
  for (int j = 0; j < WQ / 2; ++j) {
    if (kExact || C::meas(2 * j) < M) {
      const double2 v = w2[j];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        s[p][2 * j] = __fma_rn(at[p], v.x, s[p][2 * j]);
        s[p][2 * j + 1] = __fma_rn(at[p], v.y, s[p][2 * j + 1]);
      }
    }
  }
}

// Variants 4 and 5: the library's kernel body at exact M with at least B
// blocks an SM
template <int K, int M, int B>
__global__ void __launch_bounds__(kThreads35, B)
    k35_blocks_kernel(const float* __restrict__ counts,
                      const double* __restrict__ tables,
                      const float* __restrict__ scale,
                      float* __restrict__ out, GeneralArgs p, int cap) {
  solve_general<K, M, false, true>(counts, tables, scale, out, p, cap);
}

// Variant 3: P pixels a thread (b kThreads35 P + t + p kThreads35, p < P)
// over each staged row.
template <int K, int MAXM, bool kNewton, bool kExact, int P>
__global__ void __launch_bounds__(kThreads35) k35_pix_kernel(
    const float* __restrict__ counts, const double* __restrict__ tables,
    const float* __restrict__ scale, float* __restrict__ out, GeneralArgs p,
    int cap) {
  using C = Cols<K, MAXM, kNewton>;
  constexpr int T = Tri<K>::T;
  constexpr int W = C::W;
  extern __shared__ double2 k35p_smem[];
  const int M = kExact ? MAXM : p.M;
  const int R = K + M * (1 + K) + (kNewton ? M * T : 0);
  double* w = reinterpret_cast<double*>(k35p_smem);
  float* mu = reinterpret_cast<float*>(w + (size_t)W * cap);
  for (int i = threadIdx.x; i < (p.e_full + p.e_warm) * K; i += blockDim.x)
    mu[i] = (float)tables[(long long)(i / K) * R + i % K];
  const long long first =
      blockIdx.x * (long long)(kThreads35 * P) + threadIdx.x;
  float y[P][MAXM], ly[P][MAXM], a[P][K];
#pragma unroll
  for (int q = 0; q < P; ++q)
    load_pixel<K, MAXM>(counts, scale, p.n_pix, first + q * kThreads35, M,
                        p.eps_init, y[q], ly[q], a[q]);
  double s[P][W];
  auto phase = [&](int r0, int n, int iters, bool bf16, bool log) {
    if (iters <= 0) return;
    const bool once = n <= cap;
    if (once) {
      __syncthreads();
      stage_rows<K, MAXM, kNewton>(w, tables, r0, n, M, R);
      __syncthreads();
    }
    for (int it = 0; it < iters; ++it) {
      float b[P][K];
#pragma unroll
      for (int q = 0; q < P; ++q) {
#pragma unroll
        for (int k = 0; k < K; ++k) b[q][k] = bf16 ? bf16r(a[q][k]) : a[q][k];
#pragma unroll
        for (int j = 0; j < W; ++j) s[q][j] = 0.0;
      }
      for (int c0 = 0; c0 < n; c0 += cap) {
        const int nc = min(cap, n - c0);
        if (!once) {
          __syncthreads();
          stage_rows<K, MAXM, kNewton>(w, tables, r0 + c0, nc, M, R);
          __syncthreads();
        }
        const double* wc = w + (size_t)W * (once ? c0 : 0);
        const float* mc = mu + (r0 + c0) * K;
        for (int e = 0; e < nc; ++e, wc += W, mc += K) {
          double at[P];
#pragma unroll
          for (int q = 0; q < P; ++q)
            at[q] = bf16 ? attenuation<K, true>(b[q], mc, p.clip)
                         : attenuation<K, false>(b[q], mc, p.clip);
          add_weights<K, MAXM, kNewton, kExact, P, W>(wc, at, s, M);
        }
      }
#pragma unroll
      for (int q = 0; q < P; ++q)
        step_general<K, MAXM, kNewton>(a[q], s[q], y[q], ly[q], M, log,
                                       p.lm, p.step_max, p.a_lo, p.a_hi);
    }
  };
  phase(p.e_full, p.e_warm, p.n_warm, p.warm_bf16 != 0, p.warm_log != 0);
  phase(0, p.e_full, p.n_pol, false, p.polish_log != 0);
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const long long px = first + (long long)q * kThreads35;
    if (px < p.n_pix) {
#pragma unroll
      for (int k = 0; k < K; ++k) out[px * K + k] = a[q][k];
    }
  }
}

// Variants 6 and 7: a row's weights shared by Q lanes, at exact M.  The W
// sums' columns (zero past W) are cut into Q slices of WQ (even) doubles,
// lane r of a group of Q reading slice r; slices SLICE doubles apart, which
// puts the lanes' 16-byte loads in different banks.
template <int K, int M, int Q>
struct Lanes {
  static constexpr int W = Cols<K, M, false>::W;
  static constexpr int WQ = (W + 2 * Q - 1) / (2 * Q) * 2;
  static constexpr int SLICE = WQ + 2;
  static constexpr int STRIDE = Q * SLICE;
};

// rows [r0, r0 + n) into shared memory in Lanes' layout
template <int K, int M, int Q>
__device__ __forceinline__ void stage_lanes(double* w,
                                            const double* __restrict__ tab,
                                            int r0, int n) {
  using L = Lanes<K, M, Q>;
  constexpr int R = K + L::W;
  for (int i = threadIdx.x; i < n * L::STRIDE; i += blockDim.x) {
    const int r = i / L::STRIDE, k = i % L::STRIDE;
    const int j = k % L::SLICE, c = k / L::SLICE * L::WQ + j;
    w[i] = j < L::WQ && c < L::W ? tab[(long long)(r0 + r) * R + K + c]
                                 : 0.0;
  }
}

// n rows added into a group of Q lanes' sums: each lane forms its own
// pixel's attenuation, takes the group's others by shuffles, and adds its
// slice of each row into s[d][j], the sums of the pixel of lane r ^ d at
// column r WQ + j (r its lane in the group).
template <int K, int M, int Q, bool kBf16>
__device__ __forceinline__ void add_rows_lanes(
    const double* w, const float* mu, int n, const float (&b)[K],
    double (&s)[Q][Lanes<K, M, Q>::WQ], float clip) {
  using L = Lanes<K, M, Q>;
  w += (threadIdx.x % Q) * L::SLICE;
  for (int e = 0; e < n; ++e, w += L::STRIDE, mu += K) {
    double at[Q];
    at[0] = attenuation<K, kBf16>(b, mu, clip);
#pragma unroll
    for (int d = 1; d < Q; ++d) at[d] = __shfl_xor_sync(0xffffffffu, at[0], d);
    add_weights<K, M, false, true, Q, L::WQ>(w, at, s, M);
  }
}

// This lane's own pixel's W sums from the group's: lane r ^ d holds the
// pixel's slice r ^ d as its s[d].
template <int K, int M, int Q>
__device__ __forceinline__ void own_sums(
    const double (&s)[Q][Lanes<K, M, Q>::WQ],
    double (&full)[Cols<K, M, false>::W]) {
  using L = Lanes<K, M, Q>;
  const int r = threadIdx.x % Q;
#pragma unroll
  for (int j = 0; j < L::WQ; ++j) {
    double got[Q];  // got[d]: column (r ^ d) WQ + j
    got[0] = s[0][j];
#pragma unroll
    for (int d = 1; d < Q; ++d)
      got[d] = __shfl_xor_sync(0xffffffffu, s[d][j], d);
#pragma unroll
    for (int sl = 0; sl < Q; ++sl) {
      if (sl * L::WQ + j < L::W) {
        double v = got[0];
#pragma unroll
        for (int d = 1; d < Q; ++d) v = (sl ^ r) == d ? got[d] : v;
        full[sl * L::WQ + j] = v;
      }
    }
  }
}

template <int K, int M, int Q>
__global__ void __launch_bounds__(kThreads35, 4) k35_lanes_kernel(
    const float* __restrict__ counts, const double* __restrict__ tables,
    const float* __restrict__ scale, float* __restrict__ out, GeneralArgs p,
    int cap) {
  using L = Lanes<K, M, Q>;
  constexpr int R = K + L::W;
  extern __shared__ double2 k35l_smem[];
  double* w = reinterpret_cast<double*>(k35l_smem);
  float* mu = reinterpret_cast<float*>(w + (size_t)L::STRIDE * cap);
  for (int i = threadIdx.x; i < (p.e_full + p.e_warm) * K; i += blockDim.x)
    mu[i] = (float)tables[(long long)(i / K) * R + i % K];
  const long long px = blockIdx.x * (long long)kThreads35 + threadIdx.x;
  float y[M], ly[M], a[K];
  load_pixel<K, M>(counts, scale, p.n_pix, px, M, p.eps_init, y, ly, a);
  double s[Q][L::WQ], full[L::W];
  auto phase = [&](int r0, int n, int iters, bool bf16, bool log) {
    if (iters <= 0) return;
    const bool once = n <= cap;
    if (once) {
      __syncthreads();
      stage_lanes<K, M, Q>(w, tables, r0, n);
      __syncthreads();
    }
    for (int it = 0; it < iters; ++it) {
      float b[K];
#pragma unroll
      for (int k = 0; k < K; ++k) b[k] = bf16 ? bf16r(a[k]) : a[k];
#pragma unroll
      for (int d = 0; d < Q; ++d) {
#pragma unroll
        for (int j = 0; j < L::WQ; ++j) s[d][j] = 0.0;
      }
      for (int c0 = 0; c0 < n; c0 += cap) {
        const int nc = min(cap, n - c0);
        if (!once) {
          __syncthreads();
          stage_lanes<K, M, Q>(w, tables, r0 + c0, nc);
          __syncthreads();
        }
        const double* wc = w + (size_t)L::STRIDE * (once ? c0 : 0);
        if (bf16)
          add_rows_lanes<K, M, Q, true>(wc, mu + (r0 + c0) * K, nc, b, s,
                                        p.clip);
        else
          add_rows_lanes<K, M, Q, false>(wc, mu + (r0 + c0) * K, nc, b, s,
                                         p.clip);
      }
      own_sums<K, M, Q>(s, full);
      step_general<K, M, false>(a, full, y, ly, M, log, p.lm, p.step_max,
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

// Variant 8: one lane a row, the weights read from ``tables`` in the
// card's memory (rows of R = K + Cols::W doubles: M == MAXM, K even), the
// mu_k staged as floats.
template <int K, int MAXM, bool kNewton>
__global__ void __launch_bounds__(kThreads35) k35_global_kernel(
    const float* __restrict__ counts, const double* __restrict__ tables,
    const float* __restrict__ scale, float* __restrict__ out,
    GeneralArgs p) {
  using C = Cols<K, MAXM, kNewton>;
  constexpr int W = C::W;
  constexpr int R = K + W;
  extern __shared__ float4 k35g_mu[];
  float* mu = reinterpret_cast<float*>(k35g_mu);
  for (int i = threadIdx.x; i < (p.e_full + p.e_warm) * K; i += blockDim.x)
    mu[i] = (float)tables[(long long)(i / K) * R + i % K];
  __syncthreads();
  const long long px = blockIdx.x * (long long)kThreads35 + threadIdx.x;
  float y[MAXM], ly[MAXM], a[K];
  load_pixel<K, MAXM>(counts, scale, p.n_pix, px, MAXM, p.eps_init, y, ly,
                      a);
  double s[1][W];
  auto phase = [&](int r0, int n, int iters, bool bf16, bool log) {
    for (int it = 0; it < iters; ++it) {
      float b[K];
#pragma unroll
      for (int k = 0; k < K; ++k) b[k] = bf16 ? bf16r(a[k]) : a[k];
#pragma unroll
      for (int j = 0; j < W; ++j) s[0][j] = 0.0;
      const double* wr = tables + (size_t)R * r0 + K;
      const float* mr = mu + r0 * K;
      for (int e = 0; e < n; ++e, wr += R, mr += K) {
        const double at[1] = {bf16 ? attenuation<K, true>(b, mr, p.clip)
                                   : attenuation<K, false>(b, mr, p.clip)};
        add_weights<K, MAXM, kNewton, true, 1, W>(wr, at, s, MAXM);
      }
      step_general<K, MAXM, kNewton>(a, s[0], y, ly, MAXM, log, p.lm,
                                     p.step_max, p.a_lo, p.a_hi);
    }
  };
  phase(p.e_full, p.e_warm, p.n_warm, p.warm_bf16 != 0, p.warm_log != 0);
  phase(0, p.e_full, p.n_pol, false, p.polish_log != 0);
  if (px < p.n_pix) {
#pragma unroll
    for (int k = 0; k < K; ++k) out[px * K + k] = a[k];
  }
}

// launchers of one instantiation, for dispatch_with; every one runs the
// library's launch at a maximum M
template <int B>
struct MinBlocks {
  template <int K, int MAXM, bool kNewton, bool kExact>
  struct L {
    static int run(const float* c, const double* t, const float* sc,
                   float* o, const GeneralArgs& p, cudaStream_t st) {
      if constexpr (kExact && !kNewton)
        return launch_solve(k35_blocks_kernel<K, MAXM, B>,
                            sizeof(double) * Cols<K, MAXM, false>::W, K, c,
                            t, sc, o, p, st);
      else
        return launch_general<K, MAXM, kNewton, kExact>(c, t, sc, o, p, st);
    }
  };
};
template <int K, int MAXM, bool kNewton, bool kExact>
using Blocks4 = MinBlocks<4>::L<K, MAXM, kNewton, kExact>;
template <int K, int MAXM, bool kNewton, bool kExact>
using Blocks5 = MinBlocks<5>::L<K, MAXM, kNewton, kExact>;
template <int K, int MAXM, bool kNewton, bool kExact>
struct TwoPixels {
  static int run(const float* c, const double* t, const float* sc, float* o,
                 const GeneralArgs& p, cudaStream_t st) {
    if constexpr (!kExact) {
      return launch_general<K, MAXM, kNewton, kExact>(c, t, sc, o, p, st);
    } else {
      constexpr int P = 2;
      const size_t row_bytes = sizeof(double) * Cols<K, MAXM, kNewton>::W;
      const size_t mu_bytes =
          sizeof(float) * K * (size_t)(p.e_full + p.e_warm);
      const size_t limit = (size_t)max_shared_per_block();
      const int cap = (int)std::min<size_t>(std::max(p.e_full, p.e_warm),
                                            (limit - mu_bytes) / row_bytes);
      const size_t shmem = row_bytes * cap + mu_bytes;
      auto kernel = k35_pix_kernel<K, MAXM, kNewton, kExact, P>;
      if (shmem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
        if (err != cudaSuccess) return (int)err;
      }
      const long long per_block = (long long)kThreads35 * P;
      const long long blocks = (p.n_pix + per_block - 1) / per_block;
      kernel<<<(unsigned)blocks, kThreads35, shmem, st>>>(c, t, sc, o, p,
                                                          cap);
      return (int)cudaGetLastError();
    }
  }
};
template <int Q>
struct SharedRows {
  template <int K, int MAXM, bool kNewton, bool kExact>
  struct L {
    static int run(const float* c, const double* t, const float* sc,
                   float* o, const GeneralArgs& p, cudaStream_t st) {
      if constexpr (kExact && !kNewton)
        return launch_solve(k35_lanes_kernel<K, MAXM, Q>,
                            sizeof(double) * Lanes<K, MAXM, Q>::STRIDE, K, c,
                            t, sc, o, p, st);
      else
        return launch_general<K, MAXM, kNewton, kExact>(c, t, sc, o, p, st);
    }
  };
};
template <int K, int MAXM, bool kNewton, bool kExact>
using TwoLanes = SharedRows<2>::L<K, MAXM, kNewton, kExact>;
template <int K, int MAXM, bool kNewton, bool kExact>
using FourLanes = SharedRows<4>::L<K, MAXM, kNewton, kExact>;
template <int K, int MAXM, bool kNewton, bool kExact>
struct GlobalWeights {
  static int run(const float* c, const double* t, const float* sc, float* o,
                 const GeneralArgs& p, cudaStream_t st) {
    if constexpr (K % 2 != 0) {
      return launch_general<K, MAXM, kNewton, kExact>(c, t, sc, o, p, st);
    } else {
      if (p.M != MAXM)
        return launch_general<K, MAXM, kNewton, kExact>(c, t, sc, o, p, st);
      const size_t shmem = sizeof(float) * K * (size_t)(p.e_full + p.e_warm);
      const long long blocks = (p.n_pix + kThreads35 - 1) / kThreads35;
      k35_global_kernel<K, MAXM, kNewton>
          <<<(unsigned)blocks, kThreads35, shmem, st>>>(c, t, sc, o, p);
      return (int)cudaGetLastError();
    }
  }
};

// the library's dispatch (exact M at the paths' shapes) over launcher L
template <template <int, int, bool, bool> class L, int K>
int dispatch_with(const float* c, const double* t, const float* sc, float* o,
                  const GeneralArgs& p, int newton, cudaStream_t st) {
  if constexpr (K == 4) {
    if (!newton && p.M == 6)
      return L<4, 6, false, true>::run(c, t, sc, o, p, st);
  }
  if constexpr (K == 2) {
    if (!newton && p.M == 4)
      return L<2, 4, false, true>::run(c, t, sc, o, p, st);
  }
  if (p.M <= 4)
    return newton ? L<K, 4, true, false>::run(c, t, sc, o, p, st)
                  : L<K, 4, false, false>::run(c, t, sc, o, p, st);
  return newton ? L<K, 8, true, false>::run(c, t, sc, o, p, st)
                : L<K, 8, false, false>::run(c, t, sc, o, p, st);
}

template <int K>
int step_dispatch(int variant, const float* c, const double* t,
                  const float* t32, const float* sc, float* o,
                  const GeneralArgs& p, int newton, cudaStream_t st) {
  switch (variant) {
    case 0:
      return parent::dispatch_general<K>(c, t32, sc, o, p, newton, st);
    case 1:
      return dispatch_general<K, false>(c, t, sc, o, p, newton, st);
    case 2:
      return dispatch_general<K>(c, t, sc, o, p, newton, st);
    case 3:
      return dispatch_with<TwoPixels, K>(c, t, sc, o, p, newton, st);
    case 4:
      return dispatch_with<Blocks4, K>(c, t, sc, o, p, newton, st);
    case 5:
      return dispatch_with<Blocks5, K>(c, t, sc, o, p, newton, st);
    case 6:
      return dispatch_with<TwoLanes, K>(c, t, sc, o, p, newton, st);
    case 7:
      return dispatch_with<FourLanes, K>(c, t, sc, o, p, newton, st);
    case 8:
      return dispatch_with<GlobalWeights, K>(c, t, sc, o, p, newton, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// tables: K35's float64 table (variants 1-8); tables32: the same rows as
// floats (variant 0); the rest as dexct_gauss_newton_general's
extern "C" int k35_step(int variant, const void* counts, const void* tables,
                        const void* tables32, const void* scale, void* out,
                        long long n_pix, int n_meas, int n_mats, int newton,
                        int e_full, int e_warm, int n_warm, int n_pol,
                        int warm_bf16, int warm_log, int polish_log,
                        float lm_damping, float a_lo, float a_hi,
                        float step_max, float eps_init, float clip,
                        void* stream) {
  if (n_pix <= 0) return (int)cudaGetLastError();
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
  const float* t32 = static_cast<const float*>(tables32);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_mats) {
    case 2:
      return step_dispatch<2>(variant, c, t, t32, sc, o, p, newton, st);
    case 3:
      return step_dispatch<3>(variant, c, t, t32, sc, o, p, newton, st);
    case 4:
      return step_dispatch<4>(variant, c, t, t32, sc, o, p, newton, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
