// K36 afterglow_apply and K37 afterglow_correct: the scintillator lag
// recursion over views and its exact algebraic inverse, per detector
// column.
//
// They replace dexct_tpu/ops/afterglow.py:apply_afterglow and
// :correct_afterglow, each a lax.scan over the V views with a [K, ...]
// carry of trap states.  With decays b_k, trap fractions a_k and the
// working-type coefficients the wrapper forms exactly as the plain twin
// does (1 - b_k, prompt = 1 - sum a_k, a_k b_k and gain = 1 - sum a_k b_k):
//
//   apply:   y_k = b_k y_k + (1 - b_k) x[v];  m[v] = prompt x[v] + sum a_k y_k
//   correct: x[v] = (m[v] - sum (a_k b_k) y_k) / gain;
//            y_k = b_k y_k + (1 - b_k) x[v]
//
// (the sums in k order).  A warm start seeds every y_k with view 0.
//
// What bounds it on the card: each element is read once and written once
// (8 bytes a float32 element) and the work is ~4 K operations per element,
// so the bytes bound it: 6.4 MB, ~2 us, for a [1000, 800] acquisition.  But
// the recursion runs along the views, so the parallelism is the P columns
// alone: 800 threads on 132 SMs, each walking 1000 dependent steps.  The
// kernel is latency-bound.  Design: one thread per column, the K states in
// registers (K a template parameter up to MAX_TRAPS = 8), every operation
// rounded as the plain twin rounds it (the _rn intrinsics: no FMA
// contraction).  The loads of x do not depend on the recursion, so a block
// of U views is loaded one block ahead of the views being stepped, which
// keeps U loads in flight while the dependent chain runs; neighbouring
// threads read neighbouring columns, so each view's loads coalesce.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTraps = 8;
constexpr int kAhead = 16;  // views loaded ahead of the recursion
constexpr int kThreads = 64;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}

// b, 1 - b, and a (apply) or a b (correct) per trap; prompt (apply) or
// gain (correct); all in the working type
template <typename T>
struct Coef {
  T b[kMaxTraps];
  T omb[kMaxTraps];
  T w[kMaxTraps];
  T scalar;
};

template <typename T, int K, bool CORRECT>
__global__ void afterglow_kernel(const T* __restrict__ in,
                                 T* __restrict__ out, const Coef<T> c,
                                 int V, long long P, int warm) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const T* src = in + p;
  T* dst = out + p;
  T y[K];
  const T y0 = warm ? __ldg(src) : T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) y[k] = y0;
  T cur[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u)
    cur[u] = u < V ? __ldg(src + (long long)u * P) : T(0);
  for (int v0 = 0; v0 < V; v0 += kAhead) {
    T nxt[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int v = v0 + kAhead + u;
      nxt[u] = v < V ? __ldg(src + (long long)v * P) : T(0);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int v = v0 + u;
      if (v < V) {
        T x;
        if constexpr (CORRECT) {
          T s = mul_rn(c.w[0], y[0]);
#pragma unroll
          for (int k = 1; k < K; ++k) s = add_rn(s, mul_rn(c.w[k], y[k]));
          x = div_rn(sub_rn(cur[u], s), c.scalar);
        } else {
          x = cur[u];
        }
#pragma unroll
        for (int k = 0; k < K; ++k)
          y[k] = add_rn(mul_rn(c.b[k], y[k]), mul_rn(c.omb[k], x));
        if constexpr (CORRECT) {
          dst[(long long)v * P] = x;
        } else {
          T s = mul_rn(c.w[0], y[0]);
#pragma unroll
          for (int k = 1; k < K; ++k) s = add_rn(s, mul_rn(c.w[k], y[k]));
          dst[(long long)v * P] = add_rn(mul_rn(c.scalar, x), s);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) cur[u] = nxt[u];
  }
}

template <typename T, int K, bool CORRECT>
int launch_k(const void* in, void* out, const Coef<T>& c, int V,
             long long P, int warm, void* stream) {
  const long long blocks = (P + kThreads - 1) / kThreads;
  afterglow_kernel<T, K, CORRECT>
      <<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(in), static_cast<T*>(out), c, V, P, warm);
  return (int)cudaGetLastError();
}

template <typename T, bool CORRECT>
int launch(const void* in, void* out, const double* coef, int k, int V,
           long long P, int warm, void* stream) {
  Coef<T> c = {};
  for (int i = 0; i < k; ++i) {
    c.b[i] = (T)coef[i];
    c.omb[i] = (T)coef[k + i];
    c.w[i] = (T)coef[2 * k + i];
  }
  c.scalar = (T)coef[3 * k];
  switch (k) {
    case 1: return launch_k<T, 1, CORRECT>(in, out, c, V, P, warm, stream);
    case 2: return launch_k<T, 2, CORRECT>(in, out, c, V, P, warm, stream);
    case 3: return launch_k<T, 3, CORRECT>(in, out, c, V, P, warm, stream);
    case 4: return launch_k<T, 4, CORRECT>(in, out, c, V, P, warm, stream);
    case 5: return launch_k<T, 5, CORRECT>(in, out, c, V, P, warm, stream);
    case 6: return launch_k<T, 6, CORRECT>(in, out, c, V, P, warm, stream);
    case 7: return launch_k<T, 7, CORRECT>(in, out, c, V, P, warm, stream);
    case 8: return launch_k<T, 8, CORRECT>(in, out, c, V, P, warm, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// in, out [V, P] contiguous, float32 (is_double 0) or float64 (1); coef
// (host) [3 k + 1] doubles holding working-type values: b (k), 1 - b (k),
// a (apply) or a b (correct) (k), then prompt (apply) or gain (correct)
extern "C" int dexct_afterglow(const void* in, void* out, const double* coef,
                               int k, int correct, int is_double, int V,
                               long long P, int warm, void* stream) {
  if (k < 1 || k > kMaxTraps) return (int)cudaErrorInvalidValue;
  if (V <= 0 || P <= 0) return (int)cudaGetLastError();
  if (is_double)
    return correct ? launch<double, true>(in, out, coef, k, V, P, warm, stream)
                   : launch<double, false>(in, out, coef, k, V, P, warm,
                                           stream);
  return correct ? launch<float, true>(in, out, coef, k, V, P, warm, stream)
                 : launch<float, false>(in, out, coef, k, V, P, warm, stream);
}
