// K2: the detected counts of each ray under a polyenergetic spectrum,
//
//     counts(ray) = sum_E i0(E) exp(clip(-sum_m paths_m mu_m(E), -700, 2)),
//
// and, where a second table is given (the compound-noise second moment
// i2), a second sum over the same exps.  It replaces the TPU program
// dexct_tpu/ops/spectral.py:counts_from_paths (two MXU matmuls with the
// exp between them) and gives, bit for bit, the output of the port's first
// K2, a Triton kernel over [128 rays, 64 energies] tiles.
//
// That kernel's order of operations, read from the TTGIR and PTX Triton
// made of it (blocked layout sizePerThread [1, 1], threadsPerWarp [1, 32],
// warpsPerCTA [2, 2]: a warp's 32 lanes over 32 energies, each thread one
// energy of 64 rays), which this kernel reproduces:
//
// - L = fma(p_{M-1}, mu_{M-1}, ... fma(p_0, mu_0, +0)), in material order;
// - a = ex2.approx.f32(min(max(-L, -700), 2) * log2(e)), the multiply
//   rounded on its own;
// - a 64-energy chunk's sum is two warps' sums added, P_0 + P_1; warp w
//   holds the energies 32 w + j of the chunk, j = 0..31, and reduces them
//   with the shuffle butterfly xor 16, 8, 4, 2, 1, whose first step LLVM
//   contracted into an fma: lane j < 16 forms
//       s1_j = fma(a_j, b_j, round(a_{j+16} b_{j+16})),
//   then s2_j = s1_j + s1_{j+8}, s3_j = s2_j + s2_{j+4},
//   s4_j = s3_j + s3_{j+2} and P = s4_0 + s4_1 (lane 0 stores P);
// - the running sum: acc = acc + (P_0 + P_1) per chunk, from +0;
// - energies past E read mu = 0 and i0 = 0: a = 1, b = 0, so they add +0.
//
// Here one thread evaluates that whole tree for kRays rays of its own, so
// that each table entry it reads from shared memory serves kRays rays and
// no shuffle or barrier is needed within a chunk; the chunk's table (mu of
// each material, i0, i2) is staged in shared memory as one 16-byte aligned
// record per energy, read by the warp as broadcast 16-byte loads.  The
// tail's masked leaves enter as (a, b) = (1, 0), as in the parent.  Every
// contraction is written out (__fmaf_rn, __fmul_rn, __fadd_rn), so nvcc
// cannot move one; no --use_fast_math.
//
// M in 1..8 is a template parameter (the paths live in registers); any
// other M, 0 included, runs an instantiation of the same tree that reads
// the paths and the table from the card's memory at run time.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;  // the parent's energies per chunk (BLOCK_E)
constexpr int kHalf = 32;   // a warp's lanes over a chunk's energies
constexpr int kRays = 2;      // rays a thread
constexpr int kThreads = 256;  // tools/probe_k2.py --steps chose both

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exp(clip(-L, -700, 2)) as the parent computes it
__device__ __forceinline__ float attenuation(float L) {
  const float x = fminf(fmaxf(-L, -700.0f), 2.0f);
  return ex2_approx(__fmul_rn(x, 0x1.715476p+0f));  // log2(e) in float32
}

// floats of an energy's record in shared memory: mu of each material, i0,
// i2 where given, padded to whole 16-byte loads
template <int kM, bool kI2>
struct Record {
  static constexpr int kFloats = (kM + 1 + (kI2 ? 1 : 0) + 3) & ~3;
};

// Leaves from the staged chunk: the paths of kR rays in registers.
template <int kM, bool kI2, int kR>
struct StagedLeaves {
  static constexpr int kRec = Record<kM, kI2>::kFloats;
  const float* tab;  // the chunk's first record of this half
  const float (&p)[kR][kM];

  __device__ __forceinline__ void leaf(int j, bool live, float (&a)[kR],
                                       float& b, float& b2) const {
    float rec[kRec];
    const float4* r4 = reinterpret_cast<const float4*>(tab + j * kRec);
#pragma unroll
    for (int q = 0; q < kRec / 4; ++q) {
      const float4 v = r4[q];
      rec[4 * q] = v.x;
      rec[4 * q + 1] = v.y;
      rec[4 * q + 2] = v.z;
      rec[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      float L = 0.0f;
#pragma unroll
      for (int m = 0; m < kM; ++m) L = __fmaf_rn(p[r][m], rec[m], L);
      a[r] = live ? attenuation(L) : 1.0f;
    }
    b = rec[kM];
    b2 = kI2 ? rec[kM + 1] : 0.0f;
  }
};

// Leaves read from the card's memory: one ray, M known at run time.
template <bool kI2>
struct GlobalLeaves {
  const float* __restrict__ paths;  // this ray's M paths
  const float* __restrict__ mu;     // [M, E]
  const float* __restrict__ i0;
  const float* __restrict__ i2;
  int e0, n_e, n_m;  // the half's first energy

  __device__ __forceinline__ void leaf(int j, bool live, float (&a)[1],
                                       float& b, float& b2) const {
    const int e = e0 + j;
    if (live) {  // live leaves lie below E
      float L = 0.0f;
      for (int m = 0; m < n_m; ++m)
        L = __fmaf_rn(__ldg(paths + m), __ldg(mu + (long long)m * n_e + e),
                      L);
      a[0] = attenuation(L);
      b = __ldg(i0 + e);
      b2 = kI2 ? __ldg(i2 + e) : 0.0f;
    } else {
      a[0] = 1.0f;
      b = 0.0f;
      b2 = 0.0f;
    }
  }
};

// One warp's sum over a half chunk, in the parent's butterfly order, for
// kR rays: P (and P2 with i2).  Leaf j is live when kFull or j < n_live;
// a dead leaf is (a, b) = (1, 0).
template <int kR, bool kI2, bool kFull, class Leaves>
__device__ __forceinline__ void half_sum(const Leaves& lv, int n_live,
                                         float (&P)[kR], float (&P2)[kR]) {
  float s4[2][kR], t4[2][kR];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    float s3[2][kR], t3[2][kR];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      float s2[2][kR], t2[2][kR];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float s1[2][kR], t1[2][kR];
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const int j = q + 2 * t + 4 * u + 8 * w;  // lane j < 16
          float aj[kR], ak[kR], bj, bk, cj, ck;
          lv.leaf(j, kFull || j < n_live, aj, bj, cj);
          lv.leaf(j + 16, kFull || j + 16 < n_live, ak, bk, ck);
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            s1[w][r] = __fmaf_rn(aj[r], bj, __fmul_rn(ak[r], bk));
            if (kI2) t1[w][r] = __fmaf_rn(aj[r], cj, __fmul_rn(ak[r], ck));
          }
        }
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          s2[u][r] = __fadd_rn(s1[0][r], s1[1][r]);
          if (kI2) t2[u][r] = __fadd_rn(t1[0][r], t1[1][r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        s3[t][r] = __fadd_rn(s2[0][r], s2[1][r]);
        if (kI2) t3[t][r] = __fadd_rn(t2[0][r], t2[1][r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      s4[q][r] = __fadd_rn(s3[0][r], s3[1][r]);
      if (kI2) t4[q][r] = __fadd_rn(t3[0][r], t3[1][r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    P[r] = __fadd_rn(s4[0][r], s4[1][r]);
    P2[r] = kI2 ? __fadd_rn(t4[0][r], t4[1][r]) : 0.0f;
  }
}

// A half with n live leaves: the full tree, the masked tree, or +0 (every
// leaf dead: fma(1, 0, 1 * 0) and its sums are +0).
template <int kR, bool kI2, class Leaves>
__device__ __forceinline__ void half_any(const Leaves& lv, int n,
                                         float (&P)[kR], float (&P2)[kR]) {
  if (n >= kHalf) {
    half_sum<kR, kI2, true>(lv, n, P, P2);
  } else if (n > 0) {
    half_sum<kR, kI2, false>(lv, n, P, P2);
  } else {
#pragma unroll
    for (int r = 0; r < kR; ++r) P[r] = P2[r] = 0.0f;
  }
}

// kR rays a thread at kT threads a block; the block's rays are
// blockIdx.x * kT * kR + threadIdx.x + k * kT, k < kR.
template <int kM, bool kI2, int kR, int kT>
__global__ void __launch_bounds__(kT)
    spectral_counts_kernel(const float* __restrict__ paths,
                           const float* __restrict__ mu,
                           const float* __restrict__ i0,
                           const float* __restrict__ i2,
                           float* __restrict__ out, float* __restrict__ var,
                           long long n_rays, int n_e) {
  constexpr int kRec = Record<kM, kI2>::kFloats;
  __shared__ __align__(16) float tab[kChunk * kRec];
  const long long first = (long long)blockIdx.x * (kT * kR) + threadIdx.x;
  float p[kR][kM];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const long long ray = first + (long long)r * kT;
#pragma unroll
    for (int m = 0; m < kM; ++m)
      p[r][m] = ray < n_rays ? __ldg(paths + ray * kM + m) : 0.0f;
  }
  float acc[kR], acc2[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) acc[r] = acc2[r] = 0.0f;
  for (int e0 = 0; e0 < n_e; e0 += kChunk) {
    __syncthreads();  // the previous chunk's records are read
    for (int i = threadIdx.x; i < kChunk * kRec; i += kT) {
      const int k = i / kChunk, j = i - k * kChunk, e = e0 + j;
      float v = 0.0f;  // the parent loads 0 past E
      if (e < n_e) {
        if (k < kM)
          v = __ldg(mu + (long long)k * n_e + e);
        else if (k == kM)
          v = __ldg(i0 + e);
        else if (kI2 && k == kM + 1)
          v = __ldg(i2 + e);
      }
      tab[j * kRec + k] = v;
    }
    __syncthreads();
    const int n = min(kChunk, n_e - e0);
    float S[kR], S2[kR];
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      float P[kR], P2[kR];
      const StagedLeaves<kM, kI2, kR> lv{tab + h * kHalf * kRec, p};
      half_any<kR, kI2>(lv, n - h * kHalf, P, P2);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        S[r] = h ? __fadd_rn(S[r], P[r]) : P[r];
        S2[r] = h ? __fadd_rn(S2[r], P2[r]) : P2[r];
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      acc[r] = __fadd_rn(acc[r], S[r]);
      if (kI2) acc2[r] = __fadd_rn(acc2[r], S2[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const long long ray = first + (long long)r * kT;
    if (ray < n_rays) {
      out[ray] = acc[r];
      if (kI2) var[ray] = acc2[r];
    }
  }
}

// Any M: a ray a thread, the paths and the table read from the card's
// memory (through L1) at every leaf.
template <bool kI2, int kT>
__global__ void __launch_bounds__(kT)
    spectral_counts_any_m_kernel(const float* __restrict__ paths,
                                 const float* __restrict__ mu,
                                 const float* __restrict__ i0,
                                 const float* __restrict__ i2,
                                 float* __restrict__ out,
                                 float* __restrict__ var, long long n_rays,
                                 int n_e, int n_m) {
  const long long ray = (long long)blockIdx.x * kT + threadIdx.x;
  if (ray >= n_rays) return;
  float acc[1] = {0.0f}, acc2[1] = {0.0f};
  for (int e0 = 0; e0 < n_e; e0 += kChunk) {
    const int n = min(kChunk, n_e - e0);
    float S[1], S2[1];
    for (int h = 0; h < 2; ++h) {
      float P[1], P2[1];
      const GlobalLeaves<kI2> lv{paths + ray * n_m, mu, i0, i2,
                                 e0 + h * kHalf, n_e, n_m};
      half_any<1, kI2>(lv, n - h * kHalf, P, P2);
      S[0] = h ? __fadd_rn(S[0], P[0]) : P[0];
      S2[0] = h ? __fadd_rn(S2[0], P2[0]) : P2[0];
    }
    acc[0] = __fadd_rn(acc[0], S[0]);
    if (kI2) acc2[0] = __fadd_rn(acc2[0], S2[0]);
  }
  out[ray] = acc[0];
  if (kI2) var[ray] = acc2[0];
}

template <int kM, bool kI2, int kR, int kT>
cudaError_t launch_m(const float* paths, const float* mu, const float* i0,
                     const float* i2, float* out, float* var,
                     long long n_rays, int n_e, cudaStream_t stream) {
  const long long per_block = (long long)kR * kT;
  const long long blocks = n_rays > 0 ? (n_rays + per_block - 1) / per_block
                                      : 1;
  spectral_counts_kernel<kM, kI2, kR, kT>
      <<<(unsigned)blocks, kT, 0, stream>>>(paths, mu, i0, i2, out, var,
                                           n_rays, n_e);
  return cudaGetLastError();
}

template <bool kI2>
cudaError_t launch_any_m(const float* paths, const float* mu,
                         const float* i0, const float* i2, float* out,
                         float* var, long long n_rays, int n_m, int n_e,
                         cudaStream_t stream) {
  const long long blocks = n_rays > 0 ? (n_rays + kThreads - 1) / kThreads
                                      : 1;
  spectral_counts_any_m_kernel<kI2, kThreads>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(paths, mu, i0, i2, out,
                                                  var, n_rays, n_e, n_m);
  return cudaGetLastError();
}

template <bool kI2, int kR, int kT>
cudaError_t launch(const float* paths, const float* mu, const float* i0,
                   const float* i2, float* out, float* var, long long n_rays,
                   int n_m, int n_e, cudaStream_t stream) {
  switch (n_m) {
#define K2_CASE(M)                                                   \
  case M:                                                            \
    return launch_m<M, kI2, kR, kT>(paths, mu, i0, i2, out, var,     \
                                    n_rays, n_e, stream);
    K2_CASE(1) K2_CASE(2) K2_CASE(3) K2_CASE(4)
    K2_CASE(5) K2_CASE(6) K2_CASE(7) K2_CASE(8)
#undef K2_CASE
    default:
      return launch_any_m<kI2>(paths, mu, i0, i2, out, var, n_rays, n_m,
                               n_e, stream);
  }
}

}  // namespace

// paths [n_rays, n_m], mu [n_m, n_e], i0 [n_e], i2 [n_e] or null, out
// [n_rays], var [n_rays] (written when i2 is given), all float32 and
// contiguous on the card.  One launch, no synchronisation.
extern "C" int dexct_spectral_counts(const float* paths, const float* mu,
                                     const float* i0, const float* i2,
                                     float* out, float* var,
                                     long long n_rays, int n_m, int n_e,
                                     void* stream) {
  if (n_rays < 0 || n_m < 0 || n_e < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (i2 != nullptr)
    return (int)launch<true, kRays, kThreads>(paths, mu, i0, i2, out, var,
                                              n_rays, n_m, n_e, s);
  return (int)launch<false, kRays, kThreads>(paths, mu, i0, i2, out, var,
                                             n_rays, n_m, n_e, s);
}
