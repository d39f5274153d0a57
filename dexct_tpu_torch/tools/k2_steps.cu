// The steps of K2's redesign as variants of one C entry, for
// tools/probe_k2.py --steps: the kernel of csrc/spectral_counts.cu at
// several rays a thread and block sizes, and the parent's own layout (a
// warp's lanes over 32 energies, the butterfly done with shuffles) over the
// same staged table.  Every variant computes the parent's association, so
// each must equal the parent bit for bit.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//     -Xcompiler -fPIC -o libk2_steps.so k2_steps.cu

#include "../csrc/spectral_counts.cu"

namespace {

// The parent's layout: a warp owns 32 consecutive rays (lane k holds ray
// k's paths), takes them one at a time, and its lanes cover the chunk's
// energies 32 h + lane; the butterfly is the parent's shuffles.
template <int kM, bool kI2>
__global__ void __launch_bounds__(128)
    lanes_kernel(const float* __restrict__ paths, const float* __restrict__ mu,
                 const float* __restrict__ i0, const float* __restrict__ i2,
                 float* __restrict__ out, float* __restrict__ var,
                 long long n_rays, int n_e) {
  constexpr int kRec = Record<kM, kI2>::kFloats;
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ __align__(16) float tab[kChunk * kRec];
  const int lane = threadIdx.x & 31;
  const long long first = (long long)blockIdx.x * 128 + (threadIdx.x & ~31);
  const long long mine = first + lane;
  float pk[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m)
    pk[m] = mine < n_rays ? __ldg(paths + mine * kM + m) : 0.0f;
  float acc = 0.0f, acc2 = 0.0f;
  for (int e0 = 0; e0 < n_e; e0 += kChunk) {
    __syncthreads();
    for (int i = threadIdx.x; i < kChunk * kRec; i += 128) {
      const int k = i / kChunk, j = i - k * kChunk, e = e0 + j;
      float v = 0.0f;
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
#pragma unroll 4
    for (int k = 0; k < 32; ++k) {
      float p[kM];
#pragma unroll
      for (int m = 0; m < kM; ++m) p[m] = __shfl_sync(kAll, pk[m], k);
      float S = 0.0f, S2 = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = h * kHalf + lane;
        const float* rec = tab + col * kRec;
        float L = 0.0f;
#pragma unroll
        for (int m = 0; m < kM; ++m) L = __fmaf_rn(p[m], rec[m], L);
        const float a = col < n ? attenuation(L) : 1.0f;
        const float b = rec[kM];
        float s = __fmaf_rn(a, b, __shfl_xor_sync(kAll, __fmul_rn(a, b), 16));
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          s = __fadd_rn(s, __shfl_xor_sync(kAll, s, o));
        s = __shfl_sync(kAll, s, 0);  // lane 0 holds the parent's sum
        S = h ? __fadd_rn(S, s) : s;
        if (kI2) {
          const float c = rec[kM + 1];
          float t =
              __fmaf_rn(a, c, __shfl_xor_sync(kAll, __fmul_rn(a, c), 16));
#pragma unroll
          for (int o = 8; o > 0; o >>= 1)
            t = __fadd_rn(t, __shfl_xor_sync(kAll, t, o));
          t = __shfl_sync(kAll, t, 0);
          S2 = h ? __fadd_rn(S2, t) : t;
        }
      }
      if (lane == k) {
        acc = __fadd_rn(acc, S);
        if (kI2) acc2 = __fadd_rn(acc2, S2);
      }
    }
  }
  if (mine < n_rays) {
    out[mine] = acc;
    if (kI2) var[mine] = acc2;
  }
}

// M in {1, 2, 6, 7, 8} (the cases' counts) at kR rays a thread and kT
// threads; any other M runs the library's any-M kernel
template <bool kI2, int kR, int kT>
cudaError_t launch_step(const float* paths, const float* mu, const float* i0,
                        const float* i2, float* out, float* var,
                        long long n_rays, int n_m, int n_e, cudaStream_t s) {
  switch (n_m) {
    case 1: return launch_m<1, kI2, kR, kT>(paths, mu, i0, i2, out, var,
                                            n_rays, n_e, s);
    case 2: return launch_m<2, kI2, kR, kT>(paths, mu, i0, i2, out, var,
                                            n_rays, n_e, s);
    case 6: return launch_m<6, kI2, kR, kT>(paths, mu, i0, i2, out, var,
                                            n_rays, n_e, s);
    case 7: return launch_m<7, kI2, kR, kT>(paths, mu, i0, i2, out, var,
                                            n_rays, n_e, s);
    case 8: return launch_m<8, kI2, kR, kT>(paths, mu, i0, i2, out, var,
                                            n_rays, n_e, s);
    default: return launch_any_m<kI2>(paths, mu, i0, i2, out, var, n_rays,
                                      n_m, n_e, s);
  }
}

template <int kM, bool kI2>
cudaError_t launch_lanes_m(const float* paths, const float* mu,
                           const float* i0, const float* i2, float* out,
                           float* var, long long n_rays, int n_e,
                           cudaStream_t s) {
  const long long blocks = n_rays > 0 ? (n_rays + 127) / 128 : 1;
  lanes_kernel<kM, kI2><<<(unsigned)blocks, 128, 0, s>>>(
      paths, mu, i0, i2, out, var, n_rays, n_e);
  return cudaGetLastError();
}

template <bool kI2>
cudaError_t launch_lanes(const float* paths, const float* mu,
                         const float* i0, const float* i2, float* out,
                         float* var, long long n_rays, int n_m, int n_e,
                         cudaStream_t s) {
  switch (n_m) {
    case 1: return launch_lanes_m<1, kI2>(paths, mu, i0, i2, out, var,
                                          n_rays, n_e, s);
    case 2: return launch_lanes_m<2, kI2>(paths, mu, i0, i2, out, var,
                                          n_rays, n_e, s);
    case 6: return launch_lanes_m<6, kI2>(paths, mu, i0, i2, out, var,
                                          n_rays, n_e, s);
    case 7: return launch_lanes_m<7, kI2>(paths, mu, i0, i2, out, var,
                                          n_rays, n_e, s);
    case 8: return launch_lanes_m<8, kI2>(paths, mu, i0, i2, out, var,
                                          n_rays, n_e, s);
    default: return launch_any_m<kI2>(paths, mu, i0, i2, out, var, n_rays,
                                      n_m, n_e, s);
  }
}

template <bool kI2>
cudaError_t step(int variant, const float* paths, const float* mu,
                 const float* i0, const float* i2, float* out, float* var,
                 long long n_rays, int n_m, int n_e, cudaStream_t s) {
  switch (variant) {
    case 0: return launch_step<kI2, 1, 128>(paths, mu, i0, i2, out, var,
                                            n_rays, n_m, n_e, s);
    case 1: return launch_step<kI2, 2, 128>(paths, mu, i0, i2, out, var,
                                            n_rays, n_m, n_e, s);
    case 2: return launch_step<kI2, 4, 128>(paths, mu, i0, i2, out, var,
                                            n_rays, n_m, n_e, s);
    case 3: return launch_step<kI2, 2, 256>(paths, mu, i0, i2, out, var,
                                            n_rays, n_m, n_e, s);
    case 4: return launch_step<kI2, 4, 64>(paths, mu, i0, i2, out, var,
                                           n_rays, n_m, n_e, s);
    case 5: return launch_lanes<kI2>(paths, mu, i0, i2, out, var, n_rays,
                                     n_m, n_e, s);
    case 6: return launch_step<kI2, 2, 512>(paths, mu, i0, i2, out, var,
                                            n_rays, n_m, n_e, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int k2_step(int variant, const float* paths, const float* mu,
                       const float* i0, const float* i2, float* out,
                       float* var, long long n_rays, int n_m, int n_e,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (i2 != nullptr)
    return (int)step<true>(variant, paths, mu, i0, i2, out, var, n_rays,
                           n_m, n_e, s);
  return (int)step<false>(variant, paths, mu, i0, i2, out, var, n_rays, n_m,
                          n_e, s);
}
