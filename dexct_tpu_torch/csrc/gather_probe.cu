// K38 gather_vmem and K39 gather_take: the gather-rate probe,
// out[i] = tab[idx[i]] with int32 indices over a table of 32-bit words
// (float32 values or int32 labels: the copy moves bits, so one kernel
// serves both).
//
// They replace tools/bench_gather.py's two Pallas probes: pallas_gather
// (:101-108), whose body reads the table from VMEM with the index vector
// (out_ref[:] = tab_ref[idx_ref[:]], :98-99), and pallas_take (:116-123),
// the same call through jnp.take (:113-114).  K38 is the VMEM analogue:
// each block stages the whole table in shared memory (at most 48 KB,
// 12,288 words; the wrapper refuses more) and then gathers from it over a
// grid-stride loop.  K39 is the jnp.take analogue: a direct read-only
// (__ldg) gather from device memory, any table size.
//
// What bounds it on the card: the indices are read once and the output
// written once (8 bytes an element) and there is no arithmetic, so the
// bytes bound both: 2^24 elements, 134 MB, ~40 us at 3.35 TB/s.  An 800-word
// table sits in L1 or shared memory; the 512^2 label table (1 MB) in L2.
// Indices must lie in [0, n_tab), as the probe draws them: neither kernel
// checks them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kSmemWords = 48 * 1024 / 4;

__global__ void gather_vmem_kernel(const unsigned* __restrict__ tab,
                                   int n_tab, const int* __restrict__ idx,
                                   unsigned* __restrict__ out, long long n) {
  extern __shared__ unsigned s_tab[];
  for (int i = threadIdx.x; i < n_tab; i += blockDim.x) s_tab[i] = tab[i];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = s_tab[__ldg(idx + i)];
}

__global__ void gather_take_kernel(const unsigned* __restrict__ tab,
                                   const int* __restrict__ idx,
                                   unsigned* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = __ldg(tab + __ldg(idx + i));
}

unsigned grid_for(long long n) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (n + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kBlocksPerSm;
  return (unsigned)(need < cap ? need : cap);
}

}  // namespace

// tab [n_tab] 32-bit words, idx [n] int32, out [n] 32-bit words
extern "C" int dexct_gather_vmem(const void* tab, int n_tab, const void* idx,
                                 void* out, long long n, void* stream) {
  if (n_tab < 1 || n_tab > kSmemWords) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  gather_vmem_kernel<<<grid_for(n), kThreads, n_tab * sizeof(unsigned),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(tab), n_tab, static_cast<const int*>(idx),
      static_cast<unsigned*>(out), n);
  return (int)cudaGetLastError();
}

extern "C" int dexct_gather_take(const void* tab, const void* idx, void* out,
                                 long long n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  gather_take_kernel<<<grid_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(tab), static_cast<const int*>(idx),
      static_cast<unsigned*>(out), n);
  return (int)cudaGetLastError();
}
