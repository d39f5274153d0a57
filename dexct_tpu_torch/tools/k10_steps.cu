// The steps of K10's redesign as kernel variants, for
// tools/probe_siddon_trace_3d.py --steps (not part of the package's kernel
// library).
//
// Variant 0 is K10 as it stood before the redesign (csrc/siddon_trace_3d.cu
// at that commit): one thread per ray in 256-thread blocks walking with
// walk_step (a 64-bit cell, the axis chosen by if/else, the exit tested
// every step), the M sums in registers (M a template parameter: 1 to 8,
// 16, 32), each segment added to every sum through a select, M strided
// stores a thread.  k10v_kernel<V> is variant V, each adding one step of
// the redesign to the one before it (Cfg<V> names its settings): 1 the
// 32-bit walk of siddon_walk_3d.cuh (walk32_run, step32) with the
// register selects kept and the exit tested every step, 2 the exit tested
// every 16 steps, 3 the sums in shared memory (a row per material and a
// dump row for labels >= n_materials), 4 the warp's vote between the
// labels and their x/y-swapped copy (the kept design: csrc/
// siddon_trace_3d.cu), 5 the block's tile of the output written coalesced
// from shared memory, 6 and 7 as 5 at 128 and 512 threads a block, 8, 9
// and 10 as 4 with the exit tested every step, every 8 steps, and at 512
// threads a block.  Every variant adds each material's segments in step
// order with round-to-nearest adds, so all agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../csrc/siddon_walk_3d.cuh"

namespace {

using dexct_walk3d::Grid;
using dexct_walk3d::Walk;
using dexct_walk3d::Walk32;

template <int M>
__global__ void parent_kernel(const uint8_t* __restrict__ labels,
                              const float* __restrict__ src,
                              const float* __restrict__ dirs,
                              float* __restrict__ out, long long n_rays,
                              int n_out, Grid g, int n_steps) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  Walk w = dexct_walk3d::walk_start(g, src[3 * r], src[3 * r + 1],
                                    src[3 * r + 2], dirs[3 * r],
                                    dirs[3 * r + 1], dirs[3 * r + 2]);
  float acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.0f;
  for (int k = 0; k < n_steps && w.t < w.t_out; ++k) {
    long long cell;
    const float seg = dexct_walk3d::walk_step(w, g, cell);
    const int lab = __ldg(labels + cell);
#pragma unroll
    for (int m = 0; m < M; ++m) acc[m] += (lab == m) ? seg : 0.0f;
  }
  float* o = out + r * n_out;
#pragma unroll
  for (int m = 0; m < M; ++m)
    if (m < n_out) o[m] = acc[m];
}

// the settings of variant V: the exit tested every kExit steps, the sums
// in shared memory (else M registers), the vote between the two layouts,
// the output written from shared memory in coalesced stores, threads a
// block
template <int V> struct Cfg;
template <> struct Cfg<1> {
  static constexpr int kExit = 1, kThreads = 256;
  static constexpr bool kShared = false, kVote = false, kCoalesced = false;
};
template <> struct Cfg<2> {
  static constexpr int kExit = 16, kThreads = 256;
  static constexpr bool kShared = false, kVote = false, kCoalesced = false;
};
template <> struct Cfg<3> {
  static constexpr int kExit = 16, kThreads = 256;
  static constexpr bool kShared = true, kVote = false, kCoalesced = false;
};
template <> struct Cfg<4> {
  static constexpr int kExit = 16, kThreads = 256;
  static constexpr bool kShared = true, kVote = true, kCoalesced = false;
};
template <> struct Cfg<5> {
  static constexpr int kExit = 16, kThreads = 256;
  static constexpr bool kShared = true, kVote = true, kCoalesced = true;
};
template <> struct Cfg<6> {
  static constexpr int kExit = 16, kThreads = 128;
  static constexpr bool kShared = true, kVote = true, kCoalesced = true;
};
template <> struct Cfg<7> {
  static constexpr int kExit = 16, kThreads = 512;
  static constexpr bool kShared = true, kVote = true, kCoalesced = true;
};
// 4 (the kept design) with the exit tested every step, every 8 steps, and
// at 512 threads a block
template <> struct Cfg<8> {
  static constexpr int kExit = 1, kThreads = 256;
  static constexpr bool kShared = true, kVote = true, kCoalesced = false;
};
template <> struct Cfg<9> {
  static constexpr int kExit = 8, kThreads = 256;
  static constexpr bool kShared = true, kVote = true, kCoalesced = false;
};
template <> struct Cfg<10> {
  static constexpr int kExit = 16, kThreads = 512;
  static constexpr bool kShared = true, kVote = true, kCoalesced = false;
};

// M: the register sums' count (variants 1, 2), 0 for shared sums
template <int V, int M>
__global__ void __launch_bounds__(Cfg<V>::kThreads) k10v_kernel(
    const uint8_t* __restrict__ labels, const uint8_t* __restrict__ labels_yx,
    const float* __restrict__ src, const float* __restrict__ dirs,
    float* __restrict__ out, long long n_rays, int n_mat, Grid g,
    int n_steps) {
  using C = Cfg<V>;
  constexpr int T = C::kThreads;
  extern __shared__ float sums[];  // [n_mat + 1][T] when C::kShared
  const int lane = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * T;
  const long long r = r0 + lane;
  const bool live = r < n_rays;
  if (C::kShared)
    for (int m = 0; m <= n_mat; ++m) sums[m * T + lane] = 0.0f;
  const long long q = live ? r : 0;
  const float px = src[3 * q], py = src[3 * q + 1], pz = src[3 * q + 2];
  const float ux = dirs[3 * q], uy = dirs[3 * q + 1], uz = dirs[3 * q + 2];
  const Walk w0 = dexct_walk3d::walk_start(g, px, py, pz, ux, uy, uz);
  bool swapped = false;
  if (C::kVote) {
    const bool x_face = dexct_walk3d::enters_by_x(g, px, py, ux, uy);
    const unsigned lanes = __ballot_sync(0xffffffffu, live);
    const unsigned votes = __ballot_sync(0xffffffffu, live && x_face);
    swapped = 2 * __popc(votes) > __popc(lanes);
  }
  float acc[M > 0 ? M : 1];
#pragma unroll
  for (int m = 0; m < (M > 0 ? M : 1); ++m) acc[m] = 0.0f;
  if (live) {
    const uint8_t* lab = swapped ? labels_yx : labels;
    Walk32 w = swapped ? dexct_walk3d::walk32(w0, g, g.ny, 1)
                       : dexct_walk3d::walk32(w0, g, 1, g.nx);
    if (C::kShared) {
      float* col = sums + lane;
      auto add = [&](float seg, int o) {
        float* s = col + min((int)__ldg(lab + o), n_mat) * T;
        *s = __fadd_rn(*s, seg);
      };
      dexct_walk3d::walk32_run<C::kExit>(w, n_steps, add);
    } else {
      auto add = [&](float seg, int o) {
        const int l = __ldg(lab + o);
#pragma unroll
        for (int m = 0; m < (M > 0 ? M : 1); ++m)
          acc[m] += (l == m) ? seg : 0.0f;
      };
      dexct_walk3d::walk32_run<C::kExit>(w, n_steps, add);
    }
  }
  if (C::kCoalesced) {
    __syncthreads();
    const int n_here = (int)min((long long)T, n_rays - r0);
    float* o = out + r0 * n_mat;
    for (int i = lane; i < n_here * n_mat; i += T) {
      const int ray = i / n_mat;
      o[i] = sums[(i - ray * n_mat) * T + ray];
    }
  } else if (live) {
    float* o = out + r * n_mat;
    if (C::kShared) {
      for (int m = 0; m < n_mat; ++m) o[m] = sums[m * T + lane];
    } else {
#pragma unroll
      for (int m = 0; m < (M > 0 ? M : 1); ++m)
        if (m < n_mat) o[m] = acc[m];
    }
  }
}

template <int M>
void launch_parent(const uint8_t* l, const float* s, const float* d,
                   float* o, long long n, int n_out, const Grid& g, int steps,
                   cudaStream_t st) {
  parent_kernel<M><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      l, s, d, o, n, n_out, g, steps);
}

template <int V, int M>
cudaError_t launch_step(const uint8_t* l, const uint8_t* l_yx,
                        const float* s, const float* d, float* o, long long n,
                        int n_mat, const Grid& g, int steps,
                        cudaStream_t st) {
  constexpr int T = Cfg<V>::kThreads;
  const int smem = Cfg<V>::kShared ? 4 * (n_mat + 1) * T : 0;
  cudaError_t err = cudaFuncSetAttribute(
      k10v_kernel<V, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  k10v_kernel<V, M><<<(unsigned)((n + T - 1) / T), T, smem, st>>>(
      l, l_yx, s, d, o, n, n_mat, g, steps);
  return cudaGetLastError();
}

// the register variants' template on M, as the parent's switch
template <int V>
cudaError_t launch_registers(const uint8_t* l, const float* s,
                             const float* d, float* o, long long n, int n_mat,
                             const Grid& g, int steps, cudaStream_t st) {
#define DEXCT_CASE(MM) \
  return launch_step<V, MM>(l, nullptr, s, d, o, n, n_mat, g, steps, st)
  switch (n_mat) {
    case 1: DEXCT_CASE(1);
    case 2: DEXCT_CASE(2);
    case 3: DEXCT_CASE(3);
    case 4: DEXCT_CASE(4);
    case 5: DEXCT_CASE(5);
    case 6: DEXCT_CASE(6);
    case 7: DEXCT_CASE(7);
    case 8: DEXCT_CASE(8);
    default:
      if (n_mat <= 16) DEXCT_CASE(16);
      if (n_mat <= 32) DEXCT_CASE(32);
      return cudaErrorInvalidValue;
  }
#undef DEXCT_CASE
}

}  // namespace

// variant, labels [nz, ny, nx], labels_yx [nz, nx, ny] (scratch), then
// dexct_siddon_trace_3d's arguments from n_rays on
extern "C" int k10_step(int variant, const void* labels, void* labels_yx,
                        const void* src, const void* dirs, void* out,
                        long long n_rays, int nx, int ny, int nz,
                        int n_materials, float x0, float y0, float z0,
                        float x1, float y1, float z1, float dx, float dy,
                        float dz, float eps, int n_steps, void* stream) {
  if (n_rays <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* l = static_cast<const uint8_t*>(labels);
  uint8_t* l_yx = static_cast<uint8_t*>(labels_yx);
  const float* s = static_cast<const float*>(src);
  const float* d = static_cast<const float*>(dirs);
  float* o = static_cast<float*>(out);
  const Grid g{nx, ny, nz, x0, y0, z0, x1, y1, z1, dx, dy, dz, eps};
  if (variant >= 4) {
    const cudaError_t err =
        dexct_walk3d::launch_swap_xy(l, l_yx, nx, ny, nz, st);
    if (err != cudaSuccess) return (int)err;
  }
  switch (variant) {
    case 0:
      switch (n_materials) {
        case 1: launch_parent<1>(l, s, d, o, n_rays, 1, g, n_steps, st); break;
        case 2: launch_parent<2>(l, s, d, o, n_rays, 2, g, n_steps, st); break;
        case 3: launch_parent<3>(l, s, d, o, n_rays, 3, g, n_steps, st); break;
        case 4: launch_parent<4>(l, s, d, o, n_rays, 4, g, n_steps, st); break;
        case 5: launch_parent<5>(l, s, d, o, n_rays, 5, g, n_steps, st); break;
        case 6: launch_parent<6>(l, s, d, o, n_rays, 6, g, n_steps, st); break;
        case 7: launch_parent<7>(l, s, d, o, n_rays, 7, g, n_steps, st); break;
        case 8: launch_parent<8>(l, s, d, o, n_rays, 8, g, n_steps, st); break;
        default:
          if (n_materials <= 16)
            launch_parent<16>(l, s, d, o, n_rays, n_materials, g, n_steps,
                              st);
          else if (n_materials <= 32)
            launch_parent<32>(l, s, d, o, n_rays, n_materials, g, n_steps,
                              st);
          else
            return (int)cudaErrorInvalidValue;
      }
      return (int)cudaGetLastError();
    case 1:
      return (int)launch_registers<1>(l, s, d, o, n_rays, n_materials, g,
                                      n_steps, st);
    case 2:
      return (int)launch_registers<2>(l, s, d, o, n_rays, n_materials, g,
                                      n_steps, st);
    case 3:
      return (int)launch_step<3, 0>(l, l_yx, s, d, o, n_rays, n_materials,
                                    g, n_steps, st);
    case 4:
      return (int)launch_step<4, 0>(l, l_yx, s, d, o, n_rays, n_materials,
                                    g, n_steps, st);
    case 5:
      return (int)launch_step<5, 0>(l, l_yx, s, d, o, n_rays, n_materials,
                                    g, n_steps, st);
    case 6:
      return (int)launch_step<6, 0>(l, l_yx, s, d, o, n_rays, n_materials,
                                    g, n_steps, st);
    case 7:
      return (int)launch_step<7, 0>(l, l_yx, s, d, o, n_rays, n_materials,
                                    g, n_steps, st);
    case 8:
      return (int)launch_step<8, 0>(l, l_yx, s, d, o, n_rays, n_materials,
                                    g, n_steps, st);
    case 9:
      return (int)launch_step<9, 0>(l, l_yx, s, d, o, n_rays, n_materials,
                                    g, n_steps, st);
    case 10:
      return (int)launch_step<10, 0>(l, l_yx, s, d, o, n_rays, n_materials,
                                     g, n_steps, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
