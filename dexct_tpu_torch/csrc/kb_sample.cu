// K7 kb_sample: Kaiser-Bessel gridding sample of the 2-D spectra of M
// material images along ntheta radial lines (the Fourier-slice projector),
// and K21, its adjoint (below).
//
// Replaces the sampler of dexct_tpu/ops/fourier.py:_radon_from_images.
// The TPU program builds a table of 16 rolled copies of the spectrum,
// [G^2, 16 * 2M] floats (201 MB at G = 512, M = 6), so that one row gather
// fetches the whole 4 x 4 window of every re/im channel of a sample; the
// gather count, not the bytes, sets a TPU's rate.  Here each sample reads
// its 16 window taps straight from the spectrum F [M, G, G] (complex64, 12.6
// MB at the reference protocol: it stays in the 50 MB L2), with the window
// base from slice_idx and the four row and four column offsets wrapped mod
// G.  No table is built.
//
// What bounds it on the card: 16 * M complex L2 reads (768 bytes at M = 6)
// and 16 * M * 4 float ops per sample, ntheta * nl = 1024 x 257 samples:
// 0.2 GB of L2 traffic.  Design: one thread per (theta, l) sample; the 16
// weights, the 4 row and 4 column offsets and the phase stay in registers
// across the loop over materials; neighbouring threads are neighbouring
// radii of one line, whose windows overlap, so their reads share lines.
// The output is complex64 [M, ntheta, nl], the layout torch.fft.irfft takes
// along its last axis.
//
// Per sample, as the JAX program: z = sum_{i,j} w[i*4 + j] *
// F[(vb + j) % G, (ub + i) % G] for re and im, then spec = z * (cos phi +
// i sin phi) with the host phase table.

#include <cuda_runtime.h>

namespace {

__global__ void kb_sample_kernel(const float2* __restrict__ F,
                                 const int* __restrict__ base,
                                 const float* __restrict__ w,
                                 const float* __restrict__ phase_cos,
                                 const float* __restrict__ phase_sin,
                                 float2* __restrict__ out, int S, int M,
                                 int G) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int plane = G * G;
  int b = __ldg(base + s);
  b = b < 0 ? 0 : (b >= plane ? plane - 1 : b);  // the JAX gather's clamp
  const int vb = b / G, ub = b % G;
  int rows[4], cols[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    rows[j] = ((vb + j) % G) * G;
    cols[j] = (ub + j) % G;
  }
  float wt[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) wt[k] = __ldg(w + (size_t)s * 16 + k);
  const float pc = __ldg(phase_cos + s), ps = __ldg(phase_sin + s);
  for (int m = 0; m < M; ++m) {
    const float2* Fm = F + (size_t)m * plane;
    float re = 0.0f, im = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 z = __ldg(Fm + rows[j] + cols[i]);
        re += wt[i * 4 + j] * z.x;
        im += wt[i * 4 + j] * z.y;
      }
    }
    out[(size_t)m * S + s] =
        make_float2(__fsub_rn(__fmul_rn(re, pc), __fmul_rn(im, ps)),
                    __fadd_rn(__fmul_rn(re, ps), __fmul_rn(im, pc)));
  }
}

// K21 kb_sample_adjoint: the adjoint of K7 (dexct_tpu/ops/fourier.py:258
// transposed by jax.linear_transpose in ops/iterative.py and jax.grad in
// ops/onestep.py), in gather form over the plan's transposed taps.  Each
// (theta, l) sample's incoming complex gradient, times the conjugate
// phase, times its 16 KB weights, lands in the spectrum's gradient F [M,
// G, G]: the transpose of K7's real-linear map in the (re, im) pairing
// that torch's autograd uses, so it serves both the explicit A^T and the
// backward pass.  The window base is clamped and the offsets wrapped as K7
// does, so <K7 x, y> = <x, K21 y> holds for the pair.
//
// The first design zero-filled F and let every sample scatter its 16 M
// complex products with float32 atomicAdd: 0.115 ms at the reference
// plan, 16x its bound, in an order that changed from run to run.
//
// Here the taps come transposed, once per plan (kb_transpose in
// ops/fourier.py): a CSR over the G^2 cells, row_ptr [G^2 + 1] and for
// every tap an 8-byte record (sample, weight bits), each cell's taps in
// the stable (cell, s * 16 + k) order; rows [G^2] lists the cells by
// decreasing count of kBatch-tap batches.  Two launches:
// 1. z = g * conj(phase) per sample, formed with _rn arithmetic as the
//    plain version forms it, into scratch with a sample's images side by
//    side (8 or 16 bytes), so that a tap gathers one vector, not g and
//    two phases from three places;
// 2. each cell sums __fmul_rn(z, w) with __fadd_rn from 0 in its row's
//    order and writes its element of every image once: no zero fill, no
//    atomics, the same bits in every launch, and the sums of the CPU's
//    index_add_, which adds the same products into each cell in the same
//    order.
//
// Row lengths run from 0 to ~3900 (~3.8 ntheta): the cells around DC
// collect every line's l = 0 and l = 1 windows, and the median row holds
// 14-28 taps.  An in-order sum is a chain of dependent adds, so the
// longest row bounds the launch (~4 cycles an add).  Two kinds of rows in
// launch 2:
// - the n_long rows of more than KB_WARP_ROW (64) taps, first in rows and
//   so first on the card: a warp each.  The warp reads 128 records at a
//   time, coalesced, four per lane, forms their products in parallel into
//   shared memory (+0 past the row's end, which leaves a sum unchanged),
//   and one lane per (image, re/im) adds them in order, four at a time
//   from a float4.  Three stages overlap: the records of chunk i + 2 and
//   the gathers of chunk i + 1 are in flight while chunk i is summed.
// - every other row, empty rows included: a thread each, its taps kBatch
//   at a time with every load of a batch in flight.  These rows come
//   sorted by their count of batches, cells of one count in cell order
//   (neighbouring threads take neighbouring cells, whose taps come from
//   the same lines, so their z gathers share sectors), and their records
//   again as a sliced ELLPACK (a warp's j-th taps are 256 contiguous
//   bytes).
//
// What bounds it on the card: the function's bytes (g, the plan's tables
// and F, each moved once: 0.0072 ms at the reference plan).  The design's
// own floor is higher: the records (8 bytes a tap: 34 MB at the reference
// plan, 67 MB at the one-step plan; the short rows' from the ELLPACK),
// row_ptr and rows (4 bytes a cell each) read once, z written and then
// gathered from L2 (a cell's neighbouring taps come from neighbouring
// radii of one line, in one sector), F written once; and the longest
// row's chain of ~3900 dependent adds.  Chunks of 256 taps, batches of 4
// or 16 taps, a split of long rows between a producer and a consumer warp
// and a warp from 32 or 128 taps up measured slower at one plan or more
// (NVIDIA H100 80GB HBM3, 700 W).
constexpr int kWarps = 4;               // long rows a block
constexpr int kThreads = 32 * kWarps;
constexpr int kPerLane = 4;             // records a lane loads per chunk
constexpr int kChunk = 32 * kPerLane;   // taps a warp takes at a time
constexpr int kPitch = kChunk + 4;      // floats a chain's row, 16-B rows
constexpr int kBatch = 8;               // taps a short row's thread loads

// z [groups][S][MB] float2: group q holds images q MB .. q MB + MB - 1 of
// each sample (0 past the last image)
template <int MB>
__global__ void conj_phase_kernel(const float2* __restrict__ g,
                                  const float* __restrict__ phase_cos,
                                  const float* __restrict__ phase_sin,
                                  float2* __restrict__ z, int S, int M) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const float pc = __ldg(phase_cos + s), ps = __ldg(phase_sin + s);
  for (int m0 = 0; m0 < M; m0 += MB) {
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      float2 v = make_float2(0.0f, 0.0f);
      if (m0 + m < M) {
        const float2 x = __ldg(g + (long long)(m0 + m) * S + s);
        v.x = __fadd_rn(__fmul_rn(x.x, pc), __fmul_rn(x.y, ps));
        v.y = __fsub_rn(__fmul_rn(x.y, pc), __fmul_rn(x.x, ps));
      }
      z[((long long)(m0 / MB) * S + s) * MB + m] = v;
    }
  }
}

// z of MB images of sample group entry i (in MB-float2 units)
template <int MB>
__device__ __forceinline__ void load_z(const float2* __restrict__ z,
                                       long long i, float2 (&out)[MB]) {
  if constexpr (MB == 2) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(z) + i);
    out[0] = make_float2(q.x, q.y);
    out[1] = make_float2(q.z, q.w);
  } else {
    out[0] = __ldg(z + i);
  }
}

// acc + v.x + v.y + v.z + v.w, in that order
__device__ __forceinline__ float add4(float acc, float4 v) {
  acc = __fadd_rn(acc, v.x);
  acc = __fadd_rn(acc, v.y);
  acc = __fadd_rn(acc, v.z);
  return __fadd_rn(acc, v.w);
}

// one thread sums short row c, of rank i among the short rows, for every
// image, MB images at a time; its j-th tap at ell[ell_offset[i / 32] + 32 j
// + i % 32]
template <int MB>
__device__ void adjoint_row_thread(const float2* __restrict__ z,
                                   const int* __restrict__ row_ptr,
                                   const int2* __restrict__ ell,
                                   const int* __restrict__ ell_offset,
                                   float2* __restrict__ F, int c, int i,
                                   int S, int M, int n_cells) {
  const int n = __ldg(row_ptr + c + 1) - __ldg(row_ptr + c);
  const int2* ent = ell + __ldg(ell_offset + (i >> 5)) + (i & 31);
  for (int m0 = 0; m0 < M; m0 += MB) {
    const long long zg = (long long)(m0 / MB) * S;
    float re[MB], im[MB];
#pragma unroll
    for (int m = 0; m < MB; ++m) re[m] = im[m] = 0.0f;
    for (int j0 = 0; j0 < n; j0 += kBatch) {
      int2 e[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        e[u] = j0 + u < n ? __ldg(ent + 32 * (j0 + u)) : make_int2(0, 0);
      float2 zz[kBatch][MB];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) load_z<MB>(z, zg + e[u].x, zz[u]);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (j0 + u < n) {
          const float w = __int_as_float(e[u].y);
#pragma unroll
          for (int m = 0; m < MB; ++m) {
            re[m] = __fadd_rn(re[m], __fmul_rn(zz[u][m].x, w));
            im[m] = __fadd_rn(im[m], __fmul_rn(zz[u][m].y, w));
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MB; ++m)
      if (m0 + m < M)
        F[(long long)(m0 + m) * n_cells + c] = make_float2(re[m], im[m]);
  }
}

// one warp sums row c; buf [2][2 * MB][kPitch] floats of shared memory
template <int MB>
__device__ void adjoint_row_warp(const float2* __restrict__ z,
                                 const int* __restrict__ row_ptr,
                                 const int2* __restrict__ ent,
                                 float* __restrict__ F, int c, int S, int M,
                                 int n_cells, float* buf) {
  const int lane = threadIdx.x & 31;
  const int lo = __ldg(row_ptr + c), hi = __ldg(row_ptr + c + 1);
  constexpr int kBuf = 2 * MB * kPitch;
  for (int m0 = 0; m0 < M; m0 += MB) {
    const int nm = M - m0 < MB ? M - m0 : MB;
    const long long zg = (long long)(m0 / MB) * S;
    int2 ra[kPerLane], rb[kPerLane];
    float2 zz[kPerLane][MB];
    auto load_records = [&](int base, int2 (&r)[kPerLane]) {
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        const int j = base + 32 * u + lane;
        r[u] = j < hi ? __ldg(ent + j) : make_int2(0, 0);
      }
    };
    auto gather = [&](const int2 (&r)[kPerLane]) {
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) load_z<MB>(z, zg + r[u].x, zz[u]);
    };
    // the products of the chunk at base into b[2 m + (0 re, 1 im)][slot]
    auto products = [&](int base, const int2 (&r)[kPerLane], float* b) {
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        const int slot = 32 * u + lane;
        const bool live = base + slot < hi;
        const float w = __int_as_float(r[u].y);
#pragma unroll
        for (int m = 0; m < MB; ++m) {
          b[(2 * m) * kPitch + slot] =
              live ? __fmul_rn(zz[u][m].x, w) : 0.0f;
          b[(2 * m + 1) * kPitch + slot] =
              live ? __fmul_rn(zz[u][m].y, w) : 0.0f;
        }
      }
    };
    float acc = 0.0f;  // lane q < 2 nm: image m0 + q / 2, re (q even) or im
    load_records(lo, ra);
    gather(ra);
    load_records(lo + kChunk, rb);
    products(lo, ra, buf);
    int it = 0;
    for (int base = lo; base < hi; base += kChunk, ++it) {
      float* cur = buf + (it & 1) * kBuf;
      float* nxt = buf + ((it + 1) & 1) * kBuf;
      __syncwarp();
      const bool more = base + kChunk < hi;
      if (more) {
        gather(rb);  // chunk it + 1, whose records came during chunk it - 1
#pragma unroll
        for (int u = 0; u < kPerLane; ++u) ra[u] = rb[u];
        load_records(base + 2 * kChunk, rb);
      }
      if (lane < 2 * nm) {  // chunk it, in order (+0 past the row's end)
        const auto* row =
            reinterpret_cast<const float4*>(cur + lane * kPitch);
        if (hi - base >= kChunk) {  // four float4 loads ahead of the adds
          float4 v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) v[q] = row[q];
#pragma unroll
          for (int q = 0; q < kChunk / 4; ++q) {
            const float4 x = v[q & 3];
            if (q + 4 < kChunk / 4) v[q & 3] = row[q + 4];
            acc = add4(acc, x);
          }
        } else {
          for (int q0 = 0; q0 < (hi - base + 3) / 4; q0 += 8) {
            float4 v[8];
#pragma unroll
            for (int q = 0; q < 8; ++q) v[q] = row[q0 + q];
#pragma unroll
            for (int q = 0; q < 8; ++q) acc = add4(acc, v[q]);
          }
        }
      }
      if (more) products(base + kChunk, ra, nxt);
    }
    if (lane < 2 * nm)
      F[((long long)(m0 + (lane >> 1)) * n_cells + c) * 2 + (lane & 1)] =
          acc;
    __syncwarp();  // the next group of images reuses buf
  }
}

// blocks [0, blocks_long): kWarps long rows each; then kThreads rows each
template <int MB>
__global__ void __launch_bounds__(kThreads)
    kb_sample_adjoint_kernel(const float2* __restrict__ z,
                             const int* __restrict__ row_ptr,
                             const int2* __restrict__ ent,
                             const int* __restrict__ rows,
                             const int2* __restrict__ ell,
                             const int* __restrict__ ell_offset,
                             float2* __restrict__ F, int S, int M,
                             int n_cells, int n_long, int blocks_long) {
  __shared__ __align__(16) float buf[kWarps][2 * 2 * MB * kPitch];
  if ((int)blockIdx.x < blocks_long) {
    const int warp = threadIdx.x >> 5;
    const int r = blockIdx.x * kWarps + warp;
    if (r >= n_long) return;  // the whole warp
    adjoint_row_warp<MB>(z, row_ptr, ent, reinterpret_cast<float*>(F),
                         __ldg(rows + r), S, M, n_cells, buf[warp]);
  } else {
    const int i = (blockIdx.x - blocks_long) * kThreads + threadIdx.x;
    if (i >= n_cells - n_long) return;
    adjoint_row_thread<MB>(z, row_ptr, ell, ell_offset, F,
                           __ldg(rows + n_long + i), i, S, M, n_cells);
  }
}

template <int MB>
void launch_adjoint(const float2* g, const int* row_ptr, const int2* ent,
                    const int* rows, const int2* ell, const int* ell_offset,
                    const float* pc, const float* ps, float2* z, float2* F,
                    int S, int M, int n_cells, int n_long, cudaStream_t st) {
  if (S > 0)
    conj_phase_kernel<MB><<<(S + 255) / 256, 256, 0, st>>>(g, pc, ps, z, S,
                                                           M);
  const int blocks_long = (n_long + kWarps - 1) / kWarps;
  const int blocks =
      blocks_long + (n_cells - n_long + kThreads - 1) / kThreads;
  kb_sample_adjoint_kernel<MB><<<blocks, kThreads, 0, st>>>(
      z, row_ptr, ent, rows, ell, ell_offset, F, S, M, n_cells, n_long,
      blocks_long);
}

}  // namespace

// F [M, G, G] complex64; base [S] int32; w [S, 16]; phase_cos/sin [S];
// out [M, S] complex64
extern "C" int dexct_kb_sample(const void* F, const void* base,
                               const void* w, const void* phase_cos,
                               const void* phase_sin, void* out, int S, int M,
                               int G, void* stream) {
  if (S <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  kb_sample_kernel<<<(S + threads - 1) / threads, threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(F), static_cast<const int*>(base),
      static_cast<const float*>(w), static_cast<const float*>(phase_cos),
      static_cast<const float*>(phase_sin), static_cast<float2*>(out), S, M,
      G);
  return (int)cudaGetLastError();
}

// g [M, S] complex64; the transposed taps row_ptr [n_cells + 1], entries
// [16 S] int2 (sample, weight bits), rows [n_cells] (the first n_long
// longer than 64 taps), the short rows' ELLPACK ell (int2) and ell_offset
// [ceil((n_cells - n_long) / 32) + 1]; phase_cos/sin [S]; z scratch [S]
// complex64 at M = 1, else [ceil(M / 2) * 2 * S]; F [M, n_cells]
// complex64, every element written
extern "C" int dexct_kb_sample_adjoint(const void* g, const void* row_ptr,
                                       const void* entries, const void* rows,
                                       const void* ell,
                                       const void* ell_offset,
                                       const void* phase_cos,
                                       const void* phase_sin, void* z,
                                       void* F, int S, int M, int n_cells,
                                       int n_long, void* stream) {
  if (S < 0 || M < 0 || n_cells < 0 || n_long < 0 || n_long > n_cells)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || n_cells == 0) return (int)cudaGetLastError();
  const auto* gp = static_cast<const float2*>(g);
  const auto* rp = static_cast<const int*>(row_ptr);
  const auto* ep = static_cast<const int2*>(entries);
  const auto* rw = static_cast<const int*>(rows);
  const auto* el = static_cast<const int2*>(ell);
  const auto* eo = static_cast<const int*>(ell_offset);
  const auto* pc = static_cast<const float*>(phase_cos);
  const auto* ps = static_cast<const float*>(phase_sin);
  auto* zp = static_cast<float2*>(z);
  auto* fp = static_cast<float2*>(F);
  const auto st = static_cast<cudaStream_t>(stream);
  if (M == 1)  // beyond one image, pairs of images (a last one alone)
    launch_adjoint<1>(gp, rp, ep, rw, el, eo, pc, ps, zp, fp, S, M, n_cells,
                      n_long, st);
  else
    launch_adjoint<2>(gp, rp, ep, rw, el, eo, pc, ps, zp, fp, S, M, n_cells,
                      n_long, st);
  return (int)cudaGetLastError();
}
