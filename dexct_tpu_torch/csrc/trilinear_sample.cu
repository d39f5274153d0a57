// K16 trilinear_sample: trilinear samples of K stacked volumes at
// continuous (z, y, x) indices, 0 outside the index box.
//
// Replaces dexct_tpu/ops/conebeam.py:_trilinear_volume_sample, the one
// gather pass of the tilted-gantry FDK that resamples the gantry-frame
// volumes onto the patient grid.  The TPU program gathers the eight corners
// of every point with jnp fancy indexing.
//
// The first design ran one thread per (output point, volume) over
// three index tensors that the wrapper had broadcast to the output shape
// and copied (three dense float32 copies, 12.6 MB at the tilted cone
// protocol, written and read back), and every thread read its point's
// indices and formed its floors, fractions and eight corner offsets once
// for each of the K volumes: four times at the tilted shape.
//
// This design: one thread per output point, the K volumes in its loop.  The
// indices arrive as the broadcast views they are: the wrapper passes the
// output's shape as three axes and each index tensor's element strides,
// 0 on broadcast axes (the tilted path's zi, yi are [nz, N, 1] and xi is
// [1, 1, N]: after the wrapper merges z and y, [nz N, N] with strides
// (1, 0), (1, 0) and (0, 1)).  A thread reads its three indices, forms the
// eight corner offsets and weights once, and then sums each volume's
// corners and writes out[k, point].
//
// What bounds it on the card: bytes.  The output (K floats a point, 16.8
// MB at the tilted cone protocol) and the gantry cells that the stencils
// touch (28 % of 4 x 60 x 258^2 floats, ~18 MB) are each moved once: ~35 MB,
// 0.0104 ms at 3.35 TB/s.  The indices are a few KB.  The arithmetic, ~40
// operations a point plus 16 a volume, is far below the card's rate.
//
// Block shape: x is the fastest axis of the output and of the block, so a
// warp's threads read one broadcast z and y index (one address), 32
// neighbouring x indices, and, since the gantry grid has the patient
// grid's pixel pitch, 32 neighbouring gantry voxels of each corner row;
// each volume's store is one coalesced row.  A block spans block_x points
// of a row (block_x the smallest power of two >= the row, 32 to 256) and
// 256 / block_x rows; consecutive blocks take consecutive rows, whose
// stencils share corner rows in L2.  Rows beyond the grid's y extent are
// walked in a grid-stride loop, so no output size or volume count is
// refused.  Block widths 32, 64, 128 and 256 were timed at the tilted
// shape: 0.030-0.031 ms of device time at every width (NVIDIA H100 80GB
// HBM3, 700.00 W; grid_sample 0.042 ms), so the width only has to keep a
// warp on one row; the row-wide rule wastes no thread at the tilted
// shape's 256 columns.
//
// As the JAX program, in float32 without fused multiply-adds:
// i0 = clamp(floor(i), 0, n-2) and f = clamp(i - i0, 0, 1) per axis; the
// point is inside when 0 <= i <= n-1 on every axis; the value is the sum
// over the eight corners (z, then y, then x; 0 before 1) of
// ((wz wy) wx) vol[corner], with w = f at the upper corner and 1 - f at the
// lower one, times 1 inside and 0 outside.  Bitwise equal to the plain
// version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxRowBlocks = 65535;

struct Strides {
  long long s0, s1, s2;
};

__global__ void trilinear_sample_kernel(
    const float* __restrict__ vols, const float* __restrict__ zi,
    const float* __restrict__ yi, const float* __restrict__ xi,
    float* __restrict__ out, int n_images, long long n1, long long n2,
    long long n_rows, Strides zs, Strides ys, Strides xs, int nz, int ny,
    int nx) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n2) return;
  const long long n_out = n_rows * n2;
  const long long vol_size = (long long)nz * ny * nx;
  for (long long r = (long long)blockIdx.y * blockDim.y + threadIdx.y;
       r < n_rows; r += (long long)gridDim.y * blockDim.y) {
    const long long a = r / n1, b = r - a * n1;
    const float z = __ldg(zi + a * zs.s0 + b * zs.s1 + c * zs.s2);
    const float y = __ldg(yi + a * ys.s0 + b * ys.s1 + c * ys.s2);
    const float x = __ldg(xi + a * xs.s0 + b * xs.s1 + c * xs.s2);
    const float z0 = fminf(fmaxf(floorf(z), 0.0f), (float)(nz - 2));
    const float y0 = fminf(fmaxf(floorf(y), 0.0f), (float)(ny - 2));
    const float x0 = fminf(fmaxf(floorf(x), 0.0f), (float)(nx - 2));
    const float f[3] = {fminf(fmaxf(__fsub_rn(z, z0), 0.0f), 1.0f),
                        fminf(fmaxf(__fsub_rn(y, y0), 0.0f), 1.0f),
                        fminf(fmaxf(__fsub_rn(x, x0), 0.0f), 1.0f)};
    const float inside =
        (z >= 0.0f && z <= (float)(nz - 1) && y >= 0.0f &&
         y <= (float)(ny - 1) && x >= 0.0f && x <= (float)(nx - 1))
            ? 1.0f
            : 0.0f;
    const long long base =
        ((long long)z0 * ny + (long long)y0) * nx + (long long)x0;
    long long off[8];
    float wt[8];
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
      const float wz = dz ? f[0] : 1.0f - f[0];
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const float wy = dy ? f[1] : 1.0f - f[1];
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const float wx = dx ? f[2] : 1.0f - f[2];
          const int t = dz * 4 + dy * 2 + dx;
          off[t] = base + dz * (long long)ny * nx + dy * (long long)nx + dx;
          wt[t] = __fmul_rn(__fmul_rn(wz, wy), wx);
        }
      }
    }
    const long long o = r * n2 + c;
    for (int k = 0; k < n_images; ++k) {
      const float* v = vols + (long long)k * vol_size;
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < 8; ++t)
        acc = __fadd_rn(acc, __fmul_rn(wt[t], __ldg(v + off[t])));
      out[(long long)k * n_out + o] = __fmul_rn(acc, inside);
    }
  }
}

}  // namespace

// vols [n_images, nz, ny, nx]; out [n_images, n0, n1, n2]; each index
// tensor read at element offset i0 s0 + i1 s1 + i2 s2 (strides >= 0, 0 on
// broadcast axes).
extern "C" int dexct_trilinear_sample(
    const void* vols, const void* zi, const void* yi, const void* xi,
    void* out, int n_images, long long n0, long long n1, long long n2,
    long long zs0, long long zs1, long long zs2, long long ys0,
    long long ys1, long long ys2, long long xs0, long long xs1,
    long long xs2, int nz, int ny, int nx, void* stream) {
  if (nz < 2 || ny < 2 || nx < 2 || n_images < 0 || n0 < 0 || n1 < 0 ||
      n2 < 0)
    return (int)cudaErrorInvalidValue;
  if (zs0 < 0 || zs1 < 0 || zs2 < 0 || ys0 < 0 || ys1 < 0 || ys2 < 0 ||
      xs0 < 0 || xs1 < 0 || xs2 < 0)
    return (int)cudaErrorInvalidValue;
  int block_x = 32;
  while (block_x < kThreads && block_x < n2) block_x *= 2;
  const long long n_rows = n0 * n1;
  if (n_rows == 0 || n2 == 0 || n_images == 0)
    return (int)cudaGetLastError();
  const long long col_blocks = (n2 + block_x - 1) / block_x;
  if (col_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int block_y = kThreads / block_x;
  long long row_blocks = (n_rows + block_y - 1) / block_y;
  if (row_blocks > kMaxRowBlocks) row_blocks = kMaxRowBlocks;
  const dim3 blocks((unsigned)col_blocks, (unsigned)row_blocks);
  const dim3 threads(block_x, block_y);
  trilinear_sample_kernel<<<blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vols), static_cast<const float*>(zi),
      static_cast<const float*>(yi), static_cast<const float*>(xi),
      static_cast<float*>(out), n_images, n1 > 0 ? n1 : 1, n2, n_rows,
      Strides{zs0, zs1, zs2}, Strides{ys0, ys1, ys2},
      Strides{xs0, xs1, xs2}, nz, ny, nx);
  return (int)cudaGetLastError();
}
