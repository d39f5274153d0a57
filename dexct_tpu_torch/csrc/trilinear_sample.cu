// K16 trilinear_sample: trilinear samples of K stacked volumes at
// continuous (z, y, x) indices, 0 outside the index box.
//
// Replaces dexct_tpu/ops/conebeam.py:_trilinear_volume_sample, the one
// gather pass of the tilted-gantry FDK that resamples the gantry-frame
// volumes onto the patient grid.  The TPU program gathers the eight corners
// of every point with jnp fancy indexing; here one thread per (output point,
// volume) reads its eight corners and writes one value.
//
// What bounds it on the card: bytes.  Per point three float indices are read
// once and one value per volume written, plus the eight corners, which the
// neighbouring threads of a row of the patient grid share in L1/L2 (the
// gantry volumes are 4 x 60 x 258 x 258 floats, 64 MB, at the cone
// protocol, of which the rotated patient slab's stencils touch 28 %).  The
// arithmetic, ~40 operations per point and volume, is far below the card's
// rate.
//
// As the JAX program, in float32 without fused multiply-adds:
// i0 = clamp(floor(i), 0, n-2) and f = clamp(i - i0, 0, 1) per axis; the
// point is inside when 0 <= i <= n-1 on every axis; the value is the sum
// over the eight corners (z, then y, then x; 0 before 1) of
// ((wz wy) wx) vol[corner], with w = f at the upper corner and 1 - f at the
// lower one, times 1 inside and 0 outside.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__global__ void trilinear_sample_kernel(const float* __restrict__ vols,
                                        const float* __restrict__ zi,
                                        const float* __restrict__ yi,
                                        const float* __restrict__ xi,
                                        float* __restrict__ out,
                                        long long n_out, int nz, int ny,
                                        int nx) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const int k = blockIdx.y;
  const float z = zi[i], y = yi[i], x = xi[i];
  const float z0 = fminf(fmaxf(floorf(z), 0.0f), (float)(nz - 2));
  const float y0 = fminf(fmaxf(floorf(y), 0.0f), (float)(ny - 2));
  const float x0 = fminf(fmaxf(floorf(x), 0.0f), (float)(nx - 2));
  const float f[3] = {fminf(fmaxf(__fsub_rn(z, z0), 0.0f), 1.0f),
                      fminf(fmaxf(__fsub_rn(y, y0), 0.0f), 1.0f),
                      fminf(fmaxf(__fsub_rn(x, x0), 0.0f), 1.0f)};
  const bool ok = z >= 0.0f && z <= (float)(nz - 1) && y >= 0.0f &&
                  y <= (float)(ny - 1) && x >= 0.0f && x <= (float)(nx - 1);
  const float* v = vols + (long long)k * nz * ny * nx;
  const long long base =
      ((long long)z0 * ny + (long long)y0) * nx + (long long)x0;
  const long long step[3] = {(long long)ny * nx, nx, 1};
  float acc = 0.0f;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const float wz = dz ? f[0] : 1.0f - f[0];
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float wy = dy ? f[1] : 1.0f - f[1];
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const float wx = dx ? f[2] : 1.0f - f[2];
        const float corner =
            __ldg(v + base + dz * step[0] + dy * step[1] + dx * step[2]);
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(__fmul_rn(wz, wy), wx),
                                       corner));
      }
    }
  }
  out[(long long)k * n_out + i] = __fmul_rn(acc, ok ? 1.0f : 0.0f);
}

}  // namespace

extern "C" int dexct_trilinear_sample(const void* vols, const void* zi,
                                      const void* yi, const void* xi,
                                      void* out, int n_images,
                                      long long n_out, int nz, int ny, int nx,
                                      void* stream) {
  if (n_out <= 0 || n_images <= 0) return (int)cudaGetLastError();
  if (nz < 2 || ny < 2 || nx < 2 || n_images > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 blocks((unsigned)((n_out + kThreads - 1) / kThreads), n_images);
  trilinear_sample_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vols), static_cast<const float*>(zi),
      static_cast<const float*>(yi), static_cast<const float*>(xi),
      static_cast<float*>(out), n_out, nz, ny, nx);
  return (int)cudaGetLastError();
}
