// K18 project_3d and K19 backproject_3d: the exact 3-D Siddon projector of a
// continuous volume and its adjoint.
//
// K18 replaces dexct_tpu/ops/conebeam.py:project_volume_3d, the TPU program
// that scans the bounded Nx+Ny+Nz+2-step DDA over geometry only, emitting a
// [n_steps, n_rays] table of (cell index, segment length), and contracts it
// with the volume in one gather-weighted sum (so that jax.linear_transpose
// can transpose it).  K19 replaces that transpose, which XLA lowers to
// scatter-adds of the same table: the adjoint backprojector of
// cone_cg_recon and cone_pwls_recon.
//
// What bounds them on the card: per traversal step one dependent load of
// the volume (K18) or one float32 atomic add into it (K19), plus ~20 float
// operations of the walk; the volume (32 x 256 x 256 floats, 8.4 MB at the
// cone protocol) stays in the 50 MB L2, and the work is the number of voxels
// the rays cross.  Design: one thread per ray walks only its own steps (the
// loop ends at t_out instead of running the fixed trip, and the
// [n_steps, n_rays] table of the TPU program, 6.4 GB at the cone protocol,
// never exists); K18 keeps its sum in a register and writes it once; K19
// adds seg * y[ray] into the volume with atomicAdd, so its sums are taken in
// no fixed order (equal to the plain version to a tolerance, not bit for
// bit).  Neighbouring threads are neighbouring channels of one detector row,
// whose walks are alike.  The walk is siddon_walk_3d.cuh's, shared with K10.

#include <cuda_runtime.h>

#include "siddon_walk_3d.cuh"

namespace {

using dexct_walk3d::Grid;
using dexct_walk3d::Walk;

__global__ void project_3d_kernel(const float* __restrict__ vol,
                                  const float* __restrict__ src,
                                  const float* __restrict__ dirs,
                                  float* __restrict__ out, long long n_rays,
                                  Grid g, int n_steps) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  Walk w = dexct_walk3d::walk_start(g, src[3 * r], src[3 * r + 1],
                                    src[3 * r + 2], dirs[3 * r],
                                    dirs[3 * r + 1], dirs[3 * r + 2]);
  float acc = 0.0f;
  for (int k = 0; k < n_steps && w.t < w.t_out; ++k) {
    long long cell;
    const float seg = dexct_walk3d::walk_step(w, g, cell);
    acc += seg * __ldg(vol + cell);
  }
  out[r] = acc;
}

__global__ void backproject_3d_kernel(const float* __restrict__ y,
                                      const float* __restrict__ src,
                                      const float* __restrict__ dirs,
                                      float* __restrict__ vol,
                                      long long n_rays, Grid g, int n_steps) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float yr = y[r];
  if (yr == 0.0f) return;  // adds exact zeros
  Walk w = dexct_walk3d::walk_start(g, src[3 * r], src[3 * r + 1],
                                    src[3 * r + 2], dirs[3 * r],
                                    dirs[3 * r + 1], dirs[3 * r + 2]);
  for (int k = 0; k < n_steps && w.t < w.t_out; ++k) {
    long long cell;
    const float seg = dexct_walk3d::walk_step(w, g, cell);
    if (seg != 0.0f) atomicAdd(vol + cell, __fmul_rn(seg, yr));
  }
}

constexpr int kThreads = 256;

}  // namespace

// vol [nz, ny, nx], src/dirs [n_rays, 3] -> out [n_rays]
extern "C" int dexct_project_3d(const void* vol, const void* src,
                                const void* dirs, void* out, long long n_rays,
                                int nx, int ny, int nz, float x0, float y0,
                                float z0, float x1, float y1, float z1,
                                float dx, float dy, float dz, float eps,
                                int n_steps, void* stream) {
  if (n_rays <= 0) return (int)cudaGetLastError();
  const Grid g{nx, ny, nz, x0, y0, z0, x1, y1, z1, dx, dy, dz, eps};
  const long long blocks = (n_rays + kThreads - 1) / kThreads;
  project_3d_kernel<<<(unsigned)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vol), static_cast<const float*>(src),
      static_cast<const float*>(dirs), static_cast<float*>(out), n_rays, g,
      n_steps);
  return (int)cudaGetLastError();
}

// y [n_rays], src/dirs [n_rays, 3] -> vol [nz, ny, nx] += A^T y (the caller
// zeroes vol)
extern "C" int dexct_backproject_3d(const void* y, const void* src,
                                    const void* dirs, void* vol,
                                    long long n_rays, int nx, int ny, int nz,
                                    float x0, float y0, float z0, float x1,
                                    float y1, float z1, float dx, float dy,
                                    float dz, float eps, int n_steps,
                                    void* stream) {
  if (n_rays <= 0) return (int)cudaGetLastError();
  const Grid g{nx, ny, nz, x0, y0, z0, x1, y1, z1, dx, dy, dz, eps};
  const long long blocks = (n_rays + kThreads - 1) / kThreads;
  backproject_3d_kernel<<<(unsigned)blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(src),
      static_cast<const float*>(dirs), static_cast<float*>(vol), n_rays, g,
      n_steps);
  return (int)cudaGetLastError();
}
