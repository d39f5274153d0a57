// K10 siddon_trace_3d: exact per-material Siddon path lengths of 3-D rays.
//
// Replaces the TPU programs of dexct_tpu/ops/conebeam.py that the fused cone
// pipeline traces with: _trace_cone_dominant (a dominant-axis walk over
// 3-bit packed per-z-layer label windows in ray-plan order) and its bundled
// form (one shared-window gather for 8 adjacent channels), and the plain
// fixed-trip trace_paths_3d (an Nx+Ny+Nz+2-step lax.scan).  They compute
// the same numbers; the packed forms exist because a TPU pays per gather.
//
// What bounds it on the card: the instructions of a traversal step.  The
// cone protocol's 1.47M rays take 470M steps; the labels, 2.1 MB (3.1 MB
// on the helix), stay in L2.  The first K10 walked with a 64-bit cell and
// an if/else axis choice, tested the exit every step and added each
// segment to all M sums in registers through an unrolled select: 61 SASS
// instructions a step at M = 7, 0.97 ms at one instruction a clock on
// each of the 528 schedulers, against its 1.27 ms (H100, 700 W).  This one:
//
// - walks with K18's step (siddon_walk_3d.cuh: walk32_run, step32): 32-bit
//   offsets, the axis chosen by selects, the max with t only while a
//   crossing lies behind t, the exit tested every 16 steps (a step past
//   t_out adds a segment of +0);
// - keeps the per-material sums in shared memory, acc[min(label, M)][lane of
//   the block], row M a dump for labels >= n_materials: a step is one uint8
//   load, an address, LDS, FADD, STS in place of M selects and adds, with
//   no bank conflicts (a lane's bank is its threadIdx.x % 32 in every row),
//   and the array sized by the runtime n_materials (no template on M);
// - reads the labels as they are, [nz, ny, nx], or from their copy with x
//   and y swapped, [nz, nx, ny] (swap_xy_kernel<uint8_t>, each call, into
//   the wrapper's scratch), by the warp's vote on the face its rays enter
//   by, as K18 does: without it an x-dominant warp's loads, nx bytes
//   apart, touch a line a lane (0.88 against 0.55 ms).
//
// 24.4 instructions a step, 0.39 ms at one instruction a clock on each
// scheduler, against 0.55 ms at the cone protocol and 1.07 ms on the helix
// (H100, 700 W; tools/probe_siddon_trace_3d.py --steps times each step of
// this design).
//
// Bit for bit the first K10: each material's sum takes that material's
// segments one at a time, in step order, with __fadd_rn; the adds dropped
// are the +0 adds to the other materials' sums, which never change a sum
// (sums start at +0 and segments are >= +0, because the walk's t_next >=
// t).  Neighbouring threads are neighbouring channels of one detector row,
// whose walks are alike.

#include <cuda_runtime.h>
#include <stdint.h>

#include "siddon_walk_3d.cuh"

namespace {

using dexct_walk3d::Grid;
using dexct_walk3d::kExitEvery;
using dexct_walk3d::Walk;
using dexct_walk3d::Walk32;

constexpr int kThreads = 256;
// a block's sums: (n_materials + 1) rows of kThreads floats in the 48 KB a
// block takes without opting in
constexpr int kMaxSums = 48 * 1024 / (4 * kThreads);

__global__ void __launch_bounds__(kThreads) siddon_trace_3d_kernel(
    const uint8_t* __restrict__ labels, const uint8_t* __restrict__ labels_yx,
    const float* __restrict__ src, const float* __restrict__ dirs,
    float* __restrict__ out, long long n_rays, int n_mat, Grid g,
    int n_steps) {
  extern __shared__ float acc[];  // [n_mat + 1][kThreads]
  const int lane = threadIdx.x;
  const long long r = (long long)blockIdx.x * kThreads + lane;
  const bool live = r < n_rays;
  float* col = acc + lane;  // this ray's sums, a row apart
  for (int m = 0; m <= n_mat; ++m) col[m * kThreads] = 0.0f;
  const long long q = live ? r : 0;
  const float px = src[3 * q], py = src[3 * q + 1], pz = src[3 * q + 2];
  const float ux = dirs[3 * q], uy = dirs[3 * q + 1], uz = dirs[3 * q + 2];
  const Walk w0 = dexct_walk3d::walk_start(g, px, py, pz, ux, uy, uz);
  const bool x_face = dexct_walk3d::enters_by_x(g, px, py, ux, uy);
  const unsigned lanes = __ballot_sync(0xffffffffu, live);
  const unsigned votes = __ballot_sync(0xffffffffu, live && x_face);
  if (live) {
    const bool swapped = 2 * __popc(votes) > __popc(lanes);
    const uint8_t* lab = swapped ? labels_yx : labels;
    Walk32 w = swapped ? dexct_walk3d::walk32(w0, g, g.ny, 1)
                       : dexct_walk3d::walk32(w0, g, 1, g.nx);
    auto add = [&](float seg, int o) {
      float* sum = col + min((int)__ldg(lab + o), n_mat) * kThreads;
      *sum = __fadd_rn(*sum, seg);
    };
    dexct_walk3d::walk32_run<kExitEvery>(w, n_steps, add);
    // the ray's row, from its own column: a barrier and the block's tile
    // written coalesced instead took 3 % longer
    float* o = out + r * n_mat;
    for (int m = 0; m < n_mat; ++m) o[m] = col[m * kThreads];
  }
}

}  // namespace

// labels [nz, ny, nx] uint8, labels_yx [nz, nx, ny] scratch (filled here),
// src/dirs [n_rays, 3] -> out [n_rays, n_materials]
extern "C" int dexct_siddon_trace_3d(
    const void* labels, void* labels_yx, const void* src, const void* dirs,
    void* out, long long n_rays, int nx, int ny, int nz, int n_materials,
    float x0, float y0, float z0, float x1, float y1, float z1, float dx,
    float dy, float dz, float eps, int n_steps, void* stream) {
  if (n_rays <= 0) return (int)cudaGetLastError();
  if (n_materials < 1 || n_materials + 1 > kMaxSums)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* l = static_cast<const uint8_t*>(labels);
  uint8_t* l_yx = static_cast<uint8_t*>(labels_yx);
  const cudaError_t err = dexct_walk3d::launch_swap_xy(l, l_yx, nx, ny, nz,
                                                       st);
  if (err != cudaSuccess) return (int)err;
  const Grid g{nx, ny, nz, x0, y0, z0, x1, y1, z1, dx, dy, dz, eps};
  const long long blocks = (n_rays + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float) * (n_materials + 1) * kThreads;
  siddon_trace_3d_kernel<<<(unsigned)blocks, kThreads, smem, st>>>(
      l, l_yx, static_cast<const float*>(src),
      static_cast<const float*>(dirs), static_cast<float*>(out), n_rays,
      n_materials, g, n_steps);
  return (int)cudaGetLastError();
}
