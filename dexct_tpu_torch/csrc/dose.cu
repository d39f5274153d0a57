// K23 dose_2d and K24 dose_3d: per-voxel absorbed dose of a fan-beam or
// cone-beam scan.
//
// K23 replaces dexct_tpu/ops/dose.py:_dose_accumulate, K24
// dexct_tpu/ops/dose.py:_dose_accumulate_3d: a lax.scan over views that
// samples the bit-packed labels on a polar grid around the source, takes a
// cumsum along r into the partial material paths T, gathers each voxel's T
// and contracts exp(-T . mu(E)) with its material's deposition
// coefficients (MXU matmuls over voxel blocks).
//
// K23, one C call per block of views: the labels packed as corner quads
// (pack_quads_kernel on one slice), then three launches:
// 1. the polar pass: a thread block per view and tile of kPolarLines gamma
//    lines, marching r in chunks of kPolarChunk samples.  Per chunk, the
//    bilinear occupancy of its samples, one thread per (line, sample): a
//    sample's four corners are one 4-byte quad load, added per material in
//    the JAX program's corner order (one sum for a sample whose four
//    corners are one material), into shared memory; then the midpoint
//    running sum T = (cum - occ / 2) dr along r, one thread per (line,
//    material) in r order, each T stored as it is formed into T [view][r]
//    [gamma][K], consecutive threads on consecutive words of a row;
// 2. the term pass: one thread per voxel and kViews views.
//    Per view, the voxel's (gamma, r) frame and the in-fan gate in the JAX
//    operation order and T read bilinearly; then one pass over the
//    energies serves all its views (each table row loaded once for them,
//    the mu rows as 16-byte words, the views' sums interleaved, each in its
//    own order).  The (view, voxel) slot of a per-view scratch gets
//    (vw e_vol / rho, vw e_vol dxdy h r / sid), zeros out of the fan or
//    for a label past the tables;
// 3. the view sum: per voxel its terms in view order onto the dose
//    (float32) and the deposited energy (float64 per thread, then per
//    block of 256 voxels in a fixed order into the block's slot).
// These are the sums of the first K23's voxel pass term for term (one
// thread per voxel looping over the views), so the dose is bitwise that
// K23's and its plain twin's.  What bounded that K23 on the H100
// (tools/probe_dose2d.py, a 100-view call of the 256^2 pelvis at 80 kV,
// 1.45-1.50 ms): its polar pass 0.52 ms, one thread per (view, gamma) line
// storing T a material at a time at a 24 B stride, and its voxel pass
// 0.92, one thread per voxel looping over the views, 65,536 threads: a
// quarter of the card.  Now (PERF.md): the polar pass ~0.24 ms (T's 629 MB
// stored at ~2.6 TB/s, ~8 warp instructions a sample), the term pass ~0.44
// (~18 instructions a (voxel, view, energy), 15 of them the sum's
// floating-point work) and the view sum 0.03.  T is 6.3 MB per view (512
// x 512 x K = 6); storing it only along each line's run over the labels
// saved bytes but cost more instructions than it saved.
//
// K24 had the same two passes over T [view][r][t][gamma][K], 264 MB per
// view of the cone config (512 x 36 x 512 x K = 7).  What bounded it on
// the H100 (torch.profiler, 12 views of the cone config in 3 blocks of 4):
// the polar pass 4.46 ms of 7.2, the voxel pass 2.74.  The polar threads
// stored T one material at a time at a 28 B stride (28 sectors touched per
// warp store for 128 B of data), ~0.7 TB/s of table; the voxel pass read
// it back in 8 scattered taps per voxel and view.  Now T never leaves
// shared memory.  A thread block takes one view and one patch of kPG = 32
// gamma x kPT = 4 t cells, and marches the patch's 33 x 5 lines (the +1
// halo included) along r in chunks of R cells, R as many as 110 KB of
// shared memory holds beside the tables (16 at the cone config; two blocks
// an SM), up to the last chunk whose sector holds voxel columns.  Per
// chunk:
// 1. the occupancy of the chunk's new samples, one thread per (line,
//    sample), four samples a thread with their loads in flight: the
//    labels are read as corner quads (pack_quads_kernel: a sample's eight
//    corners are two 4-byte loads), the corners added per material in the
//    JAX program's order, a sample with one material at all corners by one
//    sum, a sample more than a voxel outside the volume skipped (its
//    occupancy is zero);
// 2. the running sum along r, one thread per line with its materials'
//    sums in registers over the chunks: T = (cum - occ / 2) dr sec t in the
//    old polar pass's operation order, into a ring of R + 1 samples;
// 3. the voxel columns of the chunk's sector (its bounding box, one voxel
//    wider: the search is wide, membership exact), 32 to a warp: per
//    column the voxel frame (r, gamma) as the old voxel pass formed it and
//    the run of slices whose (gamma, t, r) cells lie in this patch and
//    chunk, queued by a ballot in lane order (no atomics);
// 4. the queued voxels, shared out evenly over the block at the chunk's
//    end (a warp whose queue fills serves it at once): T trilinearly
//    from shared memory in the old order, the spectral sum (the mu rows
//    16 B loads), and the view's dose and energy terms into the voxel's own
//    slot of a per-view scratch (a voxel falls in one patch and chunk of a
//    view, so no two threads share a slot).
// A last launch adds each voxel's view terms in view order, the dose in
// float32 and the energy in float64 per thread and then per block, as the
// old voxel pass did term for term: K24 stays bitwise equal to its plain
// twin.  What bounds it now (tools/probe_dose3d.py, which builds this file
// cut after each phase; PERF.md): of the ~5.7 ms of a 12-view call at the
// cone shape, building T ~3.1 (with the host's prep, the fill, the quads
// and the sum; whether issue or latency limits it is not measured): each
// sample takes three IEEE divisions, two quad loads, the corner sums and
// the running sum, and the +1 halo adds 29 % of the samples; the column
// search ~0.5-0.7; the 74-energy dose terms ~1.9-2.2.
// expf (IEEE-accurate), not __expf: the tests hold the map to 1e-4 of its
// maximum.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;

// the block's float64 sum, in a fixed order, added into its own slot
__device__ void add_block_sum(double v, double* slot) {
  __shared__ double warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
    *slot += s;
  }
}

// the voxel's (gamma, r) frame of one view: r_v and gamma_v in the JAX
// program's operation order
__device__ __forceinline__ void voxel_frame(float vx, float vy, float s0,
                                            float s1, float sid, float* r_v,
                                            float* g_v) {
  const float relx = __fsub_rn(vx, s0), rely = __fsub_rn(vy, s1);
  const float r = sqrtf(__fadd_rn(__fmul_rn(relx, relx),
                                  __fmul_rn(rely, rely)));
  const float d0x = -s0 / sid, d0y = -s1 / sid;
  const float dotp =
      __fadd_rn(__fmul_rn(relx, d0x), __fmul_rn(rely, d0y)) / r;
  const float crossp =
      __fsub_rn(__fmul_rn(d0x, rely), __fmul_rn(d0y, relx)) / r;
  *r_v = r;
  *g_v = atan2f(crossp, dotp);
}

// clip((x - x0) / dx, 0, xmax): the cell index and its fraction
__device__ __forceinline__ int grid_pos(float x, float x0, float dx,
                                        float xmax, float* frac) {
  const float f = fminf(fmaxf(__fsub_rn(x, x0) / dx, 0.0f), xmax);
  const float fl = floorf(f);
  *frac = __fsub_rn(f, fl);
  return (int)fl;
}

__device__ __forceinline__ float lerp(float a, float b, float w) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, w)), __fmul_rn(b, w));
}

// ---------------------------------------------------------------------------
// K24: one thread block per (view, patch of kPG gamma cells x kPT t cells)
// ---------------------------------------------------------------------------

constexpr int kPG = 32;                   // gamma cells of a patch
constexpr int kPT = 4;                    // t cells of a patch
constexpr int kLG = kPG + 1;              // its gamma lines
constexpr int kLines = kLG * (kPT + 1);   // its (gamma, t) lines
constexpr int kTile = 256;                // threads of a patch block
constexpr int kWarpQueue = 64;            // voxel columns a warp queues
constexpr int kBatch = 4;                 // samples a thread loads at once
// shared memory of a patch block: two blocks fill an SM's 228 KB; tables
// too large for that take a block's most (one block an SM)
constexpr int kTileSmem = 110 * 1024;
constexpr int kTileSmemMax = 226 * 1024;

// a float32 polar grid as grid_pos takes it: its first value, its step
// a[1] - a[0] in float32 and the clip bound n - 1.001 (the plain twin's)
struct Axis {
  float x0, d, xmax;
};

__device__ __forceinline__ Axis axis_of(const float* a, int n) {
  Axis ax;
  ax.x0 = a[0];
  ax.d = __fsub_rn(a[1], a[0]);
  ax.xmax = (float)((double)n - 1.001);
  return ax;
}

// the padded spectral tables of a patch block: mu [E][MAXK] (zeros past K,
// 16 B rows), the fluence weights [E] and the deposition coefficients
// transposed to [E][K]
template <int MAXK>
__device__ void load_padded_tables(float* mu_pad, float* i0w_s, float* depT,
                                   const float* muT, const float* mu_dep,
                                   const float* i0w, int K, int E) {
  for (int i = threadIdx.x; i < E * MAXK; i += blockDim.x) {
    const int e = i / MAXK, k = i % MAXK;
    mu_pad[i] = k < K ? muT[e * K + k] : 0.0f;
  }
  for (int i = threadIdx.x; i < E * K; i += blockDim.x) {
    const int e = i / K, k = i % K;
    depT[i] = mu_dep[k * E + e];
  }
  for (int i = threadIdx.x; i < E; i += blockDim.x) i0w_s[i] = i0w[i];
  __syncthreads();
}

// own_deposit on the padded tables: the same operations in the same order,
// each energy's mu row read as MAXK / 4 16-byte words
template <int MAXK>
__device__ __forceinline__ float own_deposit_padded(
    const float (&t)[MAXK], int K, int E, const float* mu_pad,
    const float* i0w_s, const float* depT, int lj) {
  float c = 0.0f;
#pragma unroll 4
  for (int e = 0; e < E; ++e) {
    float m[MAXK];
#pragma unroll
    for (int q = 0; q < MAXK / 4; ++q) {
      const float4 w = reinterpret_cast<const float4*>(mu_pad + e * MAXK)[q];
      m[4 * q] = w.x;
      m[4 * q + 1] = w.y;
      m[4 * q + 2] = w.z;
      m[4 * q + 3] = w.w;
    }
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < MAXK; ++k)
      if (k < K) s = fmaf(t[k], m[k], s);
    c = fmaf(expf(-s) * i0w_s[e], depT[e * K + lj], c);
  }
  return c;
}

// the voxel columns box[0..1] (x) and box[2..3] (y) that can hold a voxel
// whose (gamma, r) in the view with its source at (s0, s1) lies in
// [glo, ghi] x [rlo, rhi]: the annular sector's bounding box (its corners
// and the axis directions inside its angles), one voxel wider on each side
// (the cells' edges are only rounded here; membership is decided exactly
// by the caller), clipped to the volume; empty when box[0] > box[1] or
// box[2] > box[3]
__device__ void sector_box(float s0, float s1, float glo, float ghi,
                           float rlo, float rhi, int nx, int ny, float dx,
                           float dy, float cx, float cy, int* box) {
  const float beta = atan2f(s1, s0);
  const float quarter = 1.57079632679489662f;
  float phi[6];
  int n = 0;
  phi[n++] = beta + glo;
  phi[n++] = beta + ghi;
  for (float k = ceilf((beta + glo) / quarter);
       k * quarter < beta + ghi && n < 6; k += 1.0f)
    phi[n++] = k * quarter;
  float x0 = INFINITY, x1 = -INFINITY, y0 = INFINITY, y1 = -INFINITY;
  for (int i = 0; i < n; ++i) {
    float sn, cs;
    sincosf(phi[i], &sn, &cs);
    for (int j = 0; j < 2; ++j) {
      const float r = j ? rhi : rlo;
      const float x = s0 - r * cs, y = s1 - r * sn;
      x0 = fminf(x0, x);
      x1 = fmaxf(x1, x);
      y0 = fminf(y0, y);
      y1 = fmaxf(y1, y);
    }
  }
  box[0] = (int)fminf(fmaxf(floorf(x0 / dx + cx) - 1.0f, 0.0f), (float)nx);
  box[1] = (int)fmaxf(fminf(ceilf(x1 / dx + cx) + 1.0f, (float)(nx - 1)),
                      -1.0f);
  box[2] = (int)fminf(fmaxf(floorf(y0 / dy + cy) - 1.0f, 0.0f), (float)ny);
  box[3] = (int)fmaxf(fminf(ceilf(y1 / dy + cy) + 1.0f, (float)(ny - 1)),
                      -1.0f);
}

// The labels as quads: quads[z][y + 1][x + 1] holds the labels of the
// corners (x, y), (x + 1, y), (x, y + 1), (x + 1, y + 1) of slice z in its
// bytes 0-3 (the JAX program's corner order), 0xff for a corner outside
// the volume, for x in [-1, nx - 1] and y in [-1, ny - 1]: a sample's
// eight corners are two 4-byte loads.
__global__ void pack_quads_kernel(const unsigned char* __restrict__ labels,
                                  unsigned* __restrict__ quads, int nx,
                                  int ny, int nz) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = (long long)nz * (ny + 1) * (nx + 1);
  if (i >= n) return;
  const int x = (int)(i % (nx + 1)) - 1;
  const int y = (int)((i / (nx + 1)) % (ny + 1)) - 1;
  const int z = (int)(i / ((long long)(nx + 1) * (ny + 1)));
  unsigned q = 0;
  for (int c = 0; c < 4; ++c) {
    const int yy = y + (c >> 1), xx = x + (c & 1);
    const unsigned l = (xx >= 0 && xx < nx && yy >= 0 && yy < ny)
                           ? labels[((size_t)z * ny + yy) * nx + xx]
                           : 0xffu;
    q |= l << (8 * c);
  }
  quads[i] = q;
}

// One block per (patch, view): the patch's (gamma, t) lines with their +1
// halo march along r in chunks of R cells; each chunk's T lives in shared
// memory (a ring of R + 1 samples per line), and the voxels whose cells
// fall in the chunk take their dose term from it.  contrib [nv, depth *
// ny * nx] float2 (zero-filled by the caller) gets, per voxel of the
// view's slab in its beam, (vw * e_vol / rho, vw * e_vol * dvol): each
// voxel lies in exactly one patch and chunk of a view, so no two threads
// write one slot.  xc [nx], yc [ny], zc [nz]: the voxel centres' axes.
template <int MAXK>
__global__ void __launch_bounds__(kTile, 2) patch_3d_kernel(
    const unsigned* __restrict__ quads, const float* __restrict__ src,
    const float* __restrict__ src_z, const float* __restrict__ ca,
    const float* __restrict__ sa, const float* __restrict__ vw,
    const int* __restrict__ k0s, const float* __restrict__ gammas,
    const float* __restrict__ ts, const float* __restrict__ sec,
    const float* __restrict__ rs, const float* __restrict__ xc,
    const float* __restrict__ yc, const float* __restrict__ zc,
    const float* __restrict__ rho, const unsigned char* __restrict__ lab,
    const float* __restrict__ muT, const float* __restrict__ mu_dep,
    const float* __restrict__ i0w, float2* __restrict__ contrib, int n_g,
    int n_t, int n_r, int K, int E, int nx, int ny, int nz, int depth,
    int R, int n_gp, float sid, float dx, float dy, float dz, float geom,
    float g_half, float t_half, float dvol) {
  extern __shared__ float4 patch_smem[];  // 16 B aligned
  __shared__ int warp_cols[kTile / 32], warp_mem[kTile / 32];
  const int v = blockIdx.y;
  const int ga = (blockIdx.x % n_gp) * kPG, ta = (blockIdx.x / n_gp) * kPT;
  const Axis G = axis_of(gammas, n_g), Tx = axis_of(ts, n_t),
             Rx = axis_of(rs, n_r);
  // the gamma and t ranges this patch's voxels can have in the beam
  // (its first and last patches take the clipped voxels beyond the grid)
  const float glo = ga == 0 ? -g_half
                            : fmaxf(__fadd_rn(G.x0, ga * G.d), -g_half);
  const float ghi = ga + kPG >= n_g - 1
                        ? g_half
                        : fminf(__fadd_rn(G.x0, (ga + kPG) * G.d), g_half);
  const float tlo = ta == 0 ? -t_half
                            : fmaxf(__fadd_rn(Tx.x0, ta * Tx.d), -t_half);
  const float thi = ta + kPT >= n_t - 1
                        ? t_half
                        : fminf(__fadd_rn(Tx.x0, (ta + kPT) * Tx.d), t_half);
  if (!(glo <= ghi && tlo <= thi)) return;  // no voxel of the beam here

  const int nynx = nx * ny;
  const size_t n_slab = (size_t)depth * nynx;
  const float s0 = src[2 * v], s1 = src[2 * v + 1], zs = src_z[v];
  const float wv = vw[v];
  const int k0 = k0s[v];
  const int kz_hi = min(k0 + depth, nz) - 1;
  const float cx = (float)(nx / 2.0 - 0.5), cy = (float)(ny / 2.0 - 0.5),
              cz = (float)(nz / 2.0 - 0.5);
  const float r_far = sid + 0.5f * sqrtf((float)nx * dx * nx * dx +
                                         (float)ny * dy * ny * dy) + 1.0f;
  // |x|, |y|, |z| beyond which a sample has no corner in the volume: half
  // its extent and one and a half voxels
  const float x_out = (0.5f * nx + 1.5f) * dx, y_out = (0.5f * ny + 1.5f) * dy,
              z_out = (0.5f * nz + 1.5f) * dz;
  const int ring = R + 1;
  const int n_rc = (n_r - 2) / R + 1;  // chunks

  float* mu_pad = reinterpret_cast<float*>(patch_smem);  // [E][MAXK]
  float* i0w_s = mu_pad + E * MAXK;         // [E]
  float* depT = i0w_s + E;                  // [E][K]
  float* rs_s = depT + E * K;               // [n_r]
  float* xc_s = rs_s + n_r;                 // [nx]
  float* yc_s = xc_s + nx;                  // [ny]
  float* zc_s = yc_s + ny;                  // [nz]
  float* T = zc_s + nz;                     // [line][R + 1 ring][K]
  int* boxes = reinterpret_cast<int*>(T + kLines * ring * K);  // [n_r][4]
  // per warp, its queue of voxel columns: xy index, first member slice,
  // first member's index, gamma line << 16 | r cell, r, gamma and r weights
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* wq = boxes + 4 * n_r + warp * 7 * kWarpQueue;
  int* q_j = wq;
  int* q_z = wq + kWarpQueue;
  int* q_off = wq + 2 * kWarpQueue;
  int* q_gr = wq + 3 * kWarpQueue;
  float* q_r = reinterpret_cast<float*>(wq + 4 * kWarpQueue);
  float* q_wg = q_r + kWarpQueue;
  float* q_wr = q_wg + kWarpQueue;

  for (int rc = threadIdx.x; rc < n_rc; rc += kTile) {
    const int ra = rc * R;
    const float rlo = rc == 0 ? 0.0f : __fadd_rn(Rx.x0, ra * Rx.d);
    const float rhi = ra + R >= n_r - 1 ? r_far
                                        : __fadd_rn(Rx.x0, (ra + R) * Rx.d);
    sector_box(s0, s1, glo, ghi, rlo, rhi, nx, ny, dx, dy, cx, cy,
               boxes + 4 * rc);
  }
  for (int i = threadIdx.x; i < n_r; i += kTile) rs_s[i] = rs[i];
  for (int i = threadIdx.x; i < nx; i += kTile) xc_s[i] = xc[i];
  for (int i = threadIdx.x; i < ny; i += kTile) yc_s[i] = yc[i];
  for (int i = threadIdx.x; i < nz; i += kTile) zc_s[i] = zc[i];
  load_padded_tables<MAXK>(mu_pad, i0w_s, depT, muT, mu_dep, i0w, K, E);

  // each line's direction and cone slope
  float* line_c = reinterpret_cast<float*>(boxes + 4 * n_r +
                                            (kTile / 32) * 7 * kWarpQueue);
  float* line_s = line_c + kLines;
  float* line_t = line_s + kLines;
  for (int line = threadIdx.x; line < kLines; line += kTile) {
    // lines past the grid's edge (never read) repeat its last line
    const int g = min(ga + line % kLG, n_g - 1);
    const int t = min(ta + line / kLG, n_t - 1);
    line_c[line] = ca[(size_t)v * n_g + g];
    line_s[line] = sa[(size_t)v * n_g + g];
    line_t[line] = ts[t];
  }
  // thread i < kLines keeps line i's running sums over the chunks
  const float my_st = threadIdx.x < kLines
                          ? sec[min(ta + (int)threadIdx.x / kLG, n_t - 1)]
                          : 0.0f;
  float cum[MAXK];
#pragma unroll
  for (int k = 0; k < MAXK; ++k) cum[k] = 0.0f;
  __syncthreads();

  // the dose term of member q of warp w's queue (of nc columns) from the
  // chunk's T
  auto serve_one = [&](int w, int nc, int q, int ra) {
    const int* wq_w = boxes + 4 * n_r + w * 7 * kWarpQueue;
    const int* qj = wq_w;
    const int* qz = wq_w + kWarpQueue;
    const int* qoff = wq_w + 2 * kWarpQueue;
    const int* qgr = wq_w + 3 * kWarpQueue;
    const float* qr = reinterpret_cast<const float*>(wq_w + 4 * kWarpQueue);
    const float* qwg = qr + kWarpQueue;
    const float* qwr = qwg + kWarpQueue;
    int lo = 0, hi = nc - 1;  // the last column starting at or before q
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (qoff[mid] <= q) lo = mid;
      else hi = mid - 1;
    }
    const int iz = qz[lo] + (q - qoff[lo]);
    const size_t j = (size_t)iz * nynx + qj[lo];
    const int lj = lab[j];
    if (lj >= K) return;  // no material of the table: adds 0
    const float rv = qr[lo];
    const float t_v = __fsub_rn(zc_s[iz], zs) / rv;
    float wt;
    const int tl = grid_pos(t_v, Tx.x0, Tx.d, Tx.xmax, &wt) - ta;
    const int gl = qgr[lo] >> 16, ri = ra + (qgr[lo] & 0xffff);
    const float w_g = qwg[lo], w_r = qwr[lo];
    const float* a = T + (size_t)(tl * kLG + gl) * ring * K;
    const int sa0 = (ri % ring) * K, sa1 = ((ri + 1) % ring) * K;
    const int sg = ring * K;        // g + 1
    const int st = kLG * ring * K;  // t + 1
    float tv[MAXK];
#pragma unroll
    for (int k = 0; k < MAXK; ++k) {
      if (k >= K) break;
      // lerp over r of the (g, t), (g, t + 1), (g + 1, t), (g + 1, t + 1)
      // lines, then t, then g, as the JAX program
      const float l00 = lerp(a[sa0 + k], a[sa1 + k], w_r);
      const float l01 = lerp(a[st + sa0 + k], a[st + sa1 + k], w_r);
      const float l10 = lerp(a[sg + sa0 + k], a[sg + sa1 + k], w_r);
      const float l11 =
          lerp(a[sg + st + sa0 + k], a[sg + st + sa1 + k], w_r);
      tv[k] = lerp(lerp(l00, l01, wt), lerp(l10, l11, wt), w_g);
    }
    const float sec_v = sqrtf(__fadd_rn(1.0f, __fmul_rn(t_v, t_v)));
    const float phi0 = __fmul_rn(geom, sec_v) / __fmul_rn(rv, rv);
    const float e_vol = __fmul_rn(
        phi0, own_deposit_padded<MAXK>(tv, K, E, mu_pad, i0w_s, depT, lj));
    contrib[(size_t)v * n_slab + (size_t)(iz - k0) * nynx + qj[lo]] =
        make_float2(__fmul_rn(wv, e_vol / __ldg(rho + j)),
                    __fmul_rn(wv, __fmul_rn(e_vol, dvol)));
  };

  // past the last chunk whose sector holds voxel columns no voxel reads
  // T, and nothing else needs the running sums: the march stops there
  int n_used = 0;
  for (int rc = 0; rc < n_rc; ++rc)
    if (boxes[4 * rc] <= boxes[4 * rc + 1] &&
        boxes[4 * rc + 2] <= boxes[4 * rc + 3])
      n_used = rc + 1;
  for (int rc = 0; rc < n_used; ++rc) {
    const int ra = rc * R;                         // first r cell
    const int s_lo = rc == 0 ? 0 : ra + 1;         // new samples
    const int s_hi = min(ra + R, n_r - 1);
    // 1. the occupancy of each line's new samples, one thread per (line,
    //    sample), each material's corners added in the JAX program's
    //    order.  A sample more than a voxel outside the volume has no
    //    corner in it (tested on its position, before the divisions): its
    //    occupancy is zero.
    const int n_new = s_hi - s_lo + 1, n_smp = kLines * n_new;
    for (int i0 = threadIdx.x; i0 < n_smp; i0 += kBatch * kTile) {
      // kBatch samples a thread: positions first, their label loads in
      // flight together, then the occupancies
      unsigned qd[kBatch][2];
      float wx[kBatch], wy[kBatch], wz[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        qd[b][0] = qd[b][1] = 0xffffffffu;
        wx[b] = wy[b] = wz[b] = 0.0f;
        const int i = i0 + b * kTile;
        if (i >= n_smp) continue;
        const int line = i % kLines, s = s_lo + i / kLines;
        const float rr = rs_s[s];
        const float px = __fsub_rn(s0, __fmul_rn(line_c[line], rr));
        const float py = __fsub_rn(s1, __fmul_rn(line_s[line], rr));
        const float pz = __fadd_rn(zs, __fmul_rn(line_t[line], rr));
        if (!(fabsf(px) < x_out && fabsf(py) < y_out && fabsf(pz) < z_out))
          continue;
        const float fx = __fadd_rn(px / dx, cx), fy = __fadd_rn(py / dy, cy);
        const float fz = __fadd_rn(pz / dz, cz);
        const float flx = floorf(fx), fly = floorf(fy), flz = floorf(fz);
        const int ix0 = (int)flx, iy0 = (int)fly, iz0 = (int)flz;
        wx[b] = __fsub_rn(fx, flx);
        wy[b] = __fsub_rn(fy, fly);
        wz[b] = __fsub_rn(fz, flz);
        if (!(ix0 >= -1 && ix0 < nx && iy0 >= -1 && iy0 < ny)) continue;
        const unsigned* qp =
            quads + ((size_t)iz0 * (ny + 1) + iy0 + 1) * (nx + 1) + ix0 + 1;
        if (iz0 >= 0 && iz0 < nz) qd[b][0] = __ldg(qp);
        if (iz0 + 1 >= 0 && iz0 + 1 < nz)
          qd[b][1] = __ldg(qp + (size_t)(ny + 1) * (nx + 1));
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = i0 + b * kTile;
        if (i >= n_smp) break;
        float w[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int tz = q >> 2, ty = (q >> 1) & 1, tx = q & 1;
          w[q] = __fmul_rn(__fmul_rn(tz ? wz[b] : __fsub_rn(1.0f, wz[b]),
                                     ty ? wy[b] : __fsub_rn(1.0f, wy[b])),
                           tx ? wx[b] : __fsub_rn(1.0f, wx[b]));
        }
        float occ[MAXK];
#pragma unroll
        for (int k = 0; k < MAXK; ++k) occ[k] = 0.0f;
        const unsigned l0 = qd[b][0] & 0xffu;
        if (qd[b][0] == qd[b][1] && qd[b][0] == l0 * 0x01010101u &&
            l0 < (unsigned)K) {
          // one material at all eight corners: its sum in corner order
          float acc = 0.0f;
#pragma unroll
          for (int q = 0; q < 8; ++q) acc = __fadd_rn(acc, w[q]);
#pragma unroll
          for (int k = 0; k < MAXK; ++k)
            if (k == (int)l0) occ[k] = acc;
        } else if ((qd[b][0] & qd[b][1]) != 0xffffffffu) {
#pragma unroll
          for (int k = 0; k < MAXK; ++k) {
            if (k >= K) break;
#pragma unroll
            for (int q = 0; q < 8; ++q)
              if (((qd[b][q >> 2] >> (8 * (q & 3))) & 0xffu) == (unsigned)k)
                occ[k] = __fadd_rn(occ[k], w[q]);
          }
        }
        const int line = i % kLines, s = s_lo + i / kLines;
        float* out = T + ((size_t)line * ring + s % ring) * K;
#pragma unroll
        for (int k = 0; k < MAXK; ++k)
          if (k < K) out[k] = occ[k];
      }
    }
    __syncthreads();
    // the midpoint running sum along r, one thread per line with its
    // materials' sums in registers, in the old polar pass's order:
    // T = (cum - occ / 2) dr sec t (the next sample's occupancy loaded
    // before this one's T is stored)
    if (threadIdx.x < kLines) {
      float* Tl = T + (size_t)threadIdx.x * ring * K;
      int slot = s_lo % ring;
      float o[MAXK];
#pragma unroll
      for (int k = 0; k < MAXK; ++k) o[k] = k < K ? Tl[slot * K + k] : 0.0f;
      for (int s = s_lo; s <= s_hi; ++s) {
        const int next = slot + 1 == ring ? 0 : slot + 1;
        float on[MAXK];
#pragma unroll
        for (int k = 0; k < MAXK; ++k)
          on[k] = (k < K && s < s_hi) ? Tl[next * K + k] : 0.0f;
#pragma unroll
        for (int k = 0; k < MAXK; ++k) {
          if (k >= K) break;
          cum[k] = __fadd_rn(cum[k], o[k]);
          Tl[slot * K + k] = __fmul_rn(
              __fmul_rn(__fsub_rn(cum[k], __fmul_rn(0.5f, o[k])), Rx.d),
              my_st);
          o[k] = on[k];
        }
        slot = next;
      }
    }
    __syncthreads();
    // 2. the voxel columns of the chunk's sector, 32 to a warp at a time:
    //    each finds its member slices (a run: t grows with z); the warp
    //    queues the columns in lane order and serves its queued voxels 32
    //    at a time
    const int* box = boxes + 4 * rc;
    const int bw = box[1] - box[0] + 1, bh = box[3] - box[2] + 1;
    const int n_col = (bw > 0 && bh > 0) ? bw * bh : 0;
    int qc = 0, qm = 0;  // the warp's queued columns and voxels
    for (int base = warp * 32; base < n_col; base += kTile) {
      const int col = base + lane;
      int za = 0, cnt = 0, gr = 0, jxy = 0;
      float r_v = 0.0f, wg = 0.0f, wr = 0.0f;
      if (col < n_col) {
        const int ix = box[0] + col % bw, iy = box[2] + col / bw;
        jxy = iy * nx + ix;
        float g_v;
        voxel_frame(xc_s[ix], yc_s[iy], s0, s1, sid, &r_v, &g_v);
        const int gi = grid_pos(g_v, G.x0, G.d, G.xmax, &wg);
        const int ri = grid_pos(r_v, Rx.x0, Rx.d, Rx.xmax, &wr);
        if (fabsf(g_v) <= g_half && gi >= ga && gi < ga + kPG && ri >= ra &&
            ri < ra + R) {
          gr = (gi - ga) << 16 | (ri - ra);
          const float za_f = __fadd_rn(zs, tlo * r_v) / dz + cz;
          const float zb_f = __fadd_rn(zs, thi * r_v) / dz + cz;
          const int iz0 = (int)fminf(fmaxf(floorf(za_f) - 1.0f, (float)k0),
                                     (float)(kz_hi + 1));
          const int iz1 = (int)fmaxf(fminf(ceilf(zb_f) + 1.0f, (float)kz_hi),
                                     (float)(k0 - 1));
          for (int iz = iz0; iz <= iz1; ++iz) {
            const float t_v = __fsub_rn(zc_s[iz], zs) / r_v;
            float wt;
            const int ti = grid_pos(t_v, Tx.x0, Tx.d, Tx.xmax, &wt);
            const bool in = fabsf(t_v) <= t_half && ti >= ta && ti < ta + kPT;
            if (in) {
              if (cnt == 0) za = iz;
              ++cnt;
            } else if (cnt > 0) {
              break;  // past the run
            }
          }
        }
      }
      const unsigned flags = __ballot_sync(0xffffffffu, cnt > 0);
      int incl = cnt;  // inclusive prefix of the lanes' member counts
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int n = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += n;
      }
      const int n_mem = __shfl_sync(0xffffffffu, incl, 31);
      if (qc + __popc(flags) > kWarpQueue) {  // full: the warp serves it
        for (int q = lane; q < qm; q += 32) serve_one(warp, qc, q, ra);
        __syncwarp();
        qc = 0;
        qm = 0;
      }
      if (cnt > 0) {
        const int q = qc + __popc(flags & ((1u << lane) - 1u));
        q_j[q] = jxy;
        q_z[q] = za;
        q_off[q] = qm + incl - cnt;
        q_gr[q] = gr;
        q_r[q] = r_v;
        q_wg[q] = wg;
        q_wr[q] = wr;
      }
      qc += __popc(flags);
      qm += n_mem;
      __syncwarp();
    }
    // the warps' queued voxels, shared out evenly over the block
    if (lane == 0) {
      warp_cols[warp] = qc;
      warp_mem[warp] = qm;
    }
    __syncthreads();
    int total = 0;
    for (int w = 0; w < kTile / 32; ++w) total += warp_mem[w];
    for (int m = threadIdx.x; m < total; m += kTile) {
      int w = 0, q = m;
      while (q >= warp_mem[w]) q -= warp_mem[w++];
      serve_one(w, warp_cols[w], q, ra);
    }
    __syncthreads();  // the ring's next samples overwrite this chunk's
  }
}

// Per voxel, its views' terms added in view order onto the dose (float32)
// and the deposited energy (float64, per thread, then per block in a fixed
// order into the block's slot): the old voxel passes' sums, term for term.
// kSlabs (K24): view v's terms cover the depth slices from k0s[v];
// otherwise (K23) every voxel, depth 1 and nynx = n_vox.
template <bool kSlabs>
__global__ void view_sum_kernel(const float2* __restrict__ contrib,
                                const int* __restrict__ k0s,
                                float* __restrict__ dose,
                                double* __restrict__ edep, int nv, int nynx,
                                int depth, long long n_vox) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  double e_sum = 0.0;
  if (j < n_vox) {
    const int kz = (int)(j / nynx);
    const int jxy = (int)(j - (long long)kz * nynx);
    const size_t n_slab = (size_t)depth * nynx;
    float acc = dose[j];
    for (int v = 0; v < nv; ++v) {
      const int k0 = kSlabs ? k0s[v] : 0;
      if (kz < k0 || kz >= k0 + depth) continue;  // outside the view's slab
      const float2 c =
          contrib[(size_t)v * n_slab + (size_t)(kz - k0) * nynx + jxy];
      acc = __fadd_rn(acc, c.x);
      e_sum += (double)c.y;
    }
    dose[j] = acc;
  }
  add_block_sum(e_sum, edep + blockIdx.x);
}

// ---------------------------------------------------------------------------
// K23: the polar pass, the term pass and the view sum
// ---------------------------------------------------------------------------

constexpr int kPolarLines = 16;  // gamma lines of a polar block
constexpr int kPolarChunk = 32;  // r samples a polar block holds at once
constexpr int kViews = 4;        // views of a term thread (half at MAXK 16)
constexpr int kEnergyUnroll = 2;  // energies a term thread unrolls
constexpr int kTermThreads = 256;  // threads of a term block
constexpr int kTermBlocks = 4;     // term blocks an SM must hold at least
constexpr bool kConstK = true;     // the term pass's K as a constant at 3, 6

// T [nv][n_r][n_g][K] of nv views: one block per (tile of kPolarLines
// gamma lines, view).  quads: the labels as corner quads [ny + 1][nx + 1]
// (pack_quads_kernel, one slice).
template <int MAXK>
__global__ void __launch_bounds__(kThreads) polar_2d_kernel(
    const unsigned* __restrict__ quads, const float* __restrict__ src,
    const float* __restrict__ ca, const float* __restrict__ sa,
    const float* __restrict__ rs, float* __restrict__ T, int n_g, int n_r,
    int K, int nx, int ny, float dx, float dy) {
  // the chunk's occupancy: [sample][line][MAXK]
  __shared__ float4 occ4[kPolarChunk * kPolarLines * MAXK / 4];
  constexpr int kRow = kPolarLines * MAXK;  // words of a sample's row
  __shared__ float line_c[kPolarLines], line_s[kPolarLines];
  float* occ = reinterpret_cast<float*>(occ4);
  const int v = blockIdx.y, ga = blockIdx.x * kPolarLines;
  const int n_lines = min(kPolarLines, n_g - ga);
  const float s0 = src[2 * v], s1 = src[2 * v + 1];
  const float cx = (float)(nx / 2.0 - 0.5), cy = (float)(ny / 2.0 - 0.5);
  const float dr = __fsub_rn(rs[1], rs[0]);
  if (threadIdx.x < kPolarLines) {
    // lines past the grid's edge (never stored) repeat its last line
    const int g = min(ga + (int)threadIdx.x, n_g - 1);
    line_c[threadIdx.x] = ca[(size_t)v * n_g + g];
    line_s[threadIdx.x] = sa[(size_t)v * n_g + g];
  }
  // thread i keeps the running sums of the padded row's words i + u
  // kThreads (line, material) over the chunks
  constexpr int kSums = (kRow + kThreads - 1) / kThreads;
  float cum[kSums];
#pragma unroll
  for (int u = 0; u < kSums; ++u) cum[u] = 0.0f;
  float* Tv = T + (size_t)v * n_r * n_g * K;
  __syncthreads();
  for (int ra = 0; ra < n_r; ra += kPolarChunk) {
    const int n_s = min(kPolarChunk, n_r - ra);
    // 1. the occupancy of each (line, sample): its row zeroed, then the
    //    corners of one material added in the JAX program's order (ty
    //    outer, tx inner) into its slot; a corner outside the labels (0xff
    //    in its quad) adds nothing.  Four corners of one material: their
    //    weights summed in that order, one store.
    for (int i = threadIdx.x; i < n_s * kPolarLines; i += kThreads) {
      const int l = i % kPolarLines, s = i / kPolarLines;
      const float rr = __ldg(rs + ra + s);
      const float fx =
          __fadd_rn(__fsub_rn(s0, __fmul_rn(line_c[l], rr)) / dx, cx);
      const float fy =
          __fadd_rn(__fsub_rn(s1, __fmul_rn(line_s[l], rr)) / dy, cy);
      const float flx = floorf(fx), fly = floorf(fy);
      float* row = occ + (s * kPolarLines + l) * MAXK;
#pragma unroll
      for (int q = 0; q < MAXK / 4; ++q)
        reinterpret_cast<float4*>(row)[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (flx >= -1.0f && flx < (float)nx && fly >= -1.0f &&
          fly < (float)ny) {
        const unsigned q =
            __ldg(quads + ((int)fly + 1) * (nx + 1) + (int)flx + 1);
        const float wx = __fsub_rn(fx, flx), wy = __fsub_rn(fy, fly);
        float w[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          w[c] = __fmul_rn((c >> 1) ? wy : __fsub_rn(1.0f, wy),
                           (c & 1) ? wx : __fsub_rn(1.0f, wx));
        const unsigned l0 = q & 0xffu;
        if (q == l0 * 0x01010101u) {
          if (l0 < (unsigned)K)
            row[l0] = __fadd_rn(__fadd_rn(__fadd_rn(w[0], w[1]), w[2]), w[3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const unsigned lc = (q >> (8 * c)) & 0xffu;
            if (lc < (unsigned)K) row[lc] = __fadd_rn(row[lc], w[c]);
          }
        }
      }
    }
    __syncthreads();
    // 2. the midpoint running sum in r order, one thread per (line,
    //    material) with its sum in a register: eight samples' occupancies
    //    loaded before their sums, each T stored as it is formed
    //    (consecutive threads on consecutive words of a row of T)
#pragma unroll
    for (int u = 0; u < kSums; ++u) {
      const int word = threadIdx.x + u * kThreads;
      const int l = word / MAXK, k = word % MAXK;
      if (word >= kRow || l >= n_lines || k >= K) continue;
      const float* p = occ + word;
      float* out = Tv + ((size_t)ra * n_g + ga + l) * K + k;
      for (int s8 = 0; s8 < n_s; s8 += 8) {
        float o[8];
#pragma unroll
        for (int b = 0; b < 8; ++b)
          o[b] = s8 + b < n_s ? p[(s8 + b) * kRow] : 0.0f;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          if (s8 + b >= n_s) break;
          cum[u] = __fadd_rn(cum[u], o[b]);
          out[(size_t)(s8 + b) * n_g * K] =
              __fmul_rn(__fsub_rn(cum[u], __fmul_rn(0.5f, o[b])), dr);
        }
      }
    }
    __syncthreads();  // the next chunk's occupancy overwrites this one's
  }
}

// The (view, voxel) terms of nv views from their T [nv][n_r][n_g][K]: one
// thread per voxel and P views.  terms [nv][n_vox] float2.  KC > 0 fixes
// K at compile time (no predicated products past K).
template <int MAXK, int KC, int P>
__global__ void __launch_bounds__(kTermThreads, kTermBlocks) term_2d_kernel(
    const float* __restrict__ T, const float* __restrict__ src,
    const float* __restrict__ vw, const float* __restrict__ gammas,
    const float* __restrict__ rs, const float* __restrict__ vox,
    const float* __restrict__ rho, const unsigned char* __restrict__ lab,
    const float* __restrict__ muT, const float* __restrict__ mu_dep,
    const float* __restrict__ i0w, float2* __restrict__ terms, int nv,
    int n_g, int n_r, int K_, int E, long long n_vox, float sid, float geom,
    float g_half, float h_over_sid, float dxdy) {
  // KC > 0: the count of materials as a constant (K_ == KC)
  const int K = KC > 0 ? KC : K_;
  extern __shared__ float4 term_smem[];  // 16 B aligned
  float* mu_pad = reinterpret_cast<float*>(term_smem);  // [E][MAXK]
  float* i0w_s = mu_pad + E * MAXK;                     // [E]
  float* depT = i0w_s + E;                              // [E][K]
  load_padded_tables<MAXK>(mu_pad, i0w_s, depT, muT, mu_dep, i0w, K, E);
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_vox) return;
  const int v0 = blockIdx.y * P;
  const Axis G = axis_of(gammas, n_g), Rx = axis_of(rs, n_r);
  const float vx = vox[2 * j], vy = vox[2 * j + 1];
  const int lj = lab[j];
  float t[P][MAXK], phi0[P], r_v[P];
  bool live[P];
  bool any = false;
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int k = 0; k < MAXK; ++k) t[p][k] = 0.0f;
    phi0[p] = r_v[p] = 0.0f;
    live[p] = false;
    const int v = v0 + p;
    if (v >= nv || lj >= K) continue;  // no view, or no material: adds 0
    float g_v;
    voxel_frame(vx, vy, src[2 * v], src[2 * v + 1], sid, &r_v[p], &g_v);
    if (!(fabsf(g_v) <= g_half)) continue;  // out of the fan: adds 0
    live[p] = any = true;
    float wg, wr;
    const int gi = grid_pos(g_v, G.x0, G.d, G.xmax, &wg);
    const int ri = grid_pos(r_v[p], Rx.x0, Rx.d, Rx.xmax, &wr);
    const float* a =
        T + (((size_t)v * n_r + ri) * n_g + gi) * K;  // (g, r)
    const float* b = a + (size_t)n_g * K;             // (g, r + 1)
#pragma unroll
    for (int k = 0; k < MAXK; ++k) {
      if (k >= K) break;
      t[p][k] = lerp(lerp(__ldg(a + k), __ldg(b + k), wr),
                     lerp(__ldg(a + K + k), __ldg(b + K + k), wr), wg);
    }
    phi0[p] = geom / __fmul_rn(r_v[p], r_v[p]);
  }
  float c[P];
#pragma unroll
  for (int p = 0; p < P; ++p) c[p] = 0.0f;
  if (any) {
    // sum_E i0w(E) exp(-t . mu(E)) mu_dep_own(E) of each view, in the
    // first K23's order
    const float* dep = depT + lj;
#pragma unroll kEnergyUnroll
    for (int e = 0; e < E; ++e) {
      float m[MAXK];
#pragma unroll
      for (int q = 0; q < MAXK / 4; ++q) {
        const float4 w = reinterpret_cast<const float4*>(mu_pad + e * MAXK)[q];
        m[4 * q] = w.x;
        m[4 * q + 1] = w.y;
        m[4 * q + 2] = w.z;
        m[4 * q + 3] = w.w;
      }
      const float i0 = i0w_s[e], d = dep[e * K];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < MAXK; ++k)
          if (k < K) s = fmaf(t[p][k], m[k], s);
        c[p] = fmaf(expf(-s) * i0, d, c[p]);
      }
    }
  }
  const float rj = rho[j];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int v = v0 + p;
    if (v >= nv) break;
    float2 out = make_float2(0.0f, 0.0f);
    if (live[p]) {
      const float e_vol = __fmul_rn(phi0[p], c[p]);
      out = make_float2(
          __fmul_rn(vw[v], e_vol / rj),
          __fmul_rn(vw[v], __fmul_rn(__fmul_rn(e_vol, dxdy),
                                     __fmul_rn(h_over_sid, r_v[p]))));
    }
    terms[(size_t)v * n_vox + j] = out;
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int MAXK>
int launch_2d(const unsigned char* labels, unsigned* quads, const float* src,
              const float* ca, const float* sa, const float* vw,
              const float* gammas, const float* rs, const float* vox,
              const float* rho, const unsigned char* lab, const float* muT,
              const float* mu_dep, const float* i0w, float* T,
              float2* terms, float* dose, double* edep, int nv,
              int n_g, int n_r, int K, int E, int nx, int ny,
              long long n_vox, float sid, float dx, float dy, float geom,
              float g_half, float h_over_sid, float dxdy,
              cudaStream_t stream) {
  if (n_g < 2 || n_r < 2) return (int)cudaErrorInvalidValue;
  constexpr int P = MAXK > 8 ? (kViews + 1) / 2 : kViews;
  const long long n_quads = (long long)(ny + 1) * (nx + 1);
  pack_quads_kernel<<<(unsigned)((n_quads + kThreads - 1) / kThreads),
                      kThreads, 0, stream>>>(labels, quads, nx, ny, 1);
  // the term pass with K as a constant for the paths' tables (the
  // reference pelvis's 6 materials, the test phantoms' 3)
  auto term = term_2d_kernel<MAXK, 0, P>;
  if constexpr (kConstK && MAXK == 4) {
    if (K == 3) term = term_2d_kernel<MAXK, 3, P>;
  } else if constexpr (kConstK && MAXK == 8) {
    if (K == 6) term = term_2d_kernel<MAXK, 6, P>;
  }
  const size_t smem = (size_t)E * (MAXK + 1 + K) * sizeof(float);
  cudaError_t err = allow_smem(term, smem);
  if (err != cudaSuccess) return (int)err;
  polar_2d_kernel<MAXK>
      <<<dim3((n_g + kPolarLines - 1) / kPolarLines, nv), kThreads, 0,
         stream>>>(quads, src, ca, sa, rs, T, n_g, n_r, K, nx, ny, dx, dy);
  term<<<dim3((unsigned)((n_vox + kTermThreads - 1) / kTermThreads),
              (nv + P - 1) / P),
         kTermThreads, smem, stream>>>(
      T, src, vw, gammas, rs, vox, rho, lab, muT, mu_dep, i0w,
      terms, nv, n_g, n_r, K, E, n_vox, sid, geom, g_half, h_over_sid, dxdy);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  view_sum_kernel<false><<<(unsigned)((n_vox + kThreads - 1) / kThreads),
                           kThreads, 0, stream>>>(
      terms, nullptr, dose, edep, nv, (int)n_vox, 1, n_vox);
  return (int)cudaGetLastError();
}


template <int MAXK>
int launch_3d(const unsigned char* labels, unsigned* quads, const float* src,
              const float* src_z, const float* ca, const float* sa,
              const float* vw, const int* k0s, const float* gammas,
              const float* ts, const float* sec, const float* rs,
              const float* xc, const float* yc, const float* zc,
              const float* rho, const unsigned char* lab, const float* muT,
              const float* mu_dep, const float* i0w, float2* contrib,
              float* dose, double* edep, int nv, int n_g, int n_t,
              int n_r, int K, int E, int nx, int ny, int nz, int depth,
              long long n_vox, float sid, float dx, float dy, float dz,
              float geom, float g_half, float t_half, float dvol,
              cudaStream_t stream) {
  if (n_g < 2 || n_t < 2 || n_r < 2) return (int)cudaErrorInvalidValue;
  // a chunk takes as many r cells as the patch block's shared memory holds
  // beside the tables, the grids, the chunks' boxes and the queues
  const long long fixed =
      ((long long)E * (MAXK + 1 + K) + 5LL * n_r + nx + ny + nz +
       (kTile / 32) * 7LL * kWarpQueue + 3LL * kLines) * 4;
  const long long per_sample = (long long)kLines * K * 4;
  long long budget = kTileSmem;
  if ((budget - fixed) / per_sample < 2) budget = kTileSmemMax;
  const int R = (int)std::min((budget - fixed) / per_sample - 1,
                              (long long)n_r - 1);
  if (R < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(fixed + per_sample * (R + 1));
  const size_t n_slab = (size_t)depth * nx * ny;
  cudaError_t err = cudaMemsetAsync(contrib, 0, nv * n_slab * sizeof(float2),
                                    stream);
  if (err != cudaSuccess) return (int)err;
  const long long n_quads = (long long)nz * (ny + 1) * (nx + 1);
  pack_quads_kernel<<<(unsigned)((n_quads + kThreads - 1) / kThreads),
                      kThreads, 0, stream>>>(labels, quads, nx, ny, nz);
  err = allow_smem(patch_3d_kernel<MAXK>, smem);
  if (err != cudaSuccess) return (int)err;
  // two blocks an SM need the largest shared-memory carveout
  err = cudaFuncSetAttribute(patch_3d_kernel<MAXK>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
  if (err != cudaSuccess) return (int)err;
  const int n_gp = (n_g - 2) / kPG + 1, n_tp = (n_t - 2) / kPT + 1;
  patch_3d_kernel<MAXK><<<dim3(n_gp * n_tp, nv), kTile, smem, stream>>>(
      quads, src, src_z, ca, sa, vw, k0s, gammas, ts, sec, rs, xc, yc, zc,
      rho, lab, muT, mu_dep, i0w, contrib, n_g, n_t, n_r, K, E, nx, ny, nz,
      depth, R,
      n_gp, sid, dx, dy, dz, geom, g_half, t_half, dvol);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  view_sum_kernel<true><<<(unsigned)((n_vox + kThreads - 1) / kThreads),
                          kThreads, 0, stream>>>(contrib, k0s, dose, edep, nv,
                                                 nx * ny, depth, n_vox);
  return (int)cudaGetLastError();
}

}  // namespace

// One block of nv views of a fan-beam dose map.  labels [ny, nx] uint8;
// src [nv, 2]; ca, sa [nv, n_g]; vw [nv]; gammas [n_g], rs [n_r] (the
// polar grids, at least two samples each); vox [n_vox, 2]; rho [n_vox];
// lab [n_vox] uint8; muT [E, K]; mu_dep [K, E]; i0w [E]; quads scratch
// [ny + 1, nx + 1] uint32; T scratch [nv, n_r, n_g, K]; terms scratch
// [nv, n_vox] float2; dose [n_vox] and edep [ceil(n_vox / 256)]
// (float64) accumulated into.  maxk: 4, 8 or 16 >= K.
extern "C" int dexct_dose_2d(
    const void* labels, const void* src, const void* ca, const void* sa,
    const void* vw, const void* gammas, const void* rs, const void* vox,
    const void* rho, const void* lab, const void* muT, const void* mu_dep,
    const void* i0w, void* quads, void* T, void* terms, void* dose,
    void* edep, int maxk, int nv, int n_g, int n_r,
    int K, int E, int nx, int ny, long long n_vox, float sid, float dx,
    float dy, float geom, float g_half, float h_over_sid, float dxdy,
    void* stream) {
  if (nv <= 0 || n_vox <= 0) return (int)cudaGetLastError();
#define DEXCT_DOSE_2D(M)                                                     \
  launch_2d<M>(static_cast<const unsigned char*>(labels),                    \
               static_cast<unsigned*>(quads),                                \
               static_cast<const float*>(src), static_cast<const float*>(ca), \
               static_cast<const float*>(sa), static_cast<const float*>(vw), \
               static_cast<const float*>(gammas),                            \
               static_cast<const float*>(rs), static_cast<const float*>(vox), \
               static_cast<const float*>(rho),                               \
               static_cast<const unsigned char*>(lab),                       \
               static_cast<const float*>(muT),                               \
               static_cast<const float*>(mu_dep),                            \
               static_cast<const float*>(i0w), static_cast<float*>(T),       \
               static_cast<float2*>(terms), static_cast<float*>(dose),       \
               static_cast<double*>(edep), nv, n_g, n_r, K, E, nx, ny,       \
               n_vox, sid, dx, dy, geom, g_half, h_over_sid, dxdy,           \
               static_cast<cudaStream_t>(stream))
  switch (maxk) {
    case 4:
      return DEXCT_DOSE_2D(4);
    case 8:
      return DEXCT_DOSE_2D(8);
    case 16:
      return DEXCT_DOSE_2D(16);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DEXCT_DOSE_2D
}


// One block of nv views of a cone-beam dose map.  labels [nz, ny, nx]
// uint8; src [nv, 2]; src_z, vw [nv]; k0s [nv] int32 (first slice of each
// view's slab of `depth` slices); gammas [n_g], ts and sec [n_t], rs [n_r]
// (the polar grids, at least two samples each); xc [nx], yc [ny], zc [nz]
// the voxel centres' coordinates along each axis (voxels in raster order,
// n_vox = nz * ny * nx); quads
// scratch [nz, ny + 1, nx + 1] uint32; contrib scratch [nv, depth * ny *
// nx] float2; the rest as dexct_dose_2d.  A zero fill and three launches
// on the stream.
extern "C" int dexct_dose_3d(
    const void* labels, const void* src, const void* src_z, const void* ca,
    const void* sa, const void* vw, const void* k0s, const void* gammas,
    const void* ts, const void* sec, const void* rs, const void* xc,
    const void* yc, const void* zc, const void* rho, const void* lab,
    const void* muT, const void* mu_dep,
    const void* i0w, void* quads, void* contrib, void* dose, void* edep,
    int maxk, int nv,
    int n_g, int n_t, int n_r, int K, int E, int nx, int ny, int nz,
    int depth, long long n_vox, float sid, float dx, float dy, float dz,
    float geom, float g_half, float t_half, float dvol, void* stream) {
  if (nv <= 0 || n_vox <= 0) return (int)cudaGetLastError();
#define DEXCT_DOSE_3D(M)                                                     \
  launch_3d<M>(static_cast<const unsigned char*>(labels),                    \
               static_cast<unsigned*>(quads),                                \
               static_cast<const float*>(src),                               \
               static_cast<const float*>(src_z),                             \
               static_cast<const float*>(ca), static_cast<const float*>(sa), \
               static_cast<const float*>(vw), static_cast<const int*>(k0s),  \
               static_cast<const float*>(gammas),                            \
               static_cast<const float*>(ts), static_cast<const float*>(sec), \
               static_cast<const float*>(rs), static_cast<const float*>(xc), \
               static_cast<const float*>(yc), static_cast<const float*>(zc), \
               static_cast<const float*>(rho),                               \
               static_cast<const unsigned char*>(lab),                       \
               static_cast<const float*>(muT),                               \
               static_cast<const float*>(mu_dep),                            \
               static_cast<const float*>(i0w), static_cast<float2*>(contrib), \
               static_cast<float*>(dose), static_cast<double*>(edep), nv,    \
               n_g, n_t, n_r, K, E, nx, ny, nz, depth, n_vox, sid, dx, dy,   \
               dz, geom, g_half, t_half, dvol,                               \
               static_cast<cudaStream_t>(stream))
  switch (maxk) {
    case 4:
      return DEXCT_DOSE_3D(4);
    case 8:
      return DEXCT_DOSE_3D(8);
    case 16:
      return DEXCT_DOSE_3D(16);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DEXCT_DOSE_3D
}
