// K9 analytic_chords: exact per-material paths of 2-D rays through an
// ordered composition of ellipses (paint order over vacuum).
//
// Replaces the TPU program dexct_tpu/system/analytic.py:analytic_paths, which
// solves all S quadratics per ray, sorts the 2S events with jnp.sort, and
// selects each segment's topmost shape with [R, 2S-1, S] coverage tensors
// and one-hot einsums (TPU idiom: no gathers, no per-lane control flow).
//
// What bounds it on the card: arithmetic.  There are no gathers: the shape
// table (S x 6 floats) is read by every thread at the same address
// (broadcast through L1), each ray reads 16 bytes and writes 4M bytes.
// Design: one thread per ray, no per-thread buffer of any size.  The events
// are walked in increasing order by selection: each pass over the S shapes
// recomputes their (t_in, t_out) (the same float32 operations each time, so
// the same values), tests which shapes cover the current segment's
// midpoint and finds the next larger event.  That is O(S^2) float work per
// ray (~14 x 28 quadratic solves for the pelvis) and takes any S; equal
// events (ties, and the zeros of missed shapes) are stepped over, which
// drops only the zero-length segments that add nothing in the reference.
// The M per-material sums live in registers (M is a template parameter).
//
// Per shape, as the JAX program in float32 without fused multiply-adds (the
// _rn intrinsics): q = p - c; o = (R(angle) q) / (rx, ry);
// v = (R(angle) d) / (rx, ry); a = v.v; b = o.v; c = o.o - 1;
// disc = b b - a c; t_in = max((-b - sqrt(max(disc, 0))) / max(a, 1e-30), 0);
// t_out likewise with +; a shape is hit when disc > 0 and t_out > t_in,
// else both are 0.  Segment (lo, hi): length hi - lo, midpoint
// 0.5 (lo + hi), topmost covering shape s with t_in <= mid < t_out.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Chord {
  float t_in, t_out;
};

__device__ __forceinline__ Chord chord(const float* __restrict__ tab, int s,
                                       float px, float py, float dx,
                                       float dy) {
  const float* sh = tab + 6 * s;
  const float cx = __ldg(sh), cy = __ldg(sh + 1), rx = __ldg(sh + 2);
  const float ry = __ldg(sh + 3), ca = __ldg(sh + 4), sa = __ldg(sh + 5);
  const float qx = __fsub_rn(px, cx), qy = __fsub_rn(py, cy);
  const float ox = __fdiv_rn(__fadd_rn(__fmul_rn(ca, qx), __fmul_rn(sa, qy)),
                             rx);
  const float oy = __fdiv_rn(__fadd_rn(__fmul_rn(-sa, qx), __fmul_rn(ca, qy)),
                             ry);
  const float vx = __fdiv_rn(__fadd_rn(__fmul_rn(ca, dx), __fmul_rn(sa, dy)),
                             rx);
  const float vy = __fdiv_rn(__fadd_rn(__fmul_rn(-sa, dx), __fmul_rn(ca, dy)),
                             ry);
  const float a = __fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy));
  const float b = __fadd_rn(__fmul_rn(ox, vx), __fmul_rn(oy, vy));
  const float c =
      __fsub_rn(__fadd_rn(__fmul_rn(ox, ox), __fmul_rn(oy, oy)), 1.0f);
  const float disc = __fsub_rn(__fmul_rn(b, b), __fmul_rn(a, c));
  const float sq = __fsqrt_rn(fmaxf(disc, 0.0f));
  const float safe_a = fmaxf(a, 1e-30f);
  Chord ch;
  ch.t_in = fmaxf(__fdiv_rn(__fsub_rn(-b, sq), safe_a), 0.0f);
  ch.t_out = fmaxf(__fdiv_rn(__fadd_rn(-b, sq), safe_a), 0.0f);
  if (!(disc > 0.0f && ch.t_out > ch.t_in)) ch.t_in = ch.t_out = 0.0f;
  return ch;
}

template <int M>
__global__ void analytic_chords_kernel(const float* __restrict__ tab,
                                       const int* __restrict__ labels,
                                       const float* __restrict__ src,
                                       const float* __restrict__ dirs,
                                       float* __restrict__ out,
                                       long long n_rays, int S, int n_out) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float px = src[2 * r], py = src[2 * r + 1];
  const float dx = dirs[2 * r], dy = dirs[2 * r + 1];

  float acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.0f;

  // the smallest event, then the next larger one
  float cur = INFINITY;
  for (int s = 0; s < S; ++s) {
    const Chord ch = chord(tab, s, px, py, dx, dy);
    cur = fminf(cur, fminf(ch.t_in, ch.t_out));
  }
  float nxt = INFINITY;
  for (int s = 0; s < S; ++s) {
    const Chord ch = chord(tab, s, px, py, dx, dy);
    if (ch.t_in > cur) nxt = fminf(nxt, ch.t_in);
    if (ch.t_out > cur) nxt = fminf(nxt, ch.t_out);
  }
  // one pass per segment (cur, nxt): its topmost cover, and the event
  // after nxt
  while (nxt < INFINITY) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(cur, nxt));
    int top = -1;
    float after = INFINITY;
    for (int s = 0; s < S; ++s) {
      const Chord ch = chord(tab, s, px, py, dx, dy);
      if (mid >= ch.t_in && mid < ch.t_out) top = s;
      if (ch.t_in > nxt) after = fminf(after, ch.t_in);
      if (ch.t_out > nxt) after = fminf(after, ch.t_out);
    }
    if (top >= 0) {
      const int lab = __ldg(labels + top);
      const float seg = __fsub_rn(nxt, cur);
#pragma unroll
      for (int m = 0; m < M; ++m) acc[m] += (lab == m) ? seg : 0.0f;
    }
    cur = nxt;
    nxt = after;
  }
  float* o = out + r * n_out;
#pragma unroll
  for (int m = 0; m < M; ++m)
    if (m < n_out) o[m] = acc[m];
}

template <int M>
void launch(const float* tab, const int* labels, const float* src,
            const float* dirs, float* out, long long n_rays, int S, int n_out,
            cudaStream_t stream) {
  const int threads = 128;
  const long long blocks = (n_rays + threads - 1) / threads;
  analytic_chords_kernel<M><<<(unsigned)blocks, threads, 0, stream>>>(
      tab, labels, src, dirs, out, n_rays, S, n_out);
}

}  // namespace

extern "C" int dexct_analytic_chords(const void* tab, const void* labels,
                                     const void* src, const void* dirs,
                                     void* out, long long n_rays, int S,
                                     int n_materials, void* stream) {
  const float* t = static_cast<const float*>(tab);
  const int* l = static_cast<const int*>(labels);
  const float* s = static_cast<const float*>(src);
  const float* d = static_cast<const float*>(dirs);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_rays <= 0) return (int)cudaGetLastError();
  if (S <= 0) return (int)cudaErrorInvalidValue;
#define DEXCT_CASE(MM) launch<MM>(t, l, s, d, o, n_rays, S, n_materials, st)
  switch (n_materials) {
    case 1: DEXCT_CASE(1); break;
    case 2: DEXCT_CASE(2); break;
    case 3: DEXCT_CASE(3); break;
    case 4: DEXCT_CASE(4); break;
    case 5: DEXCT_CASE(5); break;
    case 6: DEXCT_CASE(6); break;
    case 7: DEXCT_CASE(7); break;
    case 8: DEXCT_CASE(8); break;
    default:
      if (n_materials <= 16) {
        DEXCT_CASE(16);
      } else if (n_materials <= 32) {
        DEXCT_CASE(32);
      } else {
        return (int)cudaErrorInvalidValue;
      }
  }
#undef DEXCT_CASE
  return (int)cudaGetLastError();
}
