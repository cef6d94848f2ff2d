// K20 geo_warp_fwd and K21 geo_warp_bwd: the triangle search of the
// vertex-grid warp (--optimize_geo_start) and its gradient.
//
// Replaces videoloop3d_tpu/render/geo_warp.py:warp_coordinates_verts (and
// its _bary), whose gradient JAX takes by autodiff of the 3x3-quad x
// 2-triangle loop.  The vertex projection stays in PyTorch (an einsum in
// the JAX package); these kernels take its (B, D, Hv, Wv) arrays: pixel
// position vpx, vpy and view depth vz of every vertex.
//
// K20, per (view b, plane d, pixel (px, py)): starting from the quad
// (qi0, qj0) of the flat plane sweep, test the 3x3 neighbouring quads
// (di, dj in -1, 0, 1, row-major; each clipped to the grid) and their two
// triangles, 013 = (TL, TR, BR) before 320 = (BR, BL, TL); among
// triangles whose three vertices are in front (vz > 1e-6) keep the first
// strict maximum of the smallest barycentric.  Write the winner's
// barycentric interpolation of the fixed texel UVs (x, y) and of the view
// depths (z), valid = score > -1e-4 && z > 1e-6 && (x, y) inside the
// plane texture, and the winner as an int8 (quad offset * 2 + triangle,
// -1 for none; x, y, z are then 0, 0, 1).
// The barycentric arithmetic is JAX's, one rounding per operation
// (__fmul_rn, __fadd_rn, __fdiv_rn: nvcc contracts nothing into an FMA),
// so the winner at a shared edge, where two scores are both near 0, is
// the plain version's whenever its inputs are bit-equal.
//
// K21 recomputes each sample's winning barycentrics the same way and
// adds the cotangents of x, y, z onto the triangle's three vertices
// (d/d vpx, vpy, vz).  Where JAX clamps the barycentric denominator
// (|den| < 1e-12) the derivative through den is zero, as in autodiff of
// jnp.where.  Samples with a zero cotangent or no winner add nothing.
//
// Bound on the H100: K20 reads 8 B of quad guess per sample and writes
// 14 B; each sample evaluates 18 triangles, ~25 f32 operations each (two
// of them IEEE divisions, each a sequence of about 8 instructions), so at
// production shapes (1.84 M samples) it is bound by issue, not bytes.
// The vertex arrays (3 x B x D x Hv x Wv f32, 295 KB at 32 x 36 x 64)
// stay in L1/L2.  K21 reads 12 B of cotangent, 8 B of quad guess and 1 B
// of winner per sample and writes the vertex arrays once.
//
// Both take one block a (view, plane) and a tile of 32 x 32 pixels, each
// of its 8 warps 4 rows of 32, and the block's window: the vertices its
// samples' 3 x 3 quad searches can reach, rows from the smallest clamped
// qi0 - 1 to the largest clamped qi0 + 1 plus the far corner, columns
// likewise, cut to at most 32 columns and 256 vertices (geo_block_window
// and geo_bwd_plan, one plan for both; render/geo_warp.py:geo_bwd_layout
// mirrors it).  A block writes its window and its counts in a header.
//
// K20 runs two passes on a 3-D grid (tile column, tile row, plane).  The
// first (geo_window_kernel) writes each block's window into its header;
// it reads the quad guesses, so that the second finds them in L2 and
// starts at once where its inputs come cold from device memory (a single
// pass, each block waiting on its guesses before it could stage, lost
// most of its gain so).  The second
// (geo_fwd_tile_kernel) reads its window, stages the window's vpx, vpy,
// vz and its uv columns and rows in shared memory once, then computes
// once a block, for each triangle of the
// window, its edge vectors v0, v1 and its clamped denominator with bary's
// own operations, v0 and v1 negated where den < 0 (the numerators then
// change sign exactly and n / den keeps its bits), and den 0 for a
// triangle with a corner behind the camera (a clamped den is never 0).  A
// sample then searches its 18 triangles from that table (search_staged):
// (A) each triangle's two numerators, without division; a triangle is a
// candidate unless a numerator is <= 0 or > den (then b1 or b2 <= 0, or
// b0 <= 0: its score is <= 0); a NaN stays a candidate.  (B) The lane's
// candidates (one to three, typically) in the order q = 0..8, t = 0, 1,
// with the two divisions, b0, the NaN-propagating minimum and the compare:
// where the best score is > 0, no triangle left out could beat it, and the
// first strict maximum is the first design's winner.  (C) Else (a pixel
// outside every triangle, on an edge, or corners behind) every triangle is
// searched in order.  Every division stays bary's division, so x, y, z,
// valid and tri are bit for bit the first design's.  The winner's
// interpolation of the staged uv and depths is made once, after the
// search.  A sample whose reach leaves its block's window (an oblique
// view, a cut window) runs the first design's search from global memory
// (search_global), counted in the header.  x, y, z, valid and tri are
// written in rows of 32 pixels.  K20's first design
// (geo_warp_fwd_first_kernel, vl3d_geo_warp_fwd_first, kept for
// comparison) ran one thread a sample on a 1-D grid: two 64-bit divisions
// and remainders to find it, 108 vertex and 72 uv loads, and each
// triangle's edges, denominator and two divisions for every sample.
//
// K21's first design (geo_warp_bwd_first_kernel, vl3d_geo_warp_bwd_first,
// kept for comparison) ran one thread a sample with 9 global float
// atomics each: at the stage-1 patch 16.6 M adds onto 3 x 73,728
// addresses, a few hundred onto each, serialized in L2 (0.43 ms).  The
// redesign (geo_bwd_tile_kernel + geo_bwd_sum_kernel) reduces on chip:
// each warp adds its samples' 9 values into its own copy of the window in
// shared memory, row by row and corner slot by corner slot: the runs of
// lanes on one vertex are summed by a segmented scan (5 shuffle steps),
// and each run's last lane adds its sum, in rounds where a vertex has
// several runs (add_slot).  The block then sums the warps' copies in warp
// order and writes the window once to a scratch.  A second pass gives
// each vertex the sum of the windows that hold it in block order: the
// same bits on every call.  A sample with a corner outside its block's
// window takes the first design's route, 9 global atomics, into the
// zero-filled output that the second pass adds to; the headers count
// those samples.
#include "common.cuh"

namespace {

struct Bary {
  float b0, b1, b2;
  float den;     // the (possibly clamped) denominator
  bool clamped;  // |den| < 1e-12 was replaced by +-1e-12
};

// JAX's _bary, operation by operation.
__device__ __forceinline__ Bary bary(float px, float py, float ax, float ay,
                                     float bx, float by, float cx,
                                     float cy) {
  const float v0x = __fsub_rn(bx, ax), v0y = __fsub_rn(by, ay);
  const float v1x = __fsub_rn(cx, ax), v1y = __fsub_rn(cy, ay);
  const float v2x = __fsub_rn(px, ax), v2y = __fsub_rn(py, ay);
  Bary r;
  float den = __fsub_rn(__fmul_rn(v0x, v1y), __fmul_rn(v1x, v0y));
  r.clamped = fabsf(den) < 1e-12f;
  if (r.clamped) den = den < 0.0f ? -1e-12f : 1e-12f;
  r.den = den;
  r.b1 = __fdiv_rn(__fsub_rn(__fmul_rn(v2x, v1y), __fmul_rn(v1x, v2y)), den);
  r.b2 = __fdiv_rn(__fsub_rn(__fmul_rn(v0x, v2y), __fmul_rn(v2x, v0y)), den);
  r.b0 = __fsub_rn(__fsub_rn(1.0f, r.b1), r.b2);
  return r;
}

// jnp.minimum: a NaN operand propagates (fminf would drop it)
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// b0 * a + b1 * b + b2 * c, left to right
__device__ __forceinline__ float interp(const Bary& w, float a, float b,
                                        float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(w.b0, a), __fmul_rn(w.b1, b)),
                   __fmul_rn(w.b2, c));
}

// Quad corners c = 0..3 are TL, TR, BR, BL: row offset c >> 1, column
// offset 1 for TR and BR.  Triangle t's k-th corner: 013 (t = 0) and 320
// (t = 1).  Functions, not tables, so the unrolled forward loops fold
// them to constants and keep the corner arrays in registers.
__device__ __forceinline__ int corner_di(int c) { return c >> 1; }
__device__ __forceinline__ int corner_dj(int c) {
  return (c == 1 || c == 2) ? 1 : 0;
}
__device__ __forceinline__ int tri_corner(int t, int k) {
  return t == 0 ? k : (k + 2) & 3;
}

struct Sample {
  int px, py;
  long long bd;   // b * D + d
};

__device__ __forceinline__ Sample sample_of(long long idx, int h, int w) {
  Sample s;
  s.px = (int)(idx % w);
  const long long r = idx / w;
  s.py = (int)(r % h);
  s.bd = r / h;
  return s;
}

// A sample's search result: the winner's interpolated (x, y, z), its
// score and its code (quad offset * 2 + triangle, -1 for none)
struct Found {
  float x, y, z, best;
  int win;
};

// The first design's search of one sample, from global memory: each quad's
// corners loaded and each triangle's barycentrics made in full, in the
// order q = 0..8, t = 0, 1.
__device__ __forceinline__ Found search_global(
    const float* __restrict__ vpx, const float* __restrict__ vpy,
    const float* __restrict__ vz, const float* __restrict__ uvx,
    const float* __restrict__ uvy, long long base, int i0, int j0, float px,
    float py, int Hv, int Wv) {
  Found f{0.0f, 0.0f, 1.0f, -INFINITY, -1};
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const int qi = min(max(i0 + q / 3 - 1, 0), Hv - 2);
    const int qj = min(max(j0 + q % 3 - 1, 0), Wv - 2);
    float cx[4], cy[4], cz[4], cu[4], cv[4];
    bool ok[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int vi = qi + corner_di(c), vj = qj + corner_dj(c);
      const long long v = base + (long long)vi * Wv + vj;
      cx[c] = __ldg(vpx + v);
      cy[c] = __ldg(vpy + v);
      cz[c] = __ldg(vz + v);
      ok[c] = cz[c] > 1e-6f;
      cu[c] = __ldg(uvx + vj);
      cv[c] = __ldg(uvy + vi);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int a = tri_corner(t, 0), b = tri_corner(t, 1),
                c = tri_corner(t, 2);
      if (!(ok[a] && ok[b] && ok[c])) continue;   // score -inf: never wins
      const Bary r = bary(px, py, cx[a], cy[a], cx[b], cy[b], cx[c], cy[c]);
      const float score = min_nan(min_nan(r.b0, r.b1), r.b2);
      if (score > f.best) {
        f.best = score;
        f.x = interp(r, cu[a], cu[b], cu[c]);
        f.y = interp(r, cv[a], cv[b], cv[c]);
        f.z = interp(r, cz[a], cz[b], cz[c]);
        f.win = 2 * q + t;
      }
    }
  }
  return f;
}

__device__ __forceinline__ void store_found(
    const Found& f, long long idx, float x_max, float y_max,
    float* __restrict__ xo, float* __restrict__ yo, float* __restrict__ zo,
    uint8_t* __restrict__ valid_o, int8_t* __restrict__ tri_o) {
  const bool inside = f.x >= 0.0f && f.x <= x_max && f.y >= 0.0f
      && f.y <= y_max;
  xo[idx] = f.x;
  yo[idx] = f.y;
  zo[idx] = f.z;
  valid_o[idx] = (f.best > -1e-4f && f.z > 1e-6f && inside) ? 1 : 0;
  tri_o[idx] = (int8_t)f.win;
}

// K20's first design (see the header)
__global__ void geo_warp_fwd_first_kernel(
    const float* __restrict__ vpx, const float* __restrict__ vpy,
    const float* __restrict__ vz, const int* __restrict__ qi0,
    const int* __restrict__ qj0, const float* __restrict__ uvx,
    const float* __restrict__ uvy, long long n, int h, int w, int Hv, int Wv,
    float x_max, float y_max, float* __restrict__ xo, float* __restrict__ yo,
    float* __restrict__ zo, uint8_t* __restrict__ valid_o,
    int8_t* __restrict__ tri_o) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const Sample s = sample_of(idx, h, w);
  const Found f = search_global(vpx, vpy, vz, uvx, uvy, s.bd * Hv * Wv,
                                qi0[idx], qj0[idx], (float)s.px,
                                (float)s.py, Hv, Wv);
  store_found(f, idx, x_max, y_max, xo, yo, zo, valid_o, tri_o);
}

// K20's and K21's block: a (view, plane) and a tile of kGeoTileH rows x
// kGeoTileW pixels; each of its kGeoWarps warps takes kGeoRows pixel rows
constexpr int kGeoTileW = 32;
constexpr int kGeoWarps = 8;
constexpr int kGeoRows = 4;
constexpr int kGeoTileH = kGeoWarps * kGeoRows;
constexpr int kGeoThreads = kGeoWarps * 32;
constexpr int kWinCap = 256;    // window vertices a block stages
constexpr int kWinMaxC = 32;    // window columns at most
constexpr int kHdrInts = 8;     // r0, c0, rows, cols, two counts, 0, 0
// triangles of a window: 2 (rows - 1) (columns - 1) < 2 kWinCap
constexpr int kTriCap = 2 * kWinCap;

// a tile's window: the first vertex row and column, the rows and the
// columns, from the extreme reachable vertex rows rlo..rhi and columns
// clo..chi of its samples (rlo > rhi: none)
__device__ __forceinline__ int4 geo_bwd_plan(int rlo, int rhi, int clo,
                                             int chi) {
  if (rlo > rhi || clo > chi) return make_int4(0, 0, 0, 0);
  const int nc = min(chi - clo + 1, kWinMaxC);
  return make_int4(rlo, clo, min(rhi - rlo + 1, kWinCap / nc), nc);
}

// The window of the block whose warp `warp` holds rows py0 .. py0 +
// kGeoRows - 1 of column px (lane `lane`) of plane `plane`: the extremes
// of its samples' reach reduced over the warp, then over the block
// through ext (kGeoWarps x 4 ints of shared memory), and cut by
// geo_bwd_plan.  Every thread of the block calls it.
__device__ __forceinline__ int4 geo_block_window(
    const int* __restrict__ qi0, const int* __restrict__ qj0,
    long long plane, int py0, int px, int h, int w, int Hv, int Wv,
    int warp, int lane, int (*ext)[4]) {
  int rlo = 0x7fffffff, rhi = -1, clo = 0x7fffffff, chi = -1;
#pragma unroll
  for (int r = 0; r < kGeoRows; ++r) {
    const int py = py0 + r;
    if (py < h && px < w) {
      const long long idx = (plane * h + py) * w + px;
      const int i0 = qi0[idx], j0 = qj0[idx];
      rlo = min(rlo, min(max(i0 - 1, 0), Hv - 2));
      rhi = max(rhi, min(max(i0 + 1, 0), Hv - 2) + 1);
      clo = min(clo, min(max(j0 - 1, 0), Wv - 2));
      chi = max(chi, min(max(j0 + 1, 0), Wv - 2) + 1);
    }
  }
  rlo = __reduce_min_sync(0xffffffffu, rlo);
  rhi = __reduce_max_sync(0xffffffffu, rhi);
  clo = __reduce_min_sync(0xffffffffu, clo);
  chi = __reduce_max_sync(0xffffffffu, chi);
  if (lane == 0) {
    ext[warp][0] = rlo;
    ext[warp][1] = rhi;
    ext[warp][2] = clo;
    ext[warp][3] = chi;
  }
  __syncthreads();
  const bool mine = lane < kGeoWarps;
  rlo = __reduce_min_sync(0xffffffffu, mine ? ext[lane][0] : 0x7fffffff);
  rhi = __reduce_max_sync(0xffffffffu, mine ? ext[lane][1] : -1);
  clo = __reduce_min_sync(0xffffffffu, mine ? ext[lane][2] : 0x7fffffff);
  chi = __reduce_max_sync(0xffffffffu, mine ? ext[lane][3] : -1);
  return geo_bwd_plan(rlo, rhi, clo, chi);
}

// The staged window of K20's block: the vertices' pixel positions and
// depths, the uv of its columns and rows, and each triangle's terms that
// do not depend on the pixel, as bary makes them.
struct GeoStage {
  float sx[kWinCap], sy[kWinCap], sz[kWinCap];
  float su[kWinMaxC], sv[kWinCap];
  float4 tri_a[kTriCap];   // ax, ay, v0x, v0y
  float4 tri_b[kTriCap];   // v1x, v1y, den (0: a corner behind), 0
};

// The first design's search as a call, for the redesign's rare samples
// whose reach leaves the window (keeps its registers out of the
// redesign's loop)
__device__ __noinline__ Found search_global_call(
    const float* __restrict__ vpx, const float* __restrict__ vpy,
    const float* __restrict__ vz, const float* __restrict__ uvx,
    const float* __restrict__ uvy, long long base, int i0, int j0, float px,
    float py, int Hv, int Wv) {
  return search_global(vpx, vpy, vz, uvx, uvy, base, i0, j0, px, py, Hv, Wv);
}

// The table entry of triangle i = 2 q + t of the 3 x 3 quads around the
// guess (i0, j0) (q row-major, each quad clamped to the grid), in the
// window whose first row and column are r0, c0 and whose quads a row are
// qc
__device__ __forceinline__ int tri_entry(int i, int i0, int j0, int r0,
                                         int c0, int qc, int Hv, int Wv) {
  const int q = i >> 1;
  const int dr = (q * 11) >> 5;                  // q / 3 for q < 9
  const int li = min(max(i0 + dr - 1, 0), Hv - 2) - r0;
  const int lj = min(max(j0 + q - 3 * dr - 1, 0), Wv - 2) - c0;
  return (li * qc + lj) * 2 + (i & 1);
}

// Triangle i's barycentrics from the table (den > 0 there), as bary makes
// them; the winner so far (f.x, f.y, f.z: its b0, b1, b2) kept unless i
// scores strictly more.
__device__ __forceinline__ void visit_tri(const GeoStage& st, int e, int i,
                                          float fx, float fy, Found& f) {
  const float4 A = st.tri_a[e];
  const float4 B = st.tri_b[e];
  const float v2x = __fsub_rn(fx, A.x), v2y = __fsub_rn(fy, A.y);
  const float n1 = __fsub_rn(__fmul_rn(v2x, B.y), __fmul_rn(B.x, v2y));
  const float n2 = __fsub_rn(__fmul_rn(A.z, v2y), __fmul_rn(v2x, A.w));
  const float b1 = __fdiv_rn(n1, B.z), b2 = __fdiv_rn(n2, B.z);
  const float b0 = __fsub_rn(__fsub_rn(1.0f, b1), b2);
  const float score = min_nan(min_nan(b0, b1), b2);
  if (score > f.best) {
    f.best = score;
    f.x = b0;
    f.y = b1;
    f.z = b2;
    f.win = i;
  }
}

// One sample's search over the staged window (its 3 x 3 quads all inside
// it), returning the winner's code, score and barycentrics (f.x, f.y,
// f.z = b0, b1, b2).  (A) Each triangle's numerators n1, n2, without
// division: a triangle is a candidate unless a corner is behind (den 0),
// or a numerator is <= 0 (b1 or b2 <= 0), or n1 > den or n2 > den (b1 or
// b2 >= 1, so b0 <= 0); every triangle left out scores <= 0.  A NaN
// numerator stays a candidate.  (B) Each lane's candidates, in the order
// of i, keeping the first strict maximum: where it is > 0 it is the first
// design's winner.  (C) Else every triangle in order.  Every division is
// bary's.
__device__ __forceinline__ Found search_staged(const GeoStage& st, int i0,
                                               int j0, int r0, int c0,
                                               int nc, int Hv, int Wv,
                                               float fx, float fy) {
  const int qc = nc - 1;
  int lr[3], lc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lr[k] = (min(max(i0 + k - 1, 0), Hv - 2) - r0) * qc;
    lc[k] = min(max(j0 + k - 1, 0), Wv - 2) - c0;
  }
  unsigned cand = 0;
#pragma unroll
  for (int i = 0; i < 18; ++i) {
    const int e = (lr[i / 6] + lc[(i >> 1) % 3]) * 2 + (i & 1);
    const float4 A = st.tri_a[e];
    const float4 B = st.tri_b[e];
    const float v2x = __fsub_rn(fx, A.x), v2y = __fsub_rn(fy, A.y);
    const float n1 = __fsub_rn(__fmul_rn(v2x, B.y), __fmul_rn(B.x, v2y));
    const float n2 = __fsub_rn(__fmul_rn(A.z, v2y), __fmul_rn(v2x, A.w));
    if (!(n1 <= 0.0f || n2 <= 0.0f || n1 > B.z || n2 > B.z))
      cand |= 1u << i;
  }
  Found f{0.0f, 0.0f, 0.0f, -INFINITY, -1};
  while (cand) {
    const int i = __ffs(cand) - 1;
    cand &= cand - 1;
    visit_tri(st, tri_entry(i, i0, j0, r0, c0, qc, Hv, Wv), i, fx, fy, f);
  }
  if (!(f.best > 0.0f)) {
    f = Found{0.0f, 0.0f, 0.0f, -INFINITY, -1};
#pragma unroll
    for (int i = 0; i < 18; ++i) {
      const int e = (lr[i / 6] + lc[(i >> 1) % 3]) * 2 + (i & 1);
      if (st.tri_b[e].z != 0.0f) visit_tri(st, e, i, fx, fy, f);
    }
  }
  return f;
}

// K20's redesign (see the header).  Header: r0, c0, rows, columns, the
// samples of the global route, the block's samples.  At most 80 registers
// a thread, so that 3 blocks share an SM (2 or 4 were slower).
// K20's first pass: each block's window (geo_block_window) into its header
// (r0, c0, rows, columns), so that the search's blocks read it at once and
// find the quad guesses, read here, in L2
__global__ void __launch_bounds__(kGeoThreads) geo_window_kernel(
    const int* __restrict__ qi0, const int* __restrict__ qj0, int h, int w,
    int Hv, int Wv, int* __restrict__ hdr) {
  __shared__ int ext[kGeoWarps][4];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long plane = blockIdx.z;
  const int py0 = blockIdx.y * kGeoTileH + warp * kGeoRows;
  const int px = blockIdx.x * kGeoTileW + lane;
  const int4 win = geo_block_window(qi0, qj0, plane, py0, px, h, w, Hv, Wv,
                                    warp, lane, ext);
  if (threadIdx.x == 0) {
    const long long blk =
        (plane * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    *reinterpret_cast<int4*>(hdr + blk * kHdrInts) = win;
  }
}

__global__ void __launch_bounds__(kGeoThreads, 3) geo_fwd_tile_kernel(
    const float* __restrict__ vpx, const float* __restrict__ vpy,
    const float* __restrict__ vz, const int* __restrict__ qi0,
    const int* __restrict__ qj0, const float* __restrict__ uvx,
    const float* __restrict__ uvy, int h, int w, int Hv, int Wv,
    float x_max, float y_max, float* __restrict__ xo, float* __restrict__ yo,
    float* __restrict__ zo, uint8_t* __restrict__ valid_o,
    int8_t* __restrict__ tri_o, int* __restrict__ hdr) {
  __shared__ GeoStage st;
  __shared__ int cnt[kGeoWarps][2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long plane = blockIdx.z;
  const int py0 = blockIdx.y * kGeoTileH + warp * kGeoRows;
  const int px = blockIdx.x * kGeoTileW + lane;
  const long long base = plane * Hv * Wv;
  const long long blk =
      (plane * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  const int4 win = *reinterpret_cast<const int4*>(hdr + blk * kHdrInts);
  const int r0 = win.x, c0 = win.y, nr = win.z, nc = win.w;
  for (int l = threadIdx.x; l < nr * nc; l += kGeoThreads) {
    const int li = l / nc;
    const long long v = base + (long long)(r0 + li) * Wv + c0 + l - li * nc;
    st.sx[l] = vpx[v];
    st.sy[l] = vpy[v];
    st.sz[l] = vz[v];
  }
  if (threadIdx.x < nc) st.su[threadIdx.x] = uvx[c0 + threadIdx.x];
  if (threadIdx.x < nr) st.sv[threadIdx.x] = uvy[r0 + threadIdx.x];
  __syncthreads();
  const int qc = nc - 1;
  const int ntri = nr > 0 ? 2 * (nr - 1) * qc : 0;
  for (int e = threadIdx.x; e < ntri; e += kGeoThreads) {
    const int t = e & 1, q = e >> 1, li = q / qc, lj = q - li * qc;
    int k3[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int c = tri_corner(t, k);
      k3[k] = (li + corner_di(c)) * nc + lj + corner_dj(c);
    }
    const int a = k3[0], b = k3[1], c = k3[2];
    const float v0x = __fsub_rn(st.sx[b], st.sx[a]);
    const float v0y = __fsub_rn(st.sy[b], st.sy[a]);
    const float v1x = __fsub_rn(st.sx[c], st.sx[a]);
    const float v1y = __fsub_rn(st.sy[c], st.sy[a]);
    float den = __fsub_rn(__fmul_rn(v0x, v1y), __fmul_rn(v1x, v0y));
    if (fabsf(den) < 1e-12f) den = den < 0.0f ? -1e-12f : 1e-12f;
    const bool front =
        st.sz[a] > 1e-6f && st.sz[b] > 1e-6f && st.sz[c] > 1e-6f;
    // den < 0: v0 and v1 negated (the numerators negated exactly, den
    // kept), so that den > 0 and n / den is unchanged
    const float sg = den < 0.0f ? -1.0f : 1.0f;
    st.tri_a[e] = make_float4(st.sx[a], st.sy[a], sg * v0x, sg * v0y);
    st.tri_b[e] = make_float4(sg * v1x, sg * v1y, front ? fabsf(den) : 0.0f,
                              0.0f);
  }
  __syncthreads();
  int n_global = 0, n_in = 0;
#pragma unroll 1
  for (int r = 0; r < kGeoRows; ++r) {
    const int py_i = py0 + r;
    const bool in = py_i < h && px < w;
    bool global = false;
    if (in) {
      const long long idx = (plane * h + py_i) * w + px;
      const float fx = (float)px, fy = (float)py_i;
      const int i0 = qi0[idx], j0 = qj0[idx];
      global = min(max(i0 - 1, 0), Hv - 2) < r0
          || min(max(i0 + 1, 0), Hv - 2) + 1 >= r0 + nr
          || min(max(j0 - 1, 0), Wv - 2) < c0
          || min(max(j0 + 1, 0), Wv - 2) + 1 >= c0 + nc;
      Found f;
      if (global) {
        f = search_global_call(vpx, vpy, vz, uvx, uvy, base, i0, j0, fx, fy,
                               Hv, Wv);
      } else {
        f = search_staged(st, i0, j0, r0, c0, nc, Hv, Wv, fx, fy);
        // the winner's interpolation of the staged uv and depths
        const Bary wb{f.x, f.y, f.z, 0.0f, false};
        f.x = 0.0f;
        f.y = 0.0f;
        f.z = 1.0f;
        if (f.win >= 0) {
          const int qc = nc - 1;
          const int e = tri_entry(f.win, i0, j0, r0, c0, qc, Hv, Wv) >> 1;
          const int li = e / qc, lj = e - li * qc, t = f.win & 1;
          float u3[3], v3[3], z3[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const int c = tri_corner(t, k);
            const int di = corner_di(c), dj = corner_dj(c);
            u3[k] = st.su[lj + dj];
            v3[k] = st.sv[li + di];
            z3[k] = st.sz[(li + di) * nc + lj + dj];
          }
          f.x = interp(wb, u3[0], u3[1], u3[2]);
          f.y = interp(wb, v3[0], v3[1], v3[2]);
          f.z = interp(wb, z3[0], z3[1], z3[2]);
        }
      }
      store_found(f, idx, x_max, y_max, xo, yo, zo, valid_o, tri_o);
    }
    n_global += __popc(__ballot_sync(0xffffffffu, global));
    n_in += __popc(__ballot_sync(0xffffffffu, in));
  }
  if (lane == 0) {
    cnt[warp][0] = n_global;
    cnt[warp][1] = n_in;
  }
  __syncthreads();
  // the counts beside the window the first pass wrote
  if (threadIdx.x >= 4 && threadIdx.x < kHdrInts) {
    int v = 0;
    if (threadIdx.x < 6) {
      for (int k = 0; k < kGeoWarps; ++k) v += cnt[k][threadIdx.x - 4];
    }
    hdr[blk * kHdrInts + threadIdx.x] = v;
  }
}

// The 9 values a sample with winner `win` adds: each triangle corner's
// vertex (row, column) and d/d (vpx, vpy, vz) there.
struct SampleGrad {
  int vi[3], vj[3];
  float dpx[3], dpy[3], dz[3];
};

__device__ __forceinline__ SampleGrad sample_grad(
    int win, float g_x, float g_y, float g_z, int px_i, int py_i, int i0,
    int j0, long long base, int Hv, int Wv, const float* __restrict__ vpx,
    const float* __restrict__ vpy, const float* __restrict__ vz,
    const float* __restrict__ uvx, const float* __restrict__ uvy) {
  SampleGrad o;
  const int q = win >> 1, t = win & 1;
  const int qi = min(max(i0 + q / 3 - 1, 0), Hv - 2);
  const int qj = min(max(j0 + q % 3 - 1, 0), Wv - 2);
  float px3[3], py3[3], pz3[3], u3[3], v3[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int c = tri_corner(t, k);
    o.vi[k] = qi + corner_di(c);
    o.vj[k] = qj + corner_dj(c);
    const long long v = base + (long long)o.vi[k] * Wv + o.vj[k];
    px3[k] = __ldg(vpx + v);
    py3[k] = __ldg(vpy + v);
    pz3[k] = __ldg(vz + v);
    u3[k] = __ldg(uvx + o.vj[k]);
    v3[k] = __ldg(uvy + o.vi[k]);
  }
  const float px = (float)px_i, py = (float)py_i;
  const Bary r = bary(px, py, px3[0], py3[0], px3[1], py3[1], px3[2], py3[2]);
  // z = b0 za + b1 zb + b2 zc: the depths' own share
  o.dz[0] = g_z * r.b0;
  o.dz[1] = g_z * r.b1;
  o.dz[2] = g_z * r.b2;
  // cotangents of the barycentrics; b0 = 1 - b1 - b2
  const float gb0 = g_x * u3[0] + g_y * v3[0] + g_z * pz3[0];
  const float gb1 = g_x * u3[1] + g_y * v3[1] + g_z * pz3[1] - gb0;
  const float gb2 = g_x * u3[2] + g_y * v3[2] + g_z * pz3[2] - gb0;
  const float v0x = px3[1] - px3[0], v0y = py3[1] - py3[0];
  const float v1x = px3[2] - px3[0], v1y = py3[2] - py3[0];
  const float v2x = px - px3[0], v2y = py - py3[0];
  // b1 = n1 / den, b2 = n2 / den
  const float gn1 = gb1 / r.den, gn2 = gb2 / r.den;
  const float gden =
      r.clamped ? 0.0f : -(gb1 * r.b1 + gb2 * r.b2) / r.den;
  // n1 = v2x v1y - v1x v2y;  n2 = v0x v2y - v2x v0y;
  // den = v0x v1y - v1x v0y
  const float g_v0x = gn2 * v2y + gden * v1y;
  const float g_v0y = -gn2 * v2x - gden * v1x;
  const float g_v1x = -gn1 * v2y - gden * v0y;
  const float g_v1y = gn1 * v2x + gden * v0x;
  const float g_v2x = gn1 * v1y - gn2 * v0y;
  const float g_v2y = -gn1 * v1x + gn2 * v0x;
  // v0 = b - a, v1 = c - a, v2 = p - a (the pixel is constant)
  o.dpx[0] = -(g_v0x + g_v1x + g_v2x);
  o.dpy[0] = -(g_v0y + g_v1y + g_v2y);
  o.dpx[1] = g_v0x;
  o.dpy[1] = g_v0y;
  o.dpx[2] = g_v1x;
  o.dpy[2] = g_v1y;
  return o;
}

// a sample's 9 values as global atomics (the first design's route)
__device__ __forceinline__ void add_atomic(const SampleGrad& o,
                                           long long base, int Wv,
                                           float* __restrict__ d_vpx,
                                           float* __restrict__ d_vpy,
                                           float* __restrict__ d_vz) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const long long v = base + (long long)o.vi[k] * Wv + o.vj[k];
    atomicAdd(d_vz + v, o.dz[k]);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const long long v = base + (long long)o.vi[k] * Wv + o.vj[k];
    atomicAdd(d_vpx + v, o.dpx[k]);
    atomicAdd(d_vpy + v, o.dpy[k]);
  }
}

__global__ void geo_warp_bwd_first_kernel(
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ gz, const float* __restrict__ vpx,
    const float* __restrict__ vpy, const float* __restrict__ vz,
    const int* __restrict__ qi0, const int* __restrict__ qj0,
    const int8_t* __restrict__ tri, const float* __restrict__ uvx,
    const float* __restrict__ uvy, long long n, int h, int w, int Hv, int Wv,
    float* __restrict__ d_vpx, float* __restrict__ d_vpy,
    float* __restrict__ d_vz) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int win = tri[idx];
  const float g_x = gx[idx], g_y = gy[idx], g_z = gz[idx];
  if (win < 0 || (g_x == 0.0f && g_y == 0.0f && g_z == 0.0f)) return;
  const Sample s = sample_of(idx, h, w);
  const long long base = s.bd * Hv * Wv;
  const SampleGrad o = sample_grad(win, g_x, g_y, g_z, s.px, s.py, qi0[idx],
                                   qj0[idx], base, Hv, Wv, vpx, vpy, vz, uvx,
                                   uvy);
  add_atomic(o, base, Wv, d_vpx, d_vpy, d_vz);
}

// One corner slot of a warp's samples into the warp's window copy acc
// (3 x kWinCap): runs of lanes with equal vertices (loc; -1 adds
// nothing) summed by a segmented scan in lane order, then each run's
// last lane adds its sum, in rounds where a vertex has several runs.
__device__ __forceinline__ void add_slot(float* acc, int loc, float a,
                                         float b, float c, int lane) {
  const unsigned full = 0xffffffffu;
  const int prev = __shfl_up_sync(full, loc, 1);
  const unsigned heads = __ballot_sync(full, lane == 0 || loc != prev);
  const unsigned le = lane == 31 ? full : (2u << lane) - 1u;
  const int start = 31 - __clz(heads & le);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float ta = __shfl_up_sync(full, a, o);
    const float tb = __shfl_up_sync(full, b, o);
    const float tc = __shfl_up_sync(full, c, o);
    if (lane - o >= start) {
      a = __fadd_rn(a, ta);
      b = __fadd_rn(b, tb);
      c = __fadd_rn(c, tc);
    }
  }
  const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
  const int key = tail ? loc : -1;
  const unsigned peers = __match_any_sync(full, key);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  const int rounds = __reduce_max_sync(full, key >= 0 ? rank + 1 : 0);
  for (int round = 0; round < rounds; ++round) {
    if (key >= 0 && rank == round) {
      acc[key] = __fadd_rn(acc[key], a);
      acc[kWinCap + key] = __fadd_rn(acc[kWinCap + key], b);
      acc[2 * kWinCap + key] = __fadd_rn(acc[2 * kWinCap + key], c);
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kGeoThreads) geo_bwd_tile_kernel(
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ gz, const float* __restrict__ vpx,
    const float* __restrict__ vpy, const float* __restrict__ vz,
    const int* __restrict__ qi0, const int* __restrict__ qj0,
    const int8_t* __restrict__ tri, const float* __restrict__ uvx,
    const float* __restrict__ uvy, int h, int w, int Hv, int Wv,
    int tiles_y, int tiles_x, float* __restrict__ d_vpx,
    float* __restrict__ d_vpy, float* __restrict__ d_vz,
    int* __restrict__ hdr, float* __restrict__ part) {
  __shared__ float acc[kGeoWarps][3 * kWinCap];
  __shared__ int ext[kGeoWarps][4];
  __shared__ int cnt[kGeoWarps][2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long blk = blockIdx.x;
  const int per_plane = tiles_y * tiles_x;
  const long long plane = blk / per_plane;
  const int t = (int)(blk % per_plane);
  const int py0 = (t / tiles_x) * kGeoTileH + warp * kGeoRows;
  const int px = (t % tiles_x) * kGeoTileW + lane;
  const long long base = plane * Hv * Wv;
  const int4 win = geo_block_window(qi0, qj0, plane, py0, px, h, w, Hv, Wv,
                                    warp, lane, ext);
  const int r0 = win.x, c0 = win.y, nr = win.z, nc = win.w;
  const int nwin = nr * nc;
  float* wacc = acc[warp];
  for (int l = lane; l < nwin; l += 32) {
    wacc[l] = 0.0f;
    wacc[kWinCap + l] = 0.0f;
    wacc[2 * kWinCap + l] = 0.0f;
  }
  __syncwarp();
  int n_overflow = 0, n_live = 0;
  for (int r = 0; r < kGeoRows; ++r) {
    const int py = py0 + r;
    const bool inside = py < h && px < w;
    const long long idx = (plane * h + py) * w + px;
    const int code = inside ? (int)tri[idx] : -1;
    const float g_x = inside ? gx[idx] : 0.0f;
    const float g_y = inside ? gy[idx] : 0.0f;
    const float g_z = inside ? gz[idx] : 0.0f;
    const bool live =
        code >= 0 && !(g_x == 0.0f && g_y == 0.0f && g_z == 0.0f);
    int loc[3] = {-1, -1, -1};
    SampleGrad o;
    bool overflow = false;
    if (live) {
      o = sample_grad(code, g_x, g_y, g_z, px, py, qi0[idx], qj0[idx], base,
                      Hv, Wv, vpx, vpy, vz, uvx, uvy);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int li = o.vi[k] - r0, lj = o.vj[k] - c0;
        if ((unsigned)li < (unsigned)nr && (unsigned)lj < (unsigned)nc)
          loc[k] = li * nc + lj;
        else
          overflow = true;
      }
      if (overflow) {
        add_atomic(o, base, Wv, d_vpx, d_vpy, d_vz);
        loc[0] = loc[1] = loc[2] = -1;
      }
    }
    n_overflow += __popc(__ballot_sync(0xffffffffu, overflow));
    n_live += __popc(__ballot_sync(0xffffffffu, live));
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const bool in = loc[k] >= 0;
      add_slot(wacc, loc[k], in ? o.dpx[k] : 0.0f, in ? o.dpy[k] : 0.0f,
               in ? o.dz[k] : 0.0f, lane);
    }
  }
  if (lane == 0) {
    cnt[warp][0] = n_overflow;
    cnt[warp][1] = n_live;
  }
  __syncthreads();
  // the window's sums, warps in order
  float* out = part + blk * 3 * kWinCap;
  for (int e = threadIdx.x; e < 3 * nwin; e += kGeoThreads) {
    const int c = e / nwin, l = e - c * nwin;
    float sum = acc[0][c * kWinCap + l];
#pragma unroll
    for (int k = 1; k < kGeoWarps; ++k)
      sum = __fadd_rn(sum, acc[k][c * kWinCap + l]);
    out[c * kWinCap + l] = sum;
  }
  if (threadIdx.x < kHdrInts) {
    int v = 0;
    if (threadIdx.x < 4) {
      v = threadIdx.x == 0 ? r0 : threadIdx.x == 1 ? c0
          : threadIdx.x == 2 ? nr : nc;
    } else if (threadIdx.x < 6) {
      for (int k = 0; k < kGeoWarps; ++k) v += cnt[k][threadIdx.x - 4];
    }
    hdr[blk * kHdrInts + threadIdx.x] = v;
  }
}

// Each vertex of a plane adds the windows that hold it, in block order,
// to the output (zero, or the overflow route's atomics).  A block: 256
// vertices of one plane; it stages the plane's headers 256 at a time and
// skips those whose windows miss all of its vertices' rows.
__global__ void __launch_bounds__(256) geo_bwd_sum_kernel(
    const int* __restrict__ hdr, const float* __restrict__ part,
    int per_plane, int Hv, int Wv, float* __restrict__ d_vpx,
    float* __restrict__ d_vpy, float* __restrict__ d_vz) {
  __shared__ int4 sh[256];
  __shared__ int box[2];
  const long long plane = blockIdx.y;
  const int nv = Hv * Wv;
  const int v0 = (int)blockIdx.x * 256;
  const int v = v0 + (int)threadIdx.x;
  const bool ok = v < nv;
  const int vi = v / Wv, vj = v - (v / Wv) * Wv;
  const int vi_lo = v0 / Wv;
  const int vi_hi = min(v0 + 255, nv - 1) / Wv;
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
  for (int b0 = 0; b0 < per_plane; b0 += 256) {
    const int nb = min(256, per_plane - b0);
    __syncthreads();
    if (threadIdx.x < 2) box[threadIdx.x] = threadIdx.x == 0 ? 0x7fffffff : -1;
    __syncthreads();
    if ((int)threadIdx.x < nb) {
      const int4 hw = *reinterpret_cast<const int4*>(
          hdr + (plane * per_plane + b0 + threadIdx.x) * kHdrInts);
      sh[threadIdx.x] = hw;
      // headers whose rows meet this block's rows, first and last
      if (hw.z > 0 && hw.x <= vi_hi && hw.x + hw.z > vi_lo) {
        atomicMin(&box[0], (int)threadIdx.x);
        atomicMax(&box[1], (int)threadIdx.x);
      }
    }
    __syncthreads();
    const int first = box[0], last = box[1];
    if (ok) {
      for (int b = first; b <= last; ++b) {
        const int4 hw = sh[b];
        const int li = vi - hw.x, lj = vj - hw.y;
        if ((unsigned)li < (unsigned)hw.z && (unsigned)lj < (unsigned)hw.w) {
          const float* p = part + (plane * per_plane + b0 + b) * 3 * kWinCap
              + li * hw.w + lj;
          s0 = __fadd_rn(s0, p[0]);
          s1 = __fadd_rn(s1, p[kWinCap]);
          s2 = __fadd_rn(s2, p[2 * kWinCap]);
        }
      }
    }
  }
  if (ok) {
    const long long o = plane * nv + v;
    d_vpx[o] = __fadd_rn(d_vpx[o], s0);
    d_vpy[o] = __fadd_rn(d_vpy[o], s1);
    d_vz[o] = __fadd_rn(d_vz[o], s2);
  }
}

}  // namespace

// K20's first design (one thread a sample), kept for comparison.
VL3D_API int vl3d_geo_warp_fwd_first(const float* vpx, const float* vpy,
                                     const float* vz, const int* qi0,
                                     const int* qj0, const float* uvx,
                                     const float* uvy, int B, int D, int h,
                                     int w, int Hv, int Wv, float x_max,
                                     float y_max, float* x, float* y,
                                     float* z, uint8_t* valid, int8_t* tri,
                                     void* stream) {
  const long long n = (long long)B * D * h * w;
  if (n > 0) {
    geo_warp_fwd_first_kernel<<<grid_for(n), kBlock, 0,
                                (cudaStream_t)stream>>>(
        vpx, vpy, vz, qi0, qj0, uvx, uvy, n, h, w, Hv, Wv, x_max, y_max, x, y,
        z, valid, tri);
  }
  return (int)cudaGetLastError();
}

// K21's first design (9 global atomics a sample), kept for comparison.
// d_vpx, d_vpy, d_vz must be zero-filled by the caller.
VL3D_API int vl3d_geo_warp_bwd_first(const float* gx, const float* gy,
                                     const float* gz, const float* vpx,
                                     const float* vpy, const float* vz,
                                     const int* qi0, const int* qj0,
                                     const int8_t* tri, const float* uvx,
                                     const float* uvy, int B, int D, int h,
                                     int w, int Hv, int Wv, float* d_vpx,
                                     float* d_vpy, float* d_vz,
                                     void* stream) {
  const long long n = (long long)B * D * h * w;
  if (n > 0) {
    geo_warp_bwd_first_kernel<<<grid_for(n), kBlock, 0,
                                (cudaStream_t)stream>>>(
        gx, gy, gz, vpx, vpy, vz, qi0, qj0, tri, uvx, uvy, n, h, w, Hv, Wv,
        d_vpx, d_vpy, d_vz);
  }
  return (int)cudaGetLastError();
}

// K20's and K21's plan for (B, D, h, w) samples on (Hv, Wv) vertex grids:
// out[0..9] = tile rows, tile columns, tiles down, tiles across, blocks,
// window capacity, window columns at most, header ints a block, K21's
// scratch f32 (3 windows a block), vertices a block of K21's second pass.
VL3D_API int vl3d_geo_bwd_layout(int B, int D, int h, int w, int Hv, int Wv,
                                 long long* out) {
  const long long ty = (h + kGeoTileH - 1) / kGeoTileH;
  const long long tx = (w + kGeoTileW - 1) / kGeoTileW;
  const long long blocks = (long long)B * D * ty * tx;
  const long long vals[10] = {kGeoTileH, kGeoTileW, ty, tx, blocks,
                              kWinCap, kWinMaxC, kHdrInts,
                              blocks * 3 * kWinCap, 256};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
  return (Hv < 2 || Wv < 2 || blocks >= 0x7fffffffLL
          || (long long)Hv * Wv * 256 >= 0x7fffffffLL || ty > 65535
          || (long long)B * D > 65535)
      ? (int)cudaErrorInvalidValue : 0;
}

// K20: hdr holds 8 ints a block of vl3d_geo_bwd_layout (window, samples
// of the global route, samples).
VL3D_API int vl3d_geo_warp_fwd(const float* vpx, const float* vpy,
                               const float* vz, const int* qi0,
                               const int* qj0, const float* uvx,
                               const float* uvy, int B, int D, int h, int w,
                               int Hv, int Wv, float x_max, float y_max,
                               float* x, float* y, float* z, uint8_t* valid,
                               int8_t* tri, int* hdr, void* stream) {
  long long lay[10];
  const int err = vl3d_geo_bwd_layout(B, D, h, w, Hv, Wv, lay);
  if (err != 0) return err;
  if (lay[4] <= 0) return 0;
  const dim3 grid((unsigned)lay[3], (unsigned)lay[2], (unsigned)(B * D));
  cudaStream_t s = (cudaStream_t)stream;
  geo_window_kernel<<<grid, kGeoThreads, 0, s>>>(qi0, qj0, h, w, Hv, Wv,
                                                 hdr);
  geo_fwd_tile_kernel<<<grid, kGeoThreads, 0, s>>>(
      vpx, vpy, vz, qi0, qj0, uvx, uvy, h, w, Hv, Wv, x_max, y_max, x, y, z,
      valid, tri, hdr);
  return (int)cudaGetLastError();
}

// K21: d_vpx, d_vpy, d_vz must be zero-filled by the caller; hdr holds 8
// ints and part 3 x 256 f32 a block of vl3d_geo_bwd_layout.
VL3D_API int vl3d_geo_warp_bwd(const float* gx, const float* gy,
                               const float* gz, const float* vpx,
                               const float* vpy, const float* vz,
                               const int* qi0, const int* qj0,
                               const int8_t* tri, const float* uvx,
                               const float* uvy, int B, int D, int h, int w,
                               int Hv, int Wv, int* hdr, float* part,
                               float* d_vpx, float* d_vpy, float* d_vz,
                               void* stream) {
  long long lay[10];
  int err = vl3d_geo_bwd_layout(B, D, h, w, Hv, Wv, lay);
  if (err != 0) return err;
  const long long blocks = lay[4];
  if (blocks <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  geo_bwd_tile_kernel<<<(unsigned int)blocks, kGeoThreads, 0, s>>>(
      gx, gy, gz, vpx, vpy, vz, qi0, qj0, tri, uvx, uvy, h, w, Hv, Wv,
      (int)lay[2], (int)lay[3], d_vpx, d_vpy, d_vz, hdr, part);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const dim3 g2((unsigned)((Hv * Wv + 255) / 256), (unsigned)(B * D));
  geo_bwd_sum_kernel<<<g2, 256, 0, s>>>(hdr, part, (int)(lay[2] * lay[3]),
                                        Hv, Wv, d_vpx, d_vpy, d_vz);
  return (int)cudaGetLastError();
}
