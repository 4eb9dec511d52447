// Copyright (c) 2026
// MIT License
//
// Kernels K1 and K2: the planar fused sweep on Hopper.  K1 is the horizon
// mode, with and without the argmax output of the gradient path, and with
// its two optional variants, the mask and the tilt ramp; K2 is the shadow
// mode (sun-track occlusion metric).
//
// K1 replaces horayzon_tpu/ops/pallas_sweep.py::_kernel (mode="horizon"),
// launched there by pallas_forward_fn.  For every (inner cell, azimuth) it
// keeps the running maximum of the elevation-angle ratio (h(s) - z_org) / s
// over the reference's sample schedule:
//   * d2 near-field steps: midpoint + endpoint bilinear reads and the exact
//     interior maximum of the parabola through them;
//   * d1 mid-field steps in pairs: one read per step, trailing parabola per
//     pair, a trailing single step for an odd count;
//   * mip phases: nearest reads of the max-mip levels.
// Steps whose reads may leave the heightfield for some cell (past n_safe)
// carry in-domain validity, exactly as the reference does.  The raw ratio is
// written as (A, in0, in1) float32; arctan and clip run outside.
//
// K2 replaces the same body in mode="shadow", launched by shadow_forward_fn
// (pallas_sweep.py:2794-2894; entry shadow_metric_pallas, :2730).  For every
// (inner cell, sun) it keeps the running maximum of the clearance
// h(s) - z_org - s * m over the same schedule (the rays run to the domain
// diagonal): the cell's ray slope m comes from the sun table
// (pallas_sweep.py:352-380), a point sample gives (h - z_org) - s * m and a
// parabola its vertex value where the segment is concave and the vertex lies
// inside the window (:426-453, :487-489).  A positive metric means the cell
// is terrain-occluded; the metric (T, in0, in1) is written as it is.  K2
// takes the reference's shadow-mode skips, decided per warp (below): with
// params->sign_exact zero the value-exact ones, so it computes what the
// reference computes with exact_metric=True; with it set (never in the
// argmax variant) also the sign-exact arm of exact_metric=False, whose
// metric keeps its sign and never exceeds the exact one.
//
// K1's two variants (pallas_sweep.py:196-229, launched through
// pallas_forward_fn :1469-1496) are nullable pointers of HzParams, so the
// branches are uniform across a launch and the four instantiations stay
// four:
//   * the tilt ramp (ramp_a, ramp_b: (in0, in1) float32; the curved
//     gridded horizon): after the argmax emit the raw ratio becomes
//     (acc + ux * A[cell]) + uy * B[cell] with ux, uy the host table's
//     (sin, cos) of the azimuth (:1015-1016); winner ids and D do not see it;
//   * the mask (mask: (in0, in1) uint8, nonzero = swept; blocks: n_blocks
//     (block row, block column) pairs of 32 x 8 cells).  The launch covers
//     the compacted list of blocks that hold an unmasked cell, the
//     reference's compacted tile map (tile_schedule, :1130-1148) at this
//     kernel's block.  A masked cell's thread writes what the reference's
//     mask-aware init (+3e38, :627-638) leaves there, the raw value 3e38
//     and, in the argmax variant, ID_NONE with D = 1 / 1; its sweep, if its
//     warp runs one, only votes in the skips.  Blocks that are not launched
//     hold the same values, written by the wrapper before the launch.
//     Unmasked cells compute exactly what the unmasked kernel computes: the
//     skips are value-exact.  K2-mask (shadow_metric_pallas(mask=...),
//     :2730-2791) passes the block list with a null mask: shadow mode has
//     no mask-aware init, so every cell of a launched block sweeps as in
//     the dense launch, its warp taking the same skips, and the wrapper
//     fills the blocks it does not launch with -3e38.
//
// The shard variants (pallas_forward_fn's and shadow_forward_fn's
// shard_off, pallas_sweep.py:171-180, launched per shard by
// horayzon_tpu/parallel/shard.py) are the same entries with a shard's
// parameters: a shard sweeps its own rows (and, in K1, its own azimuths) of
// the whole run, value for value.  Its global offsets enter as off0 / off1,
// the global outer row and column of its first cell (the meshes shard rows
// only, so off1 is the run's), so
// every cell coordinate (reads, in-domain tests, K2's lattice position) is
// global; its first azimuth enters as the trig pointer, which points at
// that azimuth's row of the whole run's table; the dense-step split (ns2,
// nx, ns1, n_dense) is the whole run's (fused_sweep.shard_plan), so n_safe
// holds for every shard.  A level may be a window of the full padded level
// (memory-scalable multires): lvl_row0[l] is the padded row at which its
// buffer starts, every row index into level l and its pooled companion is
// taken relative to it, and the pooled companion is the window's rows of
// the full level's (lvl_row0 a multiple of 8), so the skips decide as in
// the single launch.
//
// Four entry points, one template <ARGMAX, SHADOW>: horizon_sweep_launch
// (K1), horizon_sweep_argmax_launch (the forward of the gradient path, the
// reference's emit_argmax=True), shadow_sweep_launch (K2) and
// shadow_sweep_argmax_launch (K2-argmax, the forward of the shadow
// gradient path).  The modes
// share the loop sections, read0, inside0 and the mip index arithmetic, as
// the reference's one body serves both; they differ in the per-cell set-up
// and the two update functions.  The argmax variant replaces fmaxf by a
// strict `cand > acc` update in the reference's candidate order, so the
// running value is bit-equal to the plain variant's and the first of equal
// candidates wins; it also writes the winner's id (A, in0, in1) int32 and the
// stationary denominator D of a parabola winner (A, in0, in1) float32, which
// the replay backward (csrc/horizon_replay_bwd.cu) needs.  In the shadow
// mode D = s_start + t* of the vertex t* = -(b - m) / (2a), carried as the
// pair (2 a s_start - (b - m), 2 a) and divided at emit, as the reference
// does (pallas_sweep.py:440-453).
//
// Design: one thread per (cell, azimuth or sun); a block is 32 x 8 cells of
// one azimuth or sun, the grid (column blocks, row blocks, azimuths or
// suns), or with a mask (live blocks, 1, azimuths).  A warp is therefore 32
// consecutive columns of one row under one azimuth: for a given (azimuth,
// step) the sample shift is the same for all of them (K2's shifts are per
// sun), so the warp reads consecutive floats and every row index it forms is
// the same in all lanes.  The padded levels are read straight from global
// memory through L2 with __ldg (at the 2048^2 bench grid the three levels
// take about 38 MB, inside the 50 MB L2).
//
// What bounds it: instruction issue, not L2 or load latency (the read
// floor, csrc/read_floor.cu, runs the same reads no faster from shared
// memory or aligned).  So the design cuts instructions per sample and the
// samples themselves:
//   * a per-launch step table (s, 1/s) of every sample distance, in the
//     schedule's order, built on the host in float32 exactly as the loop
//     forms the distances (fused_sweep.step_table) and staged in shared
//     memory: a point candidate is (h - z_org) * inv_s with inv_s the
//     correctly rounded reciprocal the reference multiplies by, read with a
//     broadcast load in place of an IEEE divide per candidate;
//   * mip indices by an arithmetic shift, (a + round(s*sh)) >> lvl: a
//     floor division, bit-identical to the reference's biased truncating
//     division wherever that one is a floor;
//   * 32-bit offsets from per-level base pointers (the host refuses a level
//     of 2^31 elements or more);
//   * the reference's value-exact skips, decided per warp.  The
//     safe d1 pairs run in chunks of 16 pairs (32 samples) and the mip
//     phases in chunks of 32 samples, with one check per phase before its
//     chunks.  For a chunk each lane takes one sample (a phase: every 32nd)
//     and forms the exact level cells the warp's 32 cells read there: one
//     row (two for a bilinear read) and a run of columns.  It takes the
//     maximum D of the 8 x 8 pooled companion (fused_sweep.pool8) over them,
//     the warp reduces D with __shfl_xor_sync, and each lane bounds its own
//     candidates: mip (D - z_org) * inv_s at the chunk's first or, for a
//     negative numerator, last reciprocal, which float rounding cannot
//     exceed (it is monotone); d1 the parabola's overshoot
//     D + 0.125 (D - lo) with lo the minimum of the same cells' in-domain
//     heights (mip.pool8_floor: the pairs that may skip read in-domain
//     stencils only), over the distance of the sample before the
//     chunk, plus a slack for the rounding of the parabola's stationary
//     value.  The warp skips when
//     every lane's bound is at most its running value (__all_sync); the
//     update is strict, so no skipped candidate could have changed a value,
//     a winner id or D.  A skipped d1 chunk re-reads its last sample into h1
//     at the distance the loop forms (the table's), so skipping never moves
//     a value.  Lanes with no swept cell (masked, or past in1) run on a
//     clamped cell with a running value of +3e38 and always vote to skip;
//     a warp without a swept cell returns at once.
//   * K2's skips (d1_skip_shadow, mip_skip_shadow) take the same chunks and
//     boxes; each lane bounds the clearance (h - z_org) - s m of its
//     candidates with its own origin and slope, the mip bound needs no
//     slack and the d1 bound a slack derived at d1_skip_shadow.  K2 also
//     chunks the masked d1 pairs past n_safe: a skipped masked chunk
//     re-reads h1 and re-forms its validity v1 as the pair would.  The
//     sign-exact arm adds, per lane, bound <= 0 (no candidate of the chunk
//     can make the metric positive) or acc > 0 (it is positive already);
//     each arm keeps the sign of metric > 0, so their OR does.
//
// With params->counters set, each warp adds the (cell, row) samples it took
// and skipped in the d1 pairs (K1: the safe ones; K2: safe and masked) and
// in the mip phases (four unsigned 64-bit counters); null on every library
// path.
//
// Numerics follow the reference operation by operation so results agree
// bit for bit with the plain version: build with --fmad=false (no
// contraction of a*b+c) and never with --use_fast_math.  Trig comes from the
// host float32 table; there is no sinf/cosf here, because a 1-ulp shift
// across a rounding boundary of a mip index reads a neighbouring max-pooled
// block.  For the same reason K2 takes its shifts from columns 5-6 of the
// sun table (ky_u/dy and kx_u/dx formed in double on the host), not from a
// division in the kernel, and its vertex-window constants 2(t_lo + 1e-3) and
// 2(length - 1e-3) come rounded from double, as JAX rounds the reference's
// Python floats.

#include <cuda_runtime.h>

#define HZ_MAX_LEVELS 32

// Must match horayzon_tpu_torch/ops/fused_sweep.py::_HzParams field by field.
struct HzParams {
  const float* z_org;    // (in0, in1) ray origin heights
  const float* z_inner;  // (in0, in1) inner-domain heights
  const float* trig;     // (a_num, 2) float32 (sin az, cos az) (K1)
  const float* sun;      // (a_num, 8) sun table (K2): sun_x, sun_y, sun_z,
                         // kx_u, ky_u, sh_i, sh_j, 0
  float* out;            // (a_num, in0, in1) raw ratios
  int* ids;              // (a_num, in0, in1) winner ids (argmax variant)
  float* aux;            // (a_num, in0, in1) winner's D (argmax variant)
  const float* lvl[HZ_MAX_LEVELS];  // padded pyramid levels, row-major
  int lvl_w[HZ_MAX_LEVELS];         // row stride of each padded level
  int lvl_pad[HZ_MAX_LEVELS];       // sentinel margin of each level
  int ph_lvl[HZ_MAX_LEVELS];        // mip phase p >= 1: its pyramid level
  int ph_n[HZ_MAX_LEVELS];          // mip phase p >= 1: sample count
  float ph_s_first[HZ_MAX_LEVELS];  // mip phase p >= 1: first distance
  float ph_step[HZ_MAX_LEVELS];     // mip phase p >= 1: distance step
  int n_phases;                     // 1 dense phase + mip phases
  int in0, in1, a_num;
  int off0, off1, h, w;             // inner offset, outer shape
  int ns2, nx, ns1, n_dense;        // dense-step split (see fused_sweep.py)
  float dx, dy, step, dist;
  float half_step, two_step;        // float32(0.5*step), float32(2*step)
  float inv_l0, inv_l0_sq, inv_l1, inv_l1_sq;  // rounded from double
  float s_m1_safe, s_m1_masked;     // h2 re-read distances
  float x0, y0;                     // grid origin (K2)
  float lo2_0, lo2_step;            // K2: float32(2 (t_lo + 1e-3))
  float hi2_step, hi2_two_step;     // K2: float32(2 (length - 1e-3))
  const float* ramp_a;              // (in0, in1) tilt ramp A, or null (K1)
  const float* ramp_b;              // (in0, in1) tilt ramp B, or null (K1)
  const unsigned char* mask;        // (in0, in1) nonzero = swept, or null
  const int* blocks;                // (n_blocks, 2) live blocks, or null
  int n_blocks;
  // Appended for the redesign (fields are only ever appended).
  const float2* steps;              // (n_steps) (s, 1/s): dense steps, then
                                    // the mip phases' samples in order
  const float* pool[HZ_MAX_LEVELS];  // 8x8 max-pool of each padded level,
                                     // or null: no skips
  int pool_w[HZ_MAX_LEVELS];        // row stride of each pooled level
  const float* pool_min0;           // 8x8 min-pool of the in-domain cells
                                    // of padded level 0 (mip.pool8_floor)
  unsigned long long* counters;     // 4 sample counters, or null
  int n_steps;
  int sign_exact;                   // K2: the sign-exact arm of the skips
  // Appended for the shard variants: the padded row of the full level at
  // which each level's buffer starts (0 for a whole level; a multiple of 8,
  // so that the pooled companion's rows start at lvl_row0 / 8).
  int lvl_row0[HZ_MAX_LEVELS];
};

namespace {

constexpr float kNegInit = -3.0e38f;
// The masked cells' running value (_POS_INIT, pallas_sweep.py:40).
constexpr float kPosInit = 3.0e38f;
// Block of the launch: 32 columns x 8 rows of one azimuth or sun
// (fused_sweep.BLOCK_COLS, BLOCK_ROWS).
constexpr int kBlockCols = 32;
constexpr int kBlockRows = 8;
// No-winner id (pallas_sweep.py:44): larger than every candidate id.
constexpr int kIdNone = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
// Skip grain: d1 pairs per chunk (32 samples) and mip samples per chunk,
// one sample a lane (fused_sweep.D1_CHUNK_PAIRS, MIP_CHUNK).
constexpr int kD1ChunkPairs = 16;
constexpr int kMipChunk = 32;
// Slack of the d1 bound (fused_sweep._D1_SLACK, _D1_REL): 2^-18 of the
// parabola's term magnitudes and 2^-20 of the pooled maximum.
constexpr float kD1Slack = 3.814697265625e-06f;
constexpr float kD1Rel = 9.5367431640625e-07f;
// Counter slots: safe d1 samples taken, skipped; mip samples taken, skipped.
enum { kD1Taken = 0, kD1Skipped = 1, kMipTaken = 2, kMipSkipped = 3 };

// Running value of one (cell, azimuth).  The plain variant keeps the
// maximum.  The argmax variant (pallas_sweep.py:481-496, 632-638) also keeps
// the winner's id and, for a parabola winner, its (g, a) pair: D = g / a is
// divided once at emit time, as the reference defers it.
template <bool ARGMAX>
struct Acc;

template <>
struct Acc<false> {
  float v = kNegInit;
  __device__ __forceinline__ void point(float cand, int) {
    v = fmaxf(v, cand);
  }
  __device__ __forceinline__ void quad(bool ok, float cand, int, float,
                                       float) {
    if (ok) v = fmaxf(v, cand);
  }
};

template <>
struct Acc<true> {
  float v = kNegInit;
  int id = kIdNone;
  float n = 1.0f, d = 1.0f;
  __device__ __forceinline__ void point(float cand, int cid) {
    if (cand > v) {
      v = cand;
      id = cid;
    }
  }
  __device__ __forceinline__ void quad(bool ok, float cand, int cid, float g,
                                       float a) {
    if (ok && cand > v) {
      v = cand;
      id = cid;
      n = g;
      d = a;
    }
  }
};

struct Cell {
  const float* l0;  // level 0 at (a + pad0, b + pad0)
  int w0;
  int a, b, h, w;   // outer row/col of the cell, outer shape
  float sh_i, sh_j;
  float z_org;
  float m;          // ray slope toward the sun (K2)
};

// What the skips need of the warp: the outer columns of its first and last
// cell, whether this lane holds no swept cell, the lane, the step table,
// the lowest ray origin of its cells and (K2) their lowest ray slope.
struct Warp {
  int b0, b1;
  bool dead;
  int lane;
  const float2* tab;
  float z_min;
  float m_min;
};

// Bilinear level-0 read at distance s (pallas_sweep.py:388-402).
__device__ __forceinline__ float read0(const Cell& c, float s, int* di_out,
                                       int* dj_out) {
  const float dif = s * c.sh_i;
  const float djf = s * c.sh_j;
  const float di = floorf(dif);
  const float dj = floorf(djf);
  const float fi = dif - di;
  const float fj = djf - dj;
  const int idi = (int)di;
  const int idj = (int)dj;
  const float* p = c.l0 + (idi * c.w0 + idj);
  const float v00 = __ldg(p);
  const float v01 = __ldg(p + 1);
  const float v10 = __ldg(p + c.w0);
  const float v11 = __ldg(p + c.w0 + 1);
  const float top = (1.0f - fj) * v00 + fj * v01;
  const float bot = (1.0f - fj) * v10 + fj * v11;
  *di_out = idi;
  *dj_out = idj;
  return (1.0f - fi) * top + fi * bot;
}

// The 2x2 stencil of a bilinear read lies inside the outer grid
// (pallas_sweep.py:337-340).
__device__ __forceinline__ bool inside0(const Cell& c, int di, int dj) {
  const int ri = c.a + di;
  const int cj = c.b + dj;
  return (ri >= 0) & (ri + 1 <= c.h - 1) & (cj >= 0) & (cj + 1 <= c.w - 1);
}

// Point candidate at the table entry e = (s, 1/s): K1 the ratio
// (h - z_org) * (1/s), K2 the clearance (h - z_org) - s * m
// (pallas_sweep.py:486-490).
template <bool A, bool S>
__device__ __forceinline__ void point_update(const Cell& c, Acc<A>& acc,
                                             float he, float2 e, int cid) {
  if constexpr (S) {
    acc.point((he - c.z_org) - e.x * c.m, cid);
  } else {
    acc.point((he - c.z_org) * e.y, cid);
  }
}

// The window of a parabola: K1 takes (length, t_lo), K2 the constants
// 2 (t_lo + 1e-3) and 2 (length - 1e-3) (see HzParams).
struct Win {
  float length, t_lo, lo2, hi2;
};

// Parabola candidate.  K1: the interior stationary value of
// (P(t) + C) / (s + t), division-free form (pallas_sweep.py:455-472).  K2:
// the vertex value C0 - (b - m)^2 / (4 a) of P(t) - m t, C0 = h0 - z_org -
// s m, where the segment is concave and the vertex lies in the window
// (pallas_sweep.py:426-437).
template <bool A, bool S>
__device__ __forceinline__ void quad_update(const Cell& c, Acc<A>& acc,
                                            float a_c, float b_c, float h0,
                                            float s_start, const Win& win,
                                            bool extra, int cid) {
  if constexpr (S) {
    const bool concave = a_c < -1e-12f;
    const float a_s = concave ? a_c : -1e-12f;
    const float d = b_c - c.m;
    const float lo2a = win.lo2 * a_c;
    const float hi2a = win.hi2 * a_c;
    const bool valid = concave && ((d + lo2a) * (d + hi2a) < 0.0f);
    const float r_int =
        ((h0 - c.z_org) - s_start * c.m) - ((0.25f * d) * d) / a_s;
    // the argmax pair of D = s_start + t*, t* = -d / (2 a)
    // (pallas_sweep.py:448-453); unused by the plain accumulator
    acc.quad(valid && extra, r_int, cid, (2.0f * a_s) * s_start - d,
             2.0f * a_s);
  } else {
    const float c0 = h0 - c.z_org;
    const float u = (a_c * s_start - b_c) * s_start + c0;
    float g = sqrtf(fmaxf(a_c * u, 0.0f));
    g = (a_c >= 0.0f) ? g : -g;
    const float r_int = (b_c - 2.0f * a_c * s_start) + 2.0f * g;
    const float lo = (s_start + win.t_lo) + 1e-3f;
    const float hi = (s_start + win.length) - 1e-3f;
    const bool valid = (u - a_c * (lo * lo)) * (u - a_c * (hi * hi)) < 0.0f;
    acc.quad(valid && extra, r_int, cid, g, a_c);
  }
}

template <bool A>
struct Carry {
  Acc<A> acc;
  float h2, h1;
  bool v2, v1;
};

// d2 step m: midpoint + endpoint reads (pallas_sweep.py:558-573); ids 2m
// (point) and 2m+1 (parabola).  Distances from the step table.
template <bool A, bool S>
__device__ __forceinline__ void d2_step(const HzParams& p, const Cell& c,
                                        const float2* tab, Carry<A>& k, int m,
                                        bool masked) {
  const float2 e = tab[m];
  const float s_start = e.x - p.step;
  int dim, djm, die, dje;
  const float hm = read0(c, e.x - p.half_step, &dim, &djm);
  const float he = read0(c, e.x, &die, &dje);
  point_update<A, S>(c, k.acc, he, e, 2 * m);
  const float a_c = (2.0f * he + 2.0f * k.h1 - 4.0f * hm) * p.inv_l0_sq;
  const float b_c = (4.0f * hm - 3.0f * k.h1 - he) * p.inv_l0;
  bool v_end = true;
  bool extra = true;
  if (masked) {
    v_end = inside0(c, die, dje);
    extra = inside0(c, dim, djm) && v_end;
  }
  quad_update<A, S>(c, k.acc, a_c, b_c, k.h1, s_start,
                    Win{p.step, 0.0f, p.lo2_0, p.hi2_step}, extra, 2 * m + 1);
  k.h2 = k.h1;
  k.h1 = he;
  if (masked) {
    k.v2 = k.v1;
    k.v1 = v_end;
  }
}

// d1 pair of steps m and m+1 (distances s_a and s_a + step, as the table
// holds them); carries only (acc, h1[, v1]) like the reference loop
// (pallas_sweep.py:586-608).  Ids 2m and 2(m+1) (points), 2(m+1)+1
// (parabola).
template <bool A, bool S>
__device__ __forceinline__ void d1_pair(const HzParams& p, const Cell& c,
                                        const float2* tab, Carry<A>& k, int m,
                                        bool masked) {
  const float2 ea = tab[m];
  const float2 eb = tab[m + 1];
  int dia, dja, dib, djb;
  const float h_a = read0(c, ea.x, &dia, &dja);
  point_update<A, S>(c, k.acc, h_a, ea, 2 * m);
  const float h_b = read0(c, eb.x, &dib, &djb);
  point_update<A, S>(c, k.acc, h_b, eb, 2 * (m + 1));
  const float a_c = (2.0f * h_b + 2.0f * k.h1 - 4.0f * h_a) * p.inv_l1_sq;
  const float b_c = (4.0f * h_a - 3.0f * k.h1 - h_b) * p.inv_l1;
  bool extra = true;
  bool v_b = true;
  if (masked) {
    v_b = inside0(c, dib, djb);
    extra = k.v1 && inside0(c, dia, dja) && v_b;
  }
  quad_update<A, S>(c, k.acc, a_c, b_c, k.h1, eb.x - p.two_step,
                    Win{p.two_step, 0.0f, p.lo2_0, p.hi2_two_step}, extra,
                    2 * (m + 1) + 1);
  k.h1 = h_b;
  if (masked) k.v1 = v_b;
}

// Trailing odd d1 step from the carried h2/h1 history
// (pallas_sweep.py:610-625); ids 2m (point) and 2m+1 (parabola).
template <bool A, bool S>
__device__ __forceinline__ void d1_single(const HzParams& p, const Cell& c,
                                          const float2* tab, Carry<A>& k,
                                          int m, bool masked) {
  const float2 e = tab[m];
  int die, dje;
  const float he = read0(c, e.x, &die, &dje);
  point_update<A, S>(c, k.acc, he, e, 2 * m);
  const float a_c = (2.0f * he + 2.0f * k.h2 - 4.0f * k.h1) * p.inv_l1_sq;
  const float b_c = (4.0f * k.h1 - 3.0f * k.h2 - he) * p.inv_l1;
  bool extra = true;
  if (masked) extra = k.v2 && k.v1 && inside0(c, die, dje);
  quad_update<A, S>(c, k.acc, a_c, b_c, k.h2, e.x - p.two_step,
                    Win{p.two_step, p.step, p.lo2_step, p.hi2_two_step},
                    extra, 2 * m + 1);
  k.h2 = k.h1;
  k.h1 = he;
}

// Maximum of the pooled level (stride pw) over the pooled cells that hold
// padded-level rows [r0, r1] and columns [q0, q1]; with Q (the min-pooled
// level of the same layout) also their minimum, into *lo.
__device__ __forceinline__ float pooled_max(const float* P, int pw, int r0,
                                            int r1, int q0, int q1,
                                            const float* Q = nullptr,
                                            float* lo = nullptr) {
  float d = kNegInit;
  for (int pr = r0 >> 3; pr <= (r1 >> 3); ++pr) {
    for (int pq = q0 >> 3; pq <= (q1 >> 3); ++pq) {
      d = fmaxf(d, __ldg(P + (pr * pw + pq)));
      if (Q != nullptr) *lo = fminf(*lo, __ldg(Q + (pr * pw + pq)));
    }
  }
  return d;
}

__device__ __forceinline__ float warp_max(float d) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    d = fmaxf(d, __shfl_xor_sync(kFull, d, off));
  }
  return d;
}

__device__ __forceinline__ float warp_min(float d) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    d = fminf(d, __shfl_xor_sync(kFull, d, off));
  }
  return d;
}

// Skip test of the safe d1 pairs whose samples are table entries
// [mA, mA + n_s) (n_s <= 32, mA >= 1): lane l forms the level-0 cells the
// warp's bilinear reads touch at sample mA + l, exactly as read0 forms them.
// The bound covers every point and parabola candidate of the chunk: heights
// lie in [lo, D], D the maximum and lo the minimum of the pooled cells (and
// the lane's own h1, the first parabola's left sample), a parabola through
// three of them overshoots by at most (D - lo) / 8 (pallas_sweep.py:698-718;
// the reference takes lo over its whole window), and the stationary ratio
// lies between the distance of sample mA - 1 and that of the last.  The
// slack covers the rounding of the stationary value, whose terms grow as
// (D - lo) (s / step)^2 / s, and of heights as large as |D|, |lo|, |z_org|.
template <bool A>
__device__ __forceinline__ bool d1_skip(const HzParams& p, const Cell& c,
                                        const Warp& wp, const Carry<A>& k,
                                        int mA, int n_s) {
  float d = kNegInit;
  float lo = kPosInit;
  if (wp.lane < n_s) {
    const float s = wp.tab[mA + wp.lane].x;
    const int di = (int)floorf(s * c.sh_i);
    const int dj = (int)floorf(s * c.sh_j);
    const int pad = p.lvl_pad[0];
    const int r = c.a + di + pad - p.lvl_row0[0];
    d = pooled_max(p.pool[0], p.pool_w[0], r, r + 1, wp.b0 + dj + pad,
                   wp.b1 + dj + 1 + pad, p.pool_min0, &lo);
  }
  d = fmaxf(warp_max(d), k.h1);
  const float lol = fminf(warp_min(lo), k.h1);
  const float dp = d + fabsf(d) * kD1Rel;
  const float x = (dp + 0.125f * (dp - lol)) - c.z_org;
  const float2 e_lo = wp.tab[mA - 1];
  const float2 e_hi = wp.tab[mA + n_s - 1];
  const float r = e_hi.x * p.inv_l0;
  const float slack = kD1Slack *
                      (((dp - lol) * r) * r + fabsf(dp) + fabsf(lol) +
                       fabsf(c.z_org)) *
                      e_lo.y;
  const float bound = x * (x >= 0.0f ? e_lo.y : e_hi.y) + slack;
  return __all_sync(kFull, wp.dead || bound <= k.acc.v);
}

// Skip test of the mip samples at table entries [t, t + n) of level lvl
// (sentinel margin pad, less the buffer's first row for the rows: rpad;
// pooled level P of row stride pw):
// lane l forms the cells of samples t + l, t + l + 32, ...: one level row
// and the run of columns of the warp's 32 cells.  A mip candidate is
// (h - z_org) * (1/s) with h <= D, which rounding keeps at or below
// (D - z_org) * (1/s) at the chunk's largest reciprocal (the first) or, for
// a negative numerator, its smallest (the last); and at or below
// (D_k - z_min) * (1/s_k) for its own sample k, D_k that sample's pooled
// maximum and z_min the warp's lowest origin.  The lane takes the smaller
// of the two bounds.
template <bool A>
__device__ __forceinline__ bool mip_skip(const Cell& c, const Warp& wp,
                                         const Carry<A>& k, const float* P,
                                         int pw, int lvl, int pad, int rpad,
                                         int t, int n) {
  float d = kNegInit;
  float b_k = kNegInit;
  for (int l = wp.lane; l < n; l += 32) {
    const float2 e = wp.tab[t + l];
    const int ri = __float2int_rn(e.x * c.sh_i);
    const int rj = __float2int_rn(e.x * c.sh_j);
    const int r = ((c.a + ri) >> lvl) + rpad;
    const float d_k = pooled_max(P, pw, r, r, ((wp.b0 + rj) >> lvl) + pad,
                                 ((wp.b1 + rj) >> lvl) + pad);
    d = fmaxf(d, d_k);
    b_k = fmaxf(b_k, (d_k - wp.z_min) * e.y);
  }
  d = warp_max(d);
  const float x = d - c.z_org;
  const float bound =
      fminf(x * (x >= 0.0f ? wp.tab[t].y : wp.tab[t + n - 1].y),
            warp_max(b_k));
  return __all_sync(kFull, wp.dead || bound <= k.acc.v);
}

// K2's vote on a chunk whose candidates this lane bounds by `bound`: the
// value-exact arm (bound <= acc) and, with `sign`, the sign-exact arm
// (bound <= 0: no candidate of the chunk is positive; acc > 0: the cell is
// occluded already), each of which keeps the sign of the metric.
__device__ __forceinline__ bool shadow_vote(const Warp& wp, float bound,
                                            float acc, bool sign) {
  bool yes = wp.dead || bound <= acc;
  if (sign) yes = yes || bound <= 0.0f || acc > 0.0f;
  return __all_sync(kFull, yes);
}

// K2's skip test of the d1 pairs at table entries [mA, mA + n_s) (n_s <=
// 32, mA >= 1), safe or (`masked`) past n_safe.  The warp's box of
// level-0 cells as d1_skip forms it: D its pooled maximum, lo the minimum
// of its in-domain cells (a valid parabola reads no sentinel), each with
// the lane's h1 when the chunk's first parabola may be valid (always for a
// safe chunk, else v1).  A point candidate (h - z_org) - s m with
// h <= dp = D (1 + 2^-20) (the bilinear read's rounding) and s in the
// chunk is at most (dp - z_org) - min(s_lo m, s_hi m), s_lo the distance
// of sample mA - 1 and s_hi that of the last, because every rounding is
// monotone.  A parabola candidate is the vertex value
// ((h0 - z_org) - s_start m) - (d d / 4) / a of the parabola P through
// three samples in [lo, dp], taken when its vertex t* = d / (2 |a|) lies in
// the window: in exact arithmetic it is P(t*) - z_org - m (s_start + t*),
// with P(t*) <= dp + (dp - lo) / 8 (the overshoot of a parabola through
// three equispaced samples) and s_start + t* in [s_lo, s_hi].  Its
// rounding, from the coefficients a_c, b_c (errors of a few ulp of the
// heights, over the window's length), from (h0 - z_org) - s_start m, and
// from d d / (4 a) (at most 4 (dp - lo) in size, since the vertex lies in
// the window), stays below 48 ulp of (dp - lo) + |dp| + |lo| + |z_org| +
// max |s m|; the slack takes 64 ulp (2^-18) of that sum.
template <bool A>
__device__ __forceinline__ bool d1_skip_shadow(const HzParams& p,
                                               const Cell& c, const Warp& wp,
                                               const Carry<A>& k, int mA,
                                               int n_s, bool masked,
                                               bool sign) {
  if (sign && __all_sync(kFull, wp.dead || k.acc.v > 0.0f)) return true;
  float d = kNegInit;
  float lo = kPosInit;
  if (wp.lane < n_s) {
    const float s = wp.tab[mA + wp.lane].x;
    const int di = (int)floorf(s * c.sh_i);
    const int dj = (int)floorf(s * c.sh_j);
    const int pad = p.lvl_pad[0];
    const int r = c.a + di + pad - p.lvl_row0[0];
    d = pooled_max(p.pool[0], p.pool_w[0], r, r + 1, wp.b0 + dj + pad,
                   wp.b1 + dj + 1 + pad, p.pool_min0, &lo);
  }
  d = warp_max(d);
  float lol = warp_min(lo);
  if (!masked || k.v1) {
    d = fmaxf(d, k.h1);
    lol = fminf(lol, k.h1);
  }
  const float dp = d + fabsf(d) * kD1Rel;
  const float lw = fminf(lol, dp);
  const float gap = dp - lw;
  const float hp = dp + 0.125f * gap;
  const float sm_lo = wp.tab[mA - 1].x * c.m;
  const float sm_hi = wp.tab[mA + n_s - 1].x * c.m;
  const float slack =
      ((((gap + fabsf(dp)) + fabsf(lw)) + fabsf(c.z_org)) +
       fmaxf(fabsf(sm_lo), fabsf(sm_hi))) *
      kD1Slack;
  const float bound = ((hp - c.z_org) - fminf(sm_lo, sm_hi)) + slack;
  return shadow_vote(wp, bound, k.acc.v, sign);
}

// K2's skip test of the mip samples at table entries [t, t + n) of level
// lvl, the cells formed as mip_skip forms them.  A mip candidate
// (h - z_org) - s m with h <= D is at most (D - z_org) - min(s_t m,
// s_{t+n-1} m) (monotone roundings, min for either sign of m: the
// reference's bound, pallas_sweep.py:960-967, 983-999, with the lane's own
// origin and slope); and at most (D_k - z_min) - s_k m_min for its own
// sample k, D_k that sample's pooled maximum, z_min and m_min the warp's
// lowest origin and slope.  The lane takes the smaller of the two bounds.
template <bool A>
__device__ __forceinline__ bool mip_skip_shadow(const Cell& c,
                                                const Warp& wp,
                                                const Carry<A>& k,
                                                const float* P, int pw,
                                                int lvl, int pad, int rpad,
                                                int t, int n, bool sign) {
  if (sign && __all_sync(kFull, wp.dead || k.acc.v > 0.0f)) return true;
  float d = kNegInit;
  float b_k = kNegInit;
  for (int l = wp.lane; l < n; l += 32) {
    const float s = wp.tab[t + l].x;
    const int ri = __float2int_rn(s * c.sh_i);
    const int rj = __float2int_rn(s * c.sh_j);
    const int r = ((c.a + ri) >> lvl) + rpad;
    const float d_k = pooled_max(P, pw, r, r, ((wp.b0 + rj) >> lvl) + pad,
                                 ((wp.b1 + rj) >> lvl) + pad);
    d = fmaxf(d, d_k);
    b_k = fmaxf(b_k, (d_k - wp.z_min) - s * wp.m_min);
  }
  d = warp_max(d);
  const float own =
      (d - c.z_org) - fminf(wp.tab[t].x * c.m, wp.tab[t + n - 1].x * c.m);
  return shadow_vote(wp, fminf(own, warp_max(b_k)), k.acc.v, sign);
}

// Five blocks of 256 threads per SM: the register cap (51) brings K2 from
// 60 registers to 48 without spills (about 2% faster on the hemisphere
// example's 181 suns on an H100), and K1 (40) is under it already.
template <bool ARGMAX, bool SHADOW>
__global__ void __launch_bounds__(kBlockCols * kBlockRows, 5)
horizon_sweep_kernel(const HzParams p) {
  // The step table, once per block, read by every thread with broadcast
  // loads.
  extern __shared__ float2 tab[];
  for (int t = threadIdx.y * kBlockCols + threadIdx.x; t < p.n_steps;
       t += kBlockCols * kBlockRows) {
    tab[t] = p.steps[t];
  }
  __syncthreads();

  // With a mask the grid's x runs over the compacted list of live blocks.
  int bi = blockIdx.y;
  int bj = blockIdx.x;
  if (p.blocks != nullptr) {
    bi = p.blocks[2 * blockIdx.x];
    bj = p.blocks[2 * blockIdx.x + 1];
  }
  const int i = bi * kBlockRows + threadIdx.y;
  const int az = blockIdx.z;
  // A warp is one row of the block: the whole warp leaves together.
  if (i >= p.in0) return;
  const int j = bj * kBlockCols + threadIdx.x;
  const bool in_cols = j < p.in1;
  const int cell = i * p.in1 + (in_cols ? j : p.in1 - 1);
  const long long o = (long long)az * p.in0 * p.in1 + cell;
  const bool masked = p.mask != nullptr && p.mask[cell] == 0;
  if (masked && in_cols) {
    p.out[o] = kPosInit;
    if constexpr (ARGMAX) {
      p.ids[o] = kIdNone;
      p.aux[o] = 1.0f;
    }
  }
  Warp wp;
  wp.dead = masked || !in_cols;
  if (__all_sync(kFull, wp.dead)) return;
  wp.lane = threadIdx.x;
  wp.tab = tab;
  wp.b0 = p.off1 + bj * kBlockCols;
  wp.b1 = p.off1 + min(bj * kBlockCols + kBlockCols - 1, p.in1 - 1);

  Cell c;
  c.a = p.off0 + i;
  c.b = p.off1 + (in_cols ? j : p.in1 - 1);
  c.h = p.h;
  c.w = p.w;
  c.w0 = p.lvl_w[0];
  c.l0 = p.lvl[0] + ((c.a + p.lvl_pad[0] - p.lvl_row0[0]) * c.w0 +
                     (c.b + p.lvl_pad[0]));
  c.z_org = p.z_org[cell];
  wp.z_min = warp_min(c.z_org);
  const float zi = p.z_inner[cell];
  c.m = 0.0f;
  wp.m_min = 0.0f;
  if constexpr (SHADOW) {
    // Per-cell ray slope toward sun `az` (pallas_sweep.py:352-374): the
    // lattice coordinates of the cell's global outer row and column.
    const float* sun = p.sun + 8 * az;
    const float xr = (float)c.b * p.dx + p.x0;
    const float yr = (float)c.a * p.dy + p.y0;
    const float sxr = sun[0] - xr;
    const float syr = sun[1] - yr;
    const float szr = sun[2] - c.z_org;
    const float mag = sqrtf(sxr * sxr + syr * syr + szr * szr);
    const float adv = (sxr * sun[3] + syr * sun[4]) / mag;
    c.m = (szr / mag) / fmaxf(adv, 1.0e-4f);
    c.sh_i = sun[5];  // row cells per metre
    c.sh_j = sun[6];
    wp.m_min = warp_min(c.m);
  } else {
    const float ux = p.trig[2 * az];
    const float uy = p.trig[2 * az + 1];
    c.sh_i = uy / p.dy;  // row cells per metre
    c.sh_j = ux / p.dx;
  }

  // A lane without a swept cell starts at the masked init: it never
  // updates and always votes to skip.
  Carry<ARGMAX> k{Acc<ARGMAX>{}, zi, zi, true, true};
  if (wp.dead) k.acc.v = kPosInit;
  constexpr bool A = ARGMAX;
  constexpr bool S = SHADOW;
  // Skips with the pooled companions, and K2's sign-exact arm (uniform
  // across the launch).
  const bool skips = p.pool[0] != nullptr;
  const bool sign = SHADOW && !ARGMAX && p.sign_exact != 0;
  unsigned cnt[4] = {0u, 0u, 0u, 0u};

  // Dense steps, in the reference's sections (pallas_sweep.py:641-757).
  for (int m = 0; m < p.ns2; ++m) d2_step<A, S>(p, c, tab, k, m, false);
  for (int m = p.ns2; m < p.nx; ++m) d2_step<A, S>(p, c, tab, k, m, true);
  if (p.ns1 > p.nx) {
    const int n_pairs = (p.ns1 - p.nx) / 2;
    const bool odd = (p.ns1 - p.nx) % 2;
    // the safe pairs in chunks (the d1 chunk skip, pallas_sweep.py:666-726)
    for (int q0 = 0; q0 < n_pairs; q0 += kD1ChunkPairs) {
      const int q1 = min(q0 + kD1ChunkPairs, n_pairs);
      const int mA = p.nx + 2 * q0;
      const int n_s = 2 * (q1 - q0);
      if (skips && mA >= 1 &&
          (S ? d1_skip_shadow<A>(p, c, wp, k, mA, n_s, false, sign)
             : d1_skip<A>(p, c, wp, k, mA, n_s))) {
        // the chunk's last sample, at the distance the pairs form
        int di, dj;
        k.h1 = read0(c, tab[mA + n_s - 1].x, &di, &dj);
        cnt[kD1Skipped] += n_s;
        continue;
      }
      for (int q = q0; q < q1; ++q) {
        d1_pair<A, S>(p, c, tab, k, p.nx + 2 * q, false);
      }
      cnt[kD1Taken] += n_s;
    }
    if (n_pairs > 0 && odd) {
      int di, dj;
      k.h2 = read0(c, p.s_m1_safe, &di, &dj);
    }
    if (odd) d1_single<A, S>(p, c, tab, k, p.nx + 2 * n_pairs, false);
  }
  if (p.n_dense > p.ns1) {
    const int n_pairs = (p.n_dense - p.ns1) / 2;
    const bool odd = (p.n_dense - p.ns1) % 2;
    // K2 runs the masked pairs in chunks too: a skipped chunk restores
    // what the next one reads, h1 and its validity v1, from its last sample
    for (int q0 = 0; q0 < n_pairs; q0 += kD1ChunkPairs) {
      const int q1 = min(q0 + kD1ChunkPairs, n_pairs);
      const int mA = p.ns1 + 2 * q0;
      const int n_s = 2 * (q1 - q0);
      if (S && skips && mA >= 1 &&
          d1_skip_shadow<A>(p, c, wp, k, mA, n_s, true, sign)) {
        int di, dj;
        k.h1 = read0(c, tab[mA + n_s - 1].x, &di, &dj);
        k.v1 = inside0(c, di, dj);
        cnt[kD1Skipped] += n_s;
        continue;
      }
      for (int q = q0; q < q1; ++q) {
        d1_pair<A, S>(p, c, tab, k, p.ns1 + 2 * q, true);
      }
      if (S) cnt[kD1Taken] += n_s;
    }
    if (n_pairs > 0 && odd) {
      int di, dj;
      k.h2 = read0(c, p.s_m1_masked, &di, &dj);
      k.v2 = inside0(c, di, dj);
    }
    if (odd) d1_single<A, S>(p, c, tab, k, p.ns1 + 2 * n_pairs, true);
  }

  // Mip phases: nearest reads of level `lvl` (pallas_sweep.py:808-857),
  // index (a + round(s*sh)) >> lvl, a floor division.  Ids count on from
  // 2 * n_dense, phase after phase (pallas_sweep.py:776-781), and so do the
  // table entries.  With skips, one test for the whole phase
  // (pallas_sweep.py:980-1008), then one per chunk of 32 samples
  // (:945-972).
  int t = p.n_dense;
  for (int ph = 1; ph < p.n_phases; ++ph) {
    const int lvl = p.ph_lvl[ph];
    const int wl = p.lvl_w[lvl];
    const int pad = p.lvl_pad[lvl];
    // row of the buffer = padded row - its first row (never a pointer
    // moved before the buffer)
    const int rpad = pad - p.lvl_row0[lvl];
    const float* L = p.lvl[lvl] + pad;
    const int n_m = p.ph_n[ph];
    const int id0 = 2 * p.n_dense + (t - p.n_dense);
    if (skips &&
        (S ? mip_skip_shadow<A>(c, wp, k, p.pool[lvl], p.pool_w[lvl], lvl,
                                pad, rpad, t, n_m, sign)
           : mip_skip<A>(c, wp, k, p.pool[lvl], p.pool_w[lvl], lvl, pad,
                         rpad, t, n_m))) {
      cnt[kMipSkipped] += n_m;
      t += n_m;
      continue;
    }
    for (int m0 = 0; m0 < n_m; m0 += kMipChunk) {
      const int n = min(kMipChunk, n_m - m0);
      if (skips && n < n_m &&
          (S ? mip_skip_shadow<A>(c, wp, k, p.pool[lvl], p.pool_w[lvl], lvl,
                                  pad, rpad, t + m0, n, sign)
             : mip_skip<A>(c, wp, k, p.pool[lvl], p.pool_w[lvl], lvl, pad,
                           rpad, t + m0, n))) {
        cnt[kMipSkipped] += n;
        continue;
      }
      for (int m = m0; m < m0 + n; ++m) {
        const float2 e = tab[t + m];
        const int r = ((c.a + __float2int_rn(e.x * c.sh_i)) >> lvl) + rpad;
        const int q = (c.b + __float2int_rn(e.x * c.sh_j)) >> lvl;
        const float hs = __ldg(L + (r * wl + q));
        point_update<A, S>(c, k.acc, hs, e, id0 + m);
      }
      cnt[kMipTaken] += n;
    }
    t += n_m;
  }

  if (p.counters != nullptr) {
    // the warp's samples, once per swept cell
    const unsigned live = __popc(__ballot_sync(kFull, !wp.dead));
    if (wp.lane == 0) {
      for (int f = 0; f < 4; ++f) {
        atomicAdd(p.counters + f, (unsigned long long)cnt[f] * live);
      }
    }
  }
  if (wp.dead) return;
  if constexpr (ARGMAX) {
    // the deferred divide (pallas_sweep.py:1010-1014); 1 / 1 for points
    const float d = k.acc.d;
    p.ids[o] = k.acc.id;
    p.aux[o] = k.acc.n / (fabsf(d) > 1e-30f ? d : 1e-30f);
  }
  float v = k.acc.v;
  if constexpr (!SHADOW) {
    // the tilt ramp, added after the argmax emit (pallas_sweep.py:1015-1016)
    if (p.ramp_a != nullptr) {
      const float ux = p.trig[2 * az];
      const float uy = p.trig[2 * az + 1];
      v = (v + ux * p.ramp_a[cell]) + uy * p.ramp_b[cell];
    }
  }
  p.out[o] = v;
}

template <bool ARGMAX, bool SHADOW>
int launch(const HzParams* params, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kBlockCols, kBlockRows);
  dim3 grid((params->in1 + kBlockCols - 1) / kBlockCols,
            (params->in0 + kBlockRows - 1) / kBlockRows, params->a_num);
  if (params->blocks != nullptr) {
    if (params->n_blocks <= 0) return (int)cudaSuccess;
    grid = dim3(params->n_blocks, 1, params->a_num);
  }
  const size_t smem = sizeof(float2) * (size_t)params->n_steps;
  horizon_sweep_kernel<ARGMAX, SHADOW>
      <<<grid, block, smem, (cudaStream_t)stream>>>(*params);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch K1 on `stream` (a cudaStream_t) of `device`; return the
// cudaError_t of the launch (0 on success).  Do not synchronise.  The mask
// and tilt-ramp variants are the same entries with params->mask and
// params->blocks, or params->ramp_a and params->ramp_b, set.
extern "C" int horizon_sweep_launch(const HzParams* params, int device,
                                    void* stream) {
  return launch<false, false>(params, device, stream);
}

// The argmax variant: also writes params->ids and params->aux.
extern "C" int horizon_sweep_argmax_launch(const HzParams* params, int device,
                                           void* stream) {
  return launch<true, false>(params, device, stream);
}

// K2: the shadow mode; reads params->sun, x0, y0 and the lo2/hi2 constants
// and writes the metric (a_num suns, in0, in1) to params->out.
extern "C" int shadow_sweep_launch(const HzParams* params, int device,
                                   void* stream) {
  return launch<false, true>(params, device, stream);
}

// K2's argmax variant (the forward of the shadow gradient path): also
// writes params->ids and params->aux (D = s_start + t* of a parabola
// winner).
extern "C" int shadow_sweep_argmax_launch(const HzParams* params, int device,
                                          void* stream) {
  return launch<true, true>(params, device, stream);
}

extern "C" const char* horizon_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int horizon_sweep_params_size() { return (int)sizeof(HzParams); }
