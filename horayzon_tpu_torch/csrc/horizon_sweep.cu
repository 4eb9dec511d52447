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
// computes what the reference computes with exact_metric=True: none of its
// skips (value-exact or sign-exact) run here.
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
//     kernel's block.  A masked cell does no sweep: its thread writes what
//     the reference's mask-aware init (+3e38, :627-638) leaves there, the
//     raw value 3e38 and, in the argmax variant, ID_NONE with D = 1 / 1.
//     Blocks that are not launched hold the same values, written by the
//     wrapper before the launch.  Unmasked cells compute exactly what the
//     unmasked kernel computes: there are no skips to feel the mask.
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
// suns), or with a mask (live blocks, 1, azimuths).  For a given (azimuth, step) the sample shift is the same for every
// cell (and for a given (sun, step) too: K2's shifts are per sun), so a warp
// along a row reads consecutive floats and its loads coalesce.  The padded
// levels are read straight from global memory through L2 with __ldg (at the
// 2048^2 bench grid the three levels take about 38 MB, inside the 50 MB L2;
// K2's six levels at its bench row about 41 MB).  The kernel is bound by that
// L2 load traffic: about 4 loads per bilinear sample and 446 samples per
// (cell, azimuth) at the bench shape (K2: 658 per (cell, sun), 412 of them
// single-load mip reads).  There is no
// shared-memory staging and none of the reference's value-exact early exits
// (directional pooled bounds, chunk and phase skips); staging strips along
// the ray and the skips are later work.
//
// Numerics follow the reference operation by operation so results agree to
// a few float32 ulp: build with --fmad=false (no contraction of a*b+c) and
// never with --use_fast_math.  Trig comes from the host float32 table; there
// is no sinf/cosf here, because a 1-ulp shift across a rounding boundary of a
// mip index reads a neighbouring max-pooled block.  For the same reason K2
// takes its shifts from columns 5-6 of the sun table (ky_u/dy and kx_u/dx
// formed in double on the host), not from a division in the kernel, and its
// vertex-window constants 2(t_lo + 1e-3) and 2(length - 1e-3) come rounded
// from double, as JAX rounds the reference's Python floats.

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
  const float* p = c.l0 + (long long)idi * c.w0 + idj;
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

// Point candidate: K1 the ratio (h - z_org) / s, K2 the clearance
// (h - z_org) - s * m (pallas_sweep.py:486-490).
template <bool A, bool S>
__device__ __forceinline__ void point_update(const Cell& c, Acc<A>& acc,
                                             float he, float s_end, int cid) {
  if constexpr (S) {
    acc.point((he - c.z_org) - s_end * c.m, cid);
  } else {
    acc.point((he - c.z_org) * (1.0f / s_end), cid);
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
// (point) and 2m+1 (parabola).
template <bool A, bool S>
__device__ __forceinline__ void d2_step(const HzParams& p, const Cell& c,
                                        Carry<A>& k, int m, bool masked) {
  const float s_end = (float)(m + 1) * p.step;
  const float s_start = s_end - p.step;
  int dim, djm, die, dje;
  const float hm = read0(c, s_end - p.half_step, &dim, &djm);
  const float he = read0(c, s_end, &die, &dje);
  point_update<A, S>(c, k.acc, he, s_end, 2 * m);
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

// d1 pair of steps ending at (m+1)*step and (m+1)*step + step; carries only
// (acc, h1[, v1]) like the reference loop (pallas_sweep.py:586-608).  Ids 2m
// and 2(m+1) (points), 2(m+1)+1 (parabola).
template <bool A, bool S>
__device__ __forceinline__ void d1_pair(const HzParams& p, const Cell& c,
                                        Carry<A>& k, int m, bool masked) {
  const float s_a = (float)(m + 1) * p.step;
  const float s_b = s_a + p.step;
  int dia, dja, dib, djb;
  const float h_a = read0(c, s_a, &dia, &dja);
  point_update<A, S>(c, k.acc, h_a, s_a, 2 * m);
  const float h_b = read0(c, s_b, &dib, &djb);
  point_update<A, S>(c, k.acc, h_b, s_b, 2 * (m + 1));
  const float a_c = (2.0f * h_b + 2.0f * k.h1 - 4.0f * h_a) * p.inv_l1_sq;
  const float b_c = (4.0f * h_a - 3.0f * k.h1 - h_b) * p.inv_l1;
  bool extra = true;
  bool v_b = true;
  if (masked) {
    v_b = inside0(c, dib, djb);
    extra = k.v1 && inside0(c, dia, dja) && v_b;
  }
  quad_update<A, S>(c, k.acc, a_c, b_c, k.h1, s_b - p.two_step,
                    Win{p.two_step, 0.0f, p.lo2_0, p.hi2_two_step}, extra,
                    2 * (m + 1) + 1);
  k.h1 = h_b;
  if (masked) k.v1 = v_b;
}

// Trailing odd d1 step from the carried h2/h1 history
// (pallas_sweep.py:610-625); ids 2m (point) and 2m+1 (parabola).
template <bool A, bool S>
__device__ __forceinline__ void d1_single(const HzParams& p, const Cell& c,
                                          Carry<A>& k, int m, bool masked) {
  const float s_end = (float)(m + 1) * p.step;
  int die, dje;
  const float he = read0(c, s_end, &die, &dje);
  point_update<A, S>(c, k.acc, he, s_end, 2 * m);
  const float a_c = (2.0f * he + 2.0f * k.h2 - 4.0f * k.h1) * p.inv_l1_sq;
  const float b_c = (4.0f * k.h1 - 3.0f * k.h2 - he) * p.inv_l1;
  bool extra = true;
  if (masked) extra = k.v2 && k.v1 && inside0(c, die, dje);
  quad_update<A, S>(c, k.acc, a_c, b_c, k.h2, s_end - p.two_step,
                    Win{p.two_step, p.step, p.lo2_step, p.hi2_two_step},
                    extra, 2 * m + 1);
  k.h2 = k.h1;
  k.h1 = he;
}

template <bool ARGMAX, bool SHADOW>
__global__ void __launch_bounds__(kBlockCols * kBlockRows)
horizon_sweep_kernel(const HzParams p) {
  // With a mask the grid's x runs over the compacted list of live blocks.
  int bi = blockIdx.y;
  int bj = blockIdx.x;
  if (p.blocks != nullptr) {
    bi = p.blocks[2 * blockIdx.x];
    bj = p.blocks[2 * blockIdx.x + 1];
  }
  const int j = bj * kBlockCols + threadIdx.x;
  const int i = bi * kBlockRows + threadIdx.y;
  const int az = blockIdx.z;
  if (i >= p.in0 || j >= p.in1) return;
  const long long cell = (long long)i * p.in1 + j;
  const long long o = (long long)az * p.in0 * p.in1 + cell;
  if (p.mask != nullptr && p.mask[cell] == 0) {
    p.out[o] = kPosInit;
    if constexpr (ARGMAX) {
      p.ids[o] = kIdNone;
      p.aux[o] = 1.0f;
    }
    return;
  }

  Cell c;
  c.a = p.off0 + i;
  c.b = p.off1 + j;
  c.h = p.h;
  c.w = p.w;
  c.w0 = p.lvl_w[0];
  c.l0 = p.lvl[0] + (long long)(c.a + p.lvl_pad[0]) * c.w0 +
         (c.b + p.lvl_pad[0]);
  c.z_org = p.z_org[cell];
  const float zi = p.z_inner[cell];
  c.m = 0.0f;
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
  } else {
    const float ux = p.trig[2 * az];
    const float uy = p.trig[2 * az + 1];
    c.sh_i = uy / p.dy;  // row cells per metre
    c.sh_j = ux / p.dx;
  }

  Carry<ARGMAX> k{Acc<ARGMAX>{}, zi, zi, true, true};
  constexpr bool A = ARGMAX;
  constexpr bool S = SHADOW;

  // Dense steps, in the reference's sections (pallas_sweep.py:641-757).
  for (int m = 0; m < p.ns2; ++m) d2_step<A, S>(p, c, k, m, false);
  for (int m = p.ns2; m < p.nx; ++m) d2_step<A, S>(p, c, k, m, true);
  if (p.ns1 > p.nx) {
    const int n_pairs = (p.ns1 - p.nx) / 2;
    const bool odd = (p.ns1 - p.nx) % 2;
    for (int q = 0; q < n_pairs; ++q) {
      d1_pair<A, S>(p, c, k, p.nx + 2 * q, false);
    }
    if (n_pairs > 0 && odd) {
      int di, dj;
      k.h2 = read0(c, p.s_m1_safe, &di, &dj);
    }
    if (odd) d1_single<A, S>(p, c, k, p.nx + 2 * n_pairs, false);
  }
  if (p.n_dense > p.ns1) {
    const int n_pairs = (p.n_dense - p.ns1) / 2;
    const bool odd = (p.n_dense - p.ns1) % 2;
    for (int q = 0; q < n_pairs; ++q) {
      d1_pair<A, S>(p, c, k, p.ns1 + 2 * q, true);
    }
    if (n_pairs > 0 && odd) {
      int di, dj;
      k.h2 = read0(c, p.s_m1_masked, &di, &dj);
      k.v2 = inside0(c, di, dj);
    }
    if (odd) d1_single<A, S>(p, c, k, p.ns1 + 2 * n_pairs, true);
  }

  // Mip phases: nearest reads of level `lvl` (pallas_sweep.py:808-857).
  // Index (a + round(s*sh)) floor-divided by 2^lvl; the positive bias keeps
  // the truncating division a floor, as the reference's does.  Ids count on
  // from 2 * n_dense, phase after phase (pallas_sweep.py:776-781).
  int id_off = 2 * p.n_dense;
  for (int ph = 1; ph < p.n_phases; ++ph) {
    const int lvl = p.ph_lvl[ph];
    const int kp = 1 << lvl;
    const int bias = kp * 16384;
    const int wl = p.lvl_w[lvl];
    const int pad = p.lvl_pad[lvl];
    const float* L = p.lvl[lvl];
    const int n_m = p.ph_n[ph];
    const float s_first = p.ph_s_first[ph];
    const float step_l = p.ph_step[ph];
    for (int m = 0; m < n_m; ++m) {
      const float s = fminf(s_first + (float)m * step_l, p.dist);
      const int ri = __float2int_rn(s * c.sh_i);
      const int rj = __float2int_rn(s * c.sh_j);
      const int r = (c.a + ri + bias) / kp - bias / kp + pad;
      const int q = (c.b + rj + bias) / kp - bias / kp + pad;
      const float hs = __ldg(L + (long long)r * wl + q);
      point_update<A, S>(c, k.acc, hs, s, id_off + m);
    }
    id_off += n_m;
  }

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
  horizon_sweep_kernel<ARGMAX, SHADOW>
      <<<grid, block, 0, (cudaStream_t)stream>>>(*params);
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
