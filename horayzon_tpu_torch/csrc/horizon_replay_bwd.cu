// Copyright (c) 2026
// MIT License
//
// Kernels K3 and K4: winner-replay backward of the planar fused sweep on
// Hopper, K3 for the horizon mode (no tilt ramp), K4 for the shadow mode.
//
// K3 replaces horayzon_tpu/ops/pallas_sweep.py::_bwd_kernel (mode="horizon"),
// launched there by backward_replay_fn, together with that function's host
// assembly (_overlap_add_level_cots, _overlap_add_inner_tiles).  Inputs are
// the forward record of K1's argmax variant (csrc/horizon_sweep.cu): per
// (azimuth, inner cell) the winner id, the ratio cotangent g and the winning
// parabola's stationary denominator D.  Outputs: one cotangent array per
// padded pyramid level and the (in0, in1) cotangent of z_org.  The pyramid's
// VJP (max-pools, pads) runs outside, in torch.
//
// K4 replaces the same body in mode="shadow", launched by
// shadow_backward_replay_fn (pallas_sweep.py:2399-2495), on the record of
// K2's argmax variant: per (sun, inner cell) the winner id, the cotangent g
// of the clearance metric h(s) - z_org - s*m and D = s0 + t*.  It is K3 with
// a SHADOW template parameter and four differences (pallas_sweep.py:1786-
// 1812, 1864-2153):
//   * the shifts are columns 5-6 of the sun table, as K2 reads them;
//   * the coefficients are bare: g for a point, g times the envelope
//     polynomial for a parabola sample (no 1/s or 1/D);
//   * the z_org term of a winner is g * (-1 - S * dm/dz_org), S = s for a
//     point and D for a parabola, with the per-(cell, sun) derivative of the
//     ray slope m = (szr / mag) / max(adv, 1e-4): -1 / dot where
//     adv > 1e-4, else -(sxr^2 + syr^2) / (mag^3 * 1e-4);
//   * its z_org cotangent is returned as the gradient of the ray origins,
//     not added into the heightfield's.
// The gates (D > 1e-3, the d1 parabola gate, s = min(s_first + m*step_l,
// dist) on mip phases) are K3's.
//
// Every (cell, azimuth) has one winner, whose partials are closed-form
// (envelope theorem: at the stationary point the total derivative is the
// partial at fixed t*, and D = s0 + t* was recorded), so no height is read:
//   * point winner at distance s (ids 2m, mip ids): coefficient g / s on the
//     sample's bilinear corners (level 0) or its coarse cell (mip levels);
//   * parabola winner (ids 2m+1): coefficient g / D times the envelope
//     polynomial of each of its three samples;
//   * z_org: minus the coefficient (g / s or g / D) once per winner.
// Sample distances, gates and coefficients are computed as the reference
// backward computes them (pallas_sweep.py:1824-2038), not as the forward
// does: s0 + 0.5*step and (m+1)*step - 0.5*step can differ by an ulp.  The
// reference's gates are mirrored too, including the d1 parabola gate
// nx + 1 <= mm < n_dense, which drops a d1 single's parabola at m = nx.
//
// Design (both modes): a scatter driven by the winners, made deterministic
// by exact integer accumulation instead of float atomics.  One thread per
// (azimuth or sun, inner cell) of the argmax record, adjacent lanes on
// adjacent columns of one row, reads its id, g and D once, decodes its
// winner and forms exactly the float32 terms the reference backward forms
// for it: a point 4 (the bilinear corners of one sample), a parabola 12
// (3 samples x 4 corners), a mip winner 1 (its coarse cell).  Each term is
// rounded to a per-level fixed-point grid 2^-e and added as a 64-bit
// integer into its level's target box; integer addition is associative, so
// two runs, and the plain version that rounds the same terms to the same
// grid (replay.py::backward_replay_plain), are bit-equal.  Four passes:
//   1. the largest |coefficient| of each level, an order-free integer max of
//      the float bits; with the host's bound 2^c_bits on the terms one target
//      can receive it fixes e so that no sum can overflow
//      (replay.py::level_scales);
//   2. the scatter: the lanes of a warp that hit the same target are summed
//      first (__match_any_sync, then an integer __reduce_add_sync of 22-bit
//      pieces), one atomic per distinct target; a level with many terms per
//      target keeps a 124-bit value in two words (62 + 62 bits);
//   3. each box to float32, rounded once (cells outside the boxes stay 0);
//   4. the z_org sum, one thread per inner cell over the rows in order.
// The work is proportional to the winners.  Its bound is the record's
// bytes (read once by each winner pass); what the card spends is the
// scatter's warp matching and int64 atomics into L2, where the level-0 box
// (about 18 MB at the 1024^2 bench block) stays: on an H100 at the bench's
// gradient row the scatter is 88% of K3's 3.2 ms.
// Numerics as K1 and K2: --fmad=false, IEEE divide and sqrt, shifts formed
// on the host (float32 trig / spacing for K3, the sun table's for K4).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#define HZ_MAX_LEVELS 32

// Must match horayzon_tpu_torch/ops/replay.py::_BwdParams field by field.
struct BwdParams {
  const int* ids;      // (a_num, in0, in1) winner ids of the argmax forward
  const float* g;      // (a_num, in0, in1) cotangent of the raw ratio (K3)
                       // or of the clearance metric (K4)
  const float* aux;    // (a_num, in0, in1) D of parabola winners
  const float* shift;  // (a_num, 2) float32 (sh_i, sh_j) [cells per metre]
  const float* sun;    // (a_num, 8) sun table (K4)
  const float* z_org;  // (in0, in1) ray-origin heights (K4)
  float* zcot;         // (in0, in1) cotangent of z_org
  unsigned long long* acc;  // fixed-point words of every level's box, zeroed
  unsigned int* lvl_max;    // (HZ_MAX_LEVELS) bits of max |coefficient|,
                            // zeroed
  float* cot[HZ_MAX_LEVELS];  // padded level cotangents, row-major, zeroed
  long long acc_off[HZ_MAX_LEVELS];  // first word of each level's box
  int lvl_w[HZ_MAX_LEVELS];   // row stride of each padded level
  int lvl_pad[HZ_MAX_LEVELS]; // sentinel margin of each level
  // target box of each level in padded coordinates: rows [r0, r1), columns
  // [c0, c1); every cell a sample of that level can touch lies inside it
  int box_r0[HZ_MAX_LEVELS], box_r1[HZ_MAX_LEVELS];
  int box_c0[HZ_MAX_LEVELS], box_c1[HZ_MAX_LEVELS];
  int cell_off[HZ_MAX_LEVELS];   // first cell of each box among all boxes
  int lvl_cbits[HZ_MAX_LEVELS];  // 2^c_bits bounds the terms per target
  int lvl_words[HZ_MAX_LEVELS];  // 1 or 2 words per accumulator
  int ph_lvl[HZ_MAX_LEVELS];        // mip phase p >= 1: its pyramid level
  int ph_n[HZ_MAX_LEVELS];          // mip phase p >= 1: sample count
  float ph_s_first[HZ_MAX_LEVELS];  // mip phase p >= 1: first distance
  float ph_step[HZ_MAX_LEVELS];     // mip phase p >= 1: distance step
  int n_phases, in0, in1, a_num, off0, off1, nx, n_dense;
  int n_cells;  // cells of all boxes
  float dx, dy, step, dist, half_step, inv_l0, inv_l1;
  float x0, y0;  // grid origin (K4)
  // Appended for the shard variants: the z_org pass adds the winners' terms
  // to what zcot holds (the running sum of the azimuths before this shard's)
  // instead of starting from 0.
  int zcot_continue;
};

namespace {

constexpr unsigned kFull = 0xffffffffu;

// The coefficient of a sample of a point winner at distance s (K3: g / s,
// K4: g) and the factor of a parabola winner with denominator d (K3: g / d,
// K4: g).
template <bool S>
__device__ __forceinline__ float per_s(float g, float s) {
  if constexpr (S) {
    return g;
  } else {
    return g * (1.0f / s);
  }
}

// Envelope polynomials of a parabola's three samples in q*t*
// (pallas_sweep.py:1910-1914, 1971-1979): sample 0 at s0, 1 in the middle,
// 2 at the far end.
__device__ __forceinline__ float envelope(int k, float qt) {
  const float qt2 = qt * qt;
  if (k == 0) return 2.0f * qt2 - 3.0f * qt + 1.0f;
  if (k == 1) return 4.0f * qt - 4.0f * qt2;
  return 2.0f * qt2 - qt;
}

// The winner of one (row, inner cell), decoded.
struct Winner {
  int n;          // samples: 0 (no term), 1 (a point or a mip sample), 3
  int lvl;        // 0, or the mip level of a mip sample
  int r, c;       // level 0: the cell's padded row and column; mip: the
                  // coarse target cell
  float sh_i, sh_j;
  float cf[3];    // coefficient of each sample
  float s[3];     // distance of each level-0 sample
};

// Decode winner t = (row, cell) of the record with the gates, distances and
// coefficients of the reference backward (pallas_sweep.py:1824-2038):
// points 2m at (m+1)*step; d2 parabolas 2m+1 (m < nx) at s0, s0 + half_step,
// s0 + step with s0 = m*step; d1 parabolas 2mm+1 (nx + 1 <= mm < n_dense,
// the gate that drops mm = nx) at the positions mm-2, mm-1, mm, i.e.
// (mm-1+k)*step, envelope in (D - (mm-1)*step) / (2 step); parabolas only
// where D > 1e-3; mip ids at min(s_first + m*step_l, dist) on the coarse
// cell (off + i + round(s*sh)) >> lvl.
template <bool S>
__device__ __forceinline__ Winner decode(const BwdParams& p, long long t) {
  Winner w;
  w.n = 0;
  w.lvl = 0;
  w.r = w.c = 0;
  w.sh_i = w.sh_j = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) w.cf[k] = w.s[k] = 0.0f;
  const long long plane = (long long)p.in0 * p.in1;
  if (t >= plane * p.a_num) return w;
  const int az = (int)(t / plane);
  const long long cell = t - az * plane;
  const int i = (int)(cell / p.in1);
  const int j = (int)(cell - (long long)i * p.in1);
  const int id = __ldg(p.ids + t);
  const float gv = __ldg(p.g + t);
  w.sh_i = __ldg(p.shift + 2 * az);
  w.sh_j = __ldg(p.shift + 2 * az + 1);
  if (id < 2 * p.n_dense) {
    w.r = i + p.off0 + p.lvl_pad[0];
    w.c = j + p.off1 + p.lvl_pad[0];
    const int m = id >> 1;
    if ((id & 1) == 0) {
      const float s = (float)(m + 1) * p.step;
      w.n = 1;
      w.s[0] = s;
      w.cf[0] = per_s<S>(gv, s);
    } else if (m != p.nx) {
      const float d = __ldg(p.aux + t);
      if (d > 1e-3f) {
        const float gq = per_s<S>(gv, d);
        w.n = 3;
        if (m < p.nx) {
          const float s0 = (float)m * p.step;
          const float qt = p.inv_l0 * (d - s0);
          w.s[0] = s0;
          w.s[1] = s0 + p.half_step;
          w.s[2] = s0 + p.step;
#pragma unroll
          for (int k = 0; k < 3; ++k) w.cf[k] = gq * envelope(k, qt);
        } else {
          const float s0 = (float)(m - 1) * p.step;
          const float qt = p.inv_l1 * (d - s0);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            w.s[k] = (float)(m - 1 + k) * p.step;
            w.cf[k] = gq * envelope(k, qt);
          }
        }
      }
    }
  } else {
    int id_off = 2 * p.n_dense;
    for (int ph = 1; ph < p.n_phases; ++ph) {
      const int m = id - id_off;
      if (m >= 0 && m < p.ph_n[ph]) {
        const int lvl = p.ph_lvl[ph];
        const float s = fminf(p.ph_s_first[ph] + (float)m * p.ph_step[ph],
                              p.dist);
        const int ri = __float2int_rn(s * w.sh_i);
        const int rj = __float2int_rn(s * w.sh_j);
        w.n = 1;
        w.lvl = lvl;
        w.cf[0] = per_s<S>(gv, s);
        w.r = ((p.off0 + i + ri) >> lvl) + p.lvl_pad[lvl];
        w.c = ((p.off1 + j + rj) >> lvl) + p.lvl_pad[lvl];
      }
      id_off += p.ph_n[ph];
    }
  }
  return w;
}

// Calls emit(on, r, c, term) for every term of w, on false past its last:
// every lane of the warp in step (the loops run to the warp's largest trip
// count), so emit may synchronise the warp.  A level-0 sample's terms are
// cf * w_i * w_j on its corners (pallas_sweep.py:1841-1844).
template <class Emit>
__device__ __forceinline__ void for_each_term(const Winner& w, Emit emit) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (!__any_sync(kFull, k < w.n)) break;
    const bool has = k < w.n;
    const bool dense = has && w.lvl == 0;
    const bool corners = __any_sync(kFull, dense);
    float fi = 0.0f, fj = 0.0f;
    int r = w.r, c = w.c;
    if (dense) {
      const float dif = w.s[k] * w.sh_i;
      const float djf = w.s[k] * w.sh_j;
      const float di = floorf(dif);
      const float dj = floorf(djf);
      fi = dif - di;
      fj = djf - dj;
      r += (int)di;
      c += (int)dj;
    }
#pragma unroll
    for (int corner = 0; corner < 4; ++corner) {
      if (corner > 0 && !corners) break;
      const int ci = corner >> 1, cj = corner & 1;
      bool on = has && corner == 0;
      int tr = r, tc = c;
      float v = w.cf[k];
      if (dense) {
        const float wi = ci ? fi : 1.0f - fi;
        const float wj = cj ? fj : 1.0f - fj;
        on = true;
        tr += ci;
        tc += cj;
        v = w.cf[k] * wi * wj;
      }
      emit(on, tr, tc, v);  // one call site: emit synchronises the warp
    }
  }
}

// The fixed-point grid of level `lvl` (replay.py::level_scales): terms are
// multiples of 2^-e, |term| < 2^(E+1) for the level's largest coefficient
// 2^E <= max < 2^(E+1); one word e = 61 - c_bits - E, two words
// e = 123 - 2 c_bits - E with the low word holding 62 - c_bits bits.
struct Scale {
  double scale, inv_scale, lo_unit, inv_lo_unit;
  bool two;
};

__device__ __forceinline__ Scale level_scale(const BwdParams& p, int lvl) {
  const float m = __uint_as_float(p.lvl_max[lvl]);
  int x = 1;
  if (m > 0.0f && m <= FLT_MAX) frexp((double)m, &x);
  const int ex = x - 1;
  const int cb = p.lvl_cbits[lvl];
  Scale sc;
  sc.two = p.lvl_words[lvl] == 2;
  const int e = sc.two ? 123 - 2 * cb - ex : 61 - cb - ex;
  const int lo = sc.two ? 62 - cb : 0;
  sc.scale = ldexp(1.0, e);
  sc.inv_scale = ldexp(1.0, -e);
  sc.lo_unit = ldexp(1.0, lo);
  sc.inv_lo_unit = ldexp(1.0, -lo);
  return sc;
}

// x = rint(v * 2^e), exact in float64 (ties to even); two words
// hi = trunc(x * 2^-lo), x - hi * 2^lo (replay.py::quantize).
__device__ __forceinline__ void quantize(float v, const Scale& sc,
                                         long long& q0, long long& q1) {
  const double x = rint((double)v * sc.scale);
  if (!sc.two) {
    q0 = (long long)x;
    q1 = 0;
    return;
  }
  const double hi = trunc(x * sc.inv_lo_unit);
  q0 = (long long)hi;
  q1 = (long long)(x - hi * sc.lo_unit);
}

// Exact sum of v over the lanes of `grp` (every lane of grp calls it): three
// 32-bit reductions of 22-bit pieces, the top piece signed, which cannot
// carry out of 32 bits for 32 lanes.
__device__ __forceinline__ long long group_sum(unsigned grp, long long v) {
  const unsigned long long u = (unsigned long long)v;
  const unsigned lo = __reduce_add_sync(grp, (unsigned)(u & 0x3fffffull));
  const unsigned mid =
      __reduce_add_sync(grp, (unsigned)((u >> 22) & 0x3fffffull));
  const unsigned hi = __reduce_add_sync(grp, (unsigned)(int)(v >> 44));
  return (long long)(((unsigned long long)(long long)(int)hi << 44) +
                     ((unsigned long long)mid << 22) + lo);
}

// Add (q0[, q1]) at addr (nullptr: nothing) for every lane of the warp,
// which calls it in step: lanes with the same target are summed first and
// one of them issues the atomic(s).
__device__ __forceinline__ void add_at(unsigned long long* addr, long long q0,
                                       long long q1, bool two) {
  const unsigned grp = __match_any_sync(kFull, (unsigned long long)addr);
  if (addr == nullptr) return;
  const unsigned lane = threadIdx.x & 31u;
  if (grp != (1u << lane)) {
    // `two` is the same for every lane of grp: one address, one level
    q0 = group_sum(grp, q0);
    if (two) q1 = group_sum(grp, q1);
    if (lane != (unsigned)(__ffs(grp) - 1)) return;
  }
  atomicAdd(addr, (unsigned long long)q0);
  if (two) atomicAdd(addr + 1, (unsigned long long)q1);
}

// Pass 1: the bits of each level's largest |coefficient| (for non-negative
// floats the order of the bits is the order of the values, NaN above inf).
template <bool S>
__global__ void __launch_bounds__(256) replay_max_kernel(const BwdParams p) {
  __shared__ unsigned smax[HZ_MAX_LEVELS];
  if (threadIdx.x < HZ_MAX_LEVELS) smax[threadIdx.x] = 0u;
  __syncthreads();
  const Winner w =
      decode<S>(p, (long long)blockIdx.x * blockDim.x + threadIdx.x);
  unsigned bits = 0u;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k < w.n) bits = max(bits, __float_as_uint(fabsf(w.cf[k])));
  }
  const int key = w.n > 0 ? w.lvl : -1;
  const unsigned grp = __match_any_sync(kFull, key);
  const unsigned top = __reduce_max_sync(grp, bits);
  if (key >= 0 && (threadIdx.x & 31u) == (unsigned)(__ffs(grp) - 1) &&
      top != 0u) {
    atomicMax(&smax[key], top);
  }
  __syncthreads();
  if (threadIdx.x < HZ_MAX_LEVELS && smax[threadIdx.x] != 0u) {
    atomicMax(p.lvl_max + threadIdx.x, smax[threadIdx.x]);
  }
}

// Pass 2: every term rounded to its level's grid and added into the box.
template <bool S>
__global__ void __launch_bounds__(256)
replay_scatter_kernel(const BwdParams p) {
  const Winner w =
      decode<S>(p, (long long)blockIdx.x * blockDim.x + threadIdx.x);
  const int lvl = w.lvl;
  const Scale sc = level_scale(p, lvl);
  const int r0 = p.box_r0[lvl], c0 = p.box_c0[lvl];
  const int bh = p.box_r1[lvl] - r0, bw = p.box_c1[lvl] - c0;
  unsigned long long* const base = p.acc + p.acc_off[lvl];
  const int words = sc.two ? 2 : 1;
  for_each_term(w, [&](bool on, int r, int c, float v) {
    unsigned long long* addr = nullptr;
    long long q0 = 0, q1 = 0;
    const int rr = r - r0, cc = c - c0;
    if (on && rr >= 0 && rr < bh && cc >= 0 && cc < bw) {
      quantize(v, sc, q0, q1);
      if ((q0 | q1) != 0) addr = base + ((long long)rr * bw + cc) * words;
    }
    add_at(addr, q0, q1, sc.two);
  });
}

// Pass 3: each box cell to float32, rounded once from float64; a level with
// a non-finite coefficient is NaN over its box.
__global__ void __launch_bounds__(256)
replay_convert_kernel(const BwdParams p, int n_levels) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= p.n_cells) return;
  int l = 0;
  while (l + 1 < n_levels && t >= p.cell_off[l + 1]) ++l;
  const long long local = t - p.cell_off[l];
  const int bw = p.box_c1[l] - p.box_c0[l];
  const int rr = (int)(local / bw);
  const int cc = (int)(local - (long long)rr * bw);
  const Scale sc = level_scale(p, l);
  const unsigned long long* a = p.acc + p.acc_off[l] + local * (sc.two ? 2 : 1);
  float out;
  if (!(__uint_as_float(p.lvl_max[l]) <= FLT_MAX)) {
    out = __int_as_float(0x7fc00000);
  } else {
    double v = (double)(long long)a[0];
    if (sc.two) v = v * sc.lo_unit + (double)(long long)a[1];
    out = (float)(v * sc.inv_scale);
  }
  p.cot[l][(long long)(p.box_r0[l] + rr) * p.lvl_w[l] + p.box_c0[l] + cc] =
      out;
}

// The z_org term of a winner at S (a point's s, a parabola's D): K3
// -(g / S) (pallas_sweep.py:1874, 1905), K4 g * (-1 - S * dmdz) (:1871,
// 1901).
template <bool S>
__device__ __forceinline__ float zorg_term(float g, float s, float dmdz) {
  if constexpr (S) {
    return g * (-1.0f - s * dmdz);
  } else {
    return -(g * (1.0f / s));
  }
}

// z_org cotangent: one thread per inner cell, the winners' terms summed over
// the azimuths (suns) in order (pallas_sweep.py:1877, 1915, 1974, 2087).
template <bool S>
__global__ void __launch_bounds__(256)
replay_zorg_kernel(const BwdParams p) {
  const long long plane = (long long)p.in0 * p.in1;
  const long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= plane) return;
  float xr = 0.0f, yr = 0.0f, zo = 0.0f;
  if constexpr (S) {
    // lattice coordinates of the cell's global outer row and column
    // (pallas_sweep.py:1786-1790)
    xr = (float)(p.off1 + (int)(cell % p.in1)) * p.dx + p.x0;
    yr = (float)(p.off0 + (int)(cell / p.in1)) * p.dy + p.y0;
    zo = p.z_org[cell];
  }
  float acc = p.zcot_continue ? p.zcot[cell] : 0.0f;
  for (int az = 0; az < p.a_num; ++az) {
    const long long o = az * plane + cell;
    const int id = p.ids[o];
    const float gv = p.g[o];
    float dmdz = 0.0f;
    if constexpr (S) {
      // dm/dz_org of the ray slope toward sun `az` (pallas_sweep.py:
      // 1801-1812)
      const float* sun = p.sun + 8 * az;
      const float sxr = sun[0] - xr;
      const float syr = sun[1] - yr;
      const float szr = sun[2] - zo;
      const float mag = sqrtf(sxr * sxr + syr * syr + szr * szr);
      const float dot = sxr * sun[3] + syr * sun[4];
      const float adv = dot / mag;
      dmdz = adv > 1.0e-4f
                 ? -1.0f / dot
                 : -(sxr * sxr + syr * syr) / (mag * mag * mag * 1.0e-4f);
    }
    float term = 0.0f;
    if (id < 2 * p.n_dense) {
      const int m = id >> 1;
      if ((id & 1) == 0) {
        term = zorg_term<S>(gv, (float)(m + 1) * p.step, dmdz);
      } else if (m < p.nx || m >= p.nx + 1) {  // the d1 gate drops m == nx
        const float d = p.aux[o];
        if (d > 1e-3f) term = zorg_term<S>(gv, d, dmdz);
      }
    } else {
      int id_off = 2 * p.n_dense;
      for (int ph = 1; ph < p.n_phases; ++ph) {
        const int m = id - id_off;
        if (m >= 0 && m < p.ph_n[ph]) {
          const float s = fminf(p.ph_s_first[ph] + (float)m * p.ph_step[ph],
                                p.dist);
          term = zorg_term<S>(gv, s, dmdz);
        }
        id_off += p.ph_n[ph];
      }
    }
    acc += term;
  }
  p.zcot[cell] = acc;
}

// The passes of launch(), as bits of its `passes` argument.
enum { kPassMax = 1, kPassScatter = 2, kPassConvert = 4, kPassZorg = 8,
       kPassAll = 15 };

template <bool S>
int launch(const BwdParams* params, int n_levels, int passes, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const BwdParams& p = *params;
  const long long rows = (long long)p.a_num * p.in0 * p.in1;
  const unsigned blocks = (unsigned)((rows + 255) / 256);
  if (rows > 0 && (passes & kPassMax)) {
    replay_max_kernel<S><<<blocks, 256, 0, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (rows > 0 && (passes & kPassScatter)) {
    replay_scatter_kernel<S><<<blocks, 256, 0, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (p.n_cells > 0 && (passes & kPassConvert)) {
    replay_convert_kernel<<<(unsigned)((p.n_cells + 255) / 256), 256, 0,
                            st>>>(p, n_levels);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const long long cells = (long long)p.in0 * p.in1;
  if (cells > 0 && (passes & kPassZorg)) {
    replay_zorg_kernel<S>
        <<<(unsigned)((cells + 255) / 256), 256, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launch K3's passes on `stream` (a cudaStream_t) of `device`: the level
// maxima, the scatter, the conversion of the boxes and the z_org sum.  The
// caller zeroes acc, lvl_max and the level cotangents (cells outside the
// boxes stay 0).
// Returns the first cudaError_t (0 on success).  Does not synchronise.
extern "C" int horizon_replay_bwd_launch(const BwdParams* params, int n_levels,
                                         int device, void* stream) {
  return launch<false>(params, n_levels, kPassAll, device, stream);
}

// K4, the shadow mode: also reads params->sun, z_org, x0 and y0.
extern "C" int shadow_replay_bwd_launch(const BwdParams* params, int n_levels,
                                        int device, void* stream) {
  return launch<true>(params, n_levels, kPassAll, device, stream);
}

// The shard variants of K3 (shadow = 0) and K4 (shadow = 1): the passes
// named by the bits of `passes` (1 the level maxima, 2 the scatter, 4 the
// conversion of the boxes, 8 the z_org sum), so that the shards of a
// sharded run agree one fixed-point grid before any of them scatters.  A
// shard's record is its own rows and azimuths; its offsets enter as off0 /
// off1 (the global outer row and column of its first cell) and as its rows
// of the shift and sun tables (params->shift points at its first azimuth's
// row), so decode() and the z_org pass form global coordinates unchanged.
// A replay reads no level, so a shard has no level origins of its own:
// its target boxes, in the global padded coordinates of each level, are
// those of its rows and azimuths, and the host adds its words into the
// whole run's boxes (integer addition: exact in any order) before the one
// conversion.
extern "C" int replay_bwd_passes_launch(const BwdParams* params, int n_levels,
                                        int shadow, int passes, int device,
                                        void* stream) {
  return shadow ? launch<true>(params, n_levels, passes, device, stream)
                : launch<false>(params, n_levels, passes, device, stream);
}

extern "C" const char* horizon_replay_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int horizon_replay_bwd_params_size() {
  return (int)sizeof(BwdParams);
}
