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
// Design (both modes): a gather, so the result is deterministic without
// float atomics.  For a fixed (azimuth, sample distance) the map from a
// source cell to the
// cells its sample touches is one constant shift for every cell.  So one
// thread owns one target cell of a level's cotangent and loops over the
// azimuths and sample slots in a fixed order; for each it reads the ids of
// the (at most four, or k^2 on a mip level) source cells whose sample lands
// there, and on a matching id adds that winner's term.  One more thread per
// inner cell sums the z_org terms over the azimuths in order.  The level-0
// pass dominates: every thread of its box computes the shift of, and reads
// up to four ids for, 4*nx + (n_dense - nx + 2) sample slots per azimuth
// (on an H100 at the 2048^2 / 1024^2, 32-azimuth, 20 km bench shape it
// takes about 1.7x K1's time).  Reads go through L2; there is no
// shared-memory staging and no presence skip yet.  Numerics as K1 and K2:
// --fmad=false, IEEE divide and sqrt, shifts formed on the host (float32
// trig / spacing for K3, the sun table's for K4).

#include <cuda_runtime.h>

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
  float* cot[HZ_MAX_LEVELS];  // padded level cotangents, row-major
  int lvl_w[HZ_MAX_LEVELS];   // row stride of each padded level
  int lvl_pad[HZ_MAX_LEVELS]; // sentinel margin of each level
  // target box of each level in padded coordinates: rows [r0, r1), columns
  // [c0, c1); every cell a sample of that level can touch lies inside it
  int box_r0[HZ_MAX_LEVELS], box_r1[HZ_MAX_LEVELS];
  int box_c0[HZ_MAX_LEVELS], box_c1[HZ_MAX_LEVELS];
  int ph_lvl[HZ_MAX_LEVELS];        // mip phase p >= 1: its pyramid level
  int ph_n[HZ_MAX_LEVELS];          // mip phase p >= 1: sample count
  float ph_s_first[HZ_MAX_LEVELS];  // mip phase p >= 1: first distance
  float ph_step[HZ_MAX_LEVELS];     // mip phase p >= 1: distance step
  int n_phases, in0, in1, a_num, off0, off1, nx, n_dense;
  float dx, dy, step, dist, half_step, inv_l0, inv_l1;
  float x0, y0;  // grid origin (K4)
};

namespace {

struct Src {
  const int* ids;
  const float* g;
  const float* aux;
  int in0, in1;
};

// Adjoint of one bilinear level-0 read at distance s, gathered at target
// (R, C): the source cell whose corner (ci, cj) lands there is
// (i_base - floor(s*sh_i) - ci, j_base - floor(s*sh_j) - cj).  coef(id, cell)
// returns the winner's coefficient for this sample, or 0 when the cell's
// winner does not use it.  Corner weights as pallas_sweep.py:1841-1844.
template <class Coef>
__device__ __forceinline__ void gather0(float& acc, const Src& src, float s,
                                        float sh_i, float sh_j, int i_base,
                                        int j_base, Coef coef) {
  const float dif = s * sh_i;
  const float djf = s * sh_j;
  const float di = floorf(dif);
  const float dj = floorf(djf);
  const float fi = dif - di;
  const float fj = djf - dj;
  const int i0 = i_base - (int)di;
  const int j0 = j_base - (int)dj;
#pragma unroll
  for (int ci = 0; ci < 2; ++ci) {
    const int i = i0 - ci;
    if (i < 0 || i >= src.in0) continue;
#pragma unroll
    for (int cj = 0; cj < 2; ++cj) {
      const int j = j0 - cj;
      if (j < 0 || j >= src.in1) continue;
      const long long cell = (long long)i * src.in1 + j;
      const float cf = coef(__ldg(src.ids + cell), cell);
      if (cf == 0.0f) continue;
      const float wi = ci ? fi : 1.0f - fi;
      const float wj = cj ? fj : 1.0f - fj;
      acc += cf * wi * wj;
    }
  }
}

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

// Level-0 cotangent: one thread per target cell of the level-0 box.
template <bool S>
__global__ void __launch_bounds__(256)
replay_level0_kernel(const BwdParams p) {
  const int C = p.box_c0[0] + blockIdx.x * blockDim.x + threadIdx.x;
  const int R = p.box_r0[0] + blockIdx.y * blockDim.y + threadIdx.y;
  if (R >= p.box_r1[0] || C >= p.box_c1[0]) return;
  const int i_base = R - p.off0 - p.lvl_pad[0];
  const int j_base = C - p.off1 - p.lvl_pad[0];
  const long long plane = (long long)p.in0 * p.in1;
  float acc = 0.0f;
  for (int az = 0; az < p.a_num; ++az) {
    const float sh_i = p.shift[2 * az];
    const float sh_j = p.shift[2 * az + 1];
    const Src src{p.ids + az * plane, p.g + az * plane, p.aux + az * plane,
                  p.in0, p.in1};

    // d2 near field, per step (pallas_sweep.py:1864-1936)
    for (int m = 0; m < p.nx; ++m) {
      const float s = (float)(m + 1) * p.step;
      gather0(acc, src, s, sh_i, sh_j, i_base, j_base,
              [&](int id, long long cell) {
                return id == 2 * m ? per_s<S>(__ldg(src.g + cell), s) : 0.0f;
              });
      const float s0 = (float)m * p.step;
      const float s_k[3] = {s0, s0 + p.half_step, s0 + p.step};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        gather0(acc, src, s_k[k], sh_i, sh_j, i_base, j_base,
                [&](int id, long long cell) {
                  if (id != 2 * m + 1) return 0.0f;
                  const float d = __ldg(src.aux + cell);
                  if (!(d > 1e-3f)) return 0.0f;
                  const float gq = per_s<S>(__ldg(src.g + cell), d);
                  return gq * envelope(k, p.inv_l0 * (d - s0));
                });
      }
    }

    // d1 mid field, merged per sample position q at (q+1)*step
    // (pallas_sweep.py:1944-2005): the point winner 2q and the parabolas
    // mm = q, q+1, q+2, whose samples are the positions mm-2, mm-1, mm
    for (int q = max(p.nx - 2, 0); q < p.n_dense; ++q) {
      const float s = (float)(q + 1) * p.step;
      gather0(acc, src, s, sh_i, sh_j, i_base, j_base,
              [&](int id, long long cell) {
                if (id == 2 * q) {
                  return q >= p.nx ? per_s<S>(__ldg(src.g + cell), s) : 0.0f;
                }
                const int mm = (id - 1) >> 1;
                if ((id & 1) == 0 || mm < q || mm > q + 2 || mm < p.nx + 1 ||
                    mm >= p.n_dense) {
                  return 0.0f;
                }
                const float d = __ldg(src.aux + cell);
                if (!(d > 1e-3f)) return 0.0f;
                const float gq = per_s<S>(__ldg(src.g + cell), d);
                const float s0 = (float)(mm - 1) * p.step;
                // position q is sample 2 of mm = q, 1 of q+1, 0 of q+2
                return gq * envelope(2 - (mm - q), p.inv_l1 * (d - s0));
              });
    }
  }
  p.cot[0][(long long)R * p.lvl_w[0] + C] = acc;
}

// Cotangent of mip level `lvl`: one thread per target cell of the level's
// box.  A mip winner at distance s puts g / s (K4: g) on its coarse cell
// (a + round(s*sh)) floor-divided by 2^lvl (pallas_sweep.py:2024-2038), so
// the sources of target row Rc at shift ri are the k rows with
// off0 + i + ri in [k*(Rc - pad), k*(Rc - pad) + k).
template <bool S>
__global__ void __launch_bounds__(256)
replay_mip_kernel(const BwdParams p, int lvl) {
  const int C = p.box_c0[lvl] + blockIdx.x * blockDim.x + threadIdx.x;
  const int R = p.box_r0[lvl] + blockIdx.y * blockDim.y + threadIdx.y;
  if (R >= p.box_r1[lvl] || C >= p.box_c1[lvl]) return;
  const int kp = 1 << lvl;
  const int fr0 = kp * (R - p.lvl_pad[lvl]) - p.off0;
  const int fc0 = kp * (C - p.lvl_pad[lvl]) - p.off1;
  const long long plane = (long long)p.in0 * p.in1;
  float acc = 0.0f;
  for (int az = 0; az < p.a_num; ++az) {
    const float sh_i = p.shift[2 * az];
    const float sh_j = p.shift[2 * az + 1];
    const int* ids = p.ids + az * plane;
    const float* g = p.g + az * plane;
    int id_off = 2 * p.n_dense;
    for (int ph = 1; ph < p.n_phases; ++ph) {
      const int n_m = p.ph_n[ph];
      if (p.ph_lvl[ph] == lvl) {
        for (int m = 0; m < n_m; ++m) {
          const float s = fminf(p.ph_s_first[ph] + (float)m * p.ph_step[ph],
                                p.dist);
          const int ri = __float2int_rn(s * sh_i);
          const int rj = __float2int_rn(s * sh_j);
          const int i_lo = max(fr0 - ri, 0);
          const int i_hi = min(fr0 - ri + kp, p.in0);
          const int j_lo = max(fc0 - rj, 0);
          const int j_hi = min(fc0 - rj + kp, p.in1);
          for (int i = i_lo; i < i_hi; ++i) {
            for (int j = j_lo; j < j_hi; ++j) {
              const long long cell = (long long)i * p.in1 + j;
              if (__ldg(ids + cell) == id_off + m) {
                acc += per_s<S>(__ldg(g + cell), s);
              }
            }
          }
        }
      }
      id_off += n_m;
    }
  }
  p.cot[lvl][(long long)R * p.lvl_w[lvl] + C] = acc;
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
  float acc = 0.0f;
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

dim3 box_grid(const BwdParams& p, int lvl, dim3 block) {
  return dim3((p.box_c1[lvl] - p.box_c0[lvl] + block.x - 1) / block.x,
              (p.box_r1[lvl] - p.box_r0[lvl] + block.y - 1) / block.y);
}

template <bool S>
int launch(const BwdParams* params, int n_levels, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const BwdParams& p = *params;
  const dim3 block(32, 8);
  if (p.box_r1[0] > p.box_r0[0] && p.box_c1[0] > p.box_c0[0]) {
    replay_level0_kernel<S><<<box_grid(p, 0, block), block, 0, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  for (int lvl = 1; lvl < n_levels; ++lvl) {
    if (p.box_r1[lvl] <= p.box_r0[lvl] || p.box_c1[lvl] <= p.box_c0[lvl]) {
      continue;
    }
    replay_mip_kernel<S><<<box_grid(p, lvl, block), block, 0, st>>>(p, lvl);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const long long cells = (long long)p.in0 * p.in1;
  replay_zorg_kernel<S><<<(unsigned)((cells + 255) / 256), 256, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch K3's passes on `stream` (a cudaStream_t) of `device`: the level-0
// gather, one gather per mip level with a non-empty box, and the z_org sum.
// The caller zeroes the level cotangents (cells outside the boxes stay 0).
// Returns the first cudaError_t (0 on success).  Does not synchronise.
extern "C" int horizon_replay_bwd_launch(const BwdParams* params, int n_levels,
                                         int device, void* stream) {
  return launch<false>(params, n_levels, device, stream);
}

// K4, the shadow mode: also reads params->sun, z_org, x0 and y0.
extern "C" int shadow_replay_bwd_launch(const BwdParams* params, int n_levels,
                                        int device, void* stream) {
  return launch<true>(params, n_levels, device, stream);
}

extern "C" const char* horizon_replay_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int horizon_replay_bwd_params_size() {
  return (int)sizeof(BwdParams);
}
