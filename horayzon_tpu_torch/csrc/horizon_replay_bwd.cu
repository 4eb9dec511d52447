// Copyright (c) 2026
// MIT License
//
// Kernel K3: winner-replay backward of the planar horizon sweep on Hopper
// (horizon mode, no tilt ramp).
//
// Replaces horayzon_tpu/ops/pallas_sweep.py::_bwd_kernel (mode="horizon"),
// launched there by backward_replay_fn, together with that function's host
// assembly (_overlap_add_level_cots, _overlap_add_inner_tiles).  Inputs are
// the forward record of K1's argmax variant (csrc/horizon_sweep.cu): per
// (azimuth, inner cell) the winner id, the ratio cotangent g and the winning
// parabola's stationary denominator D.  Outputs: one cotangent array per
// padded pyramid level and the (in0, in1) cotangent of z_org.  The pyramid's
// VJP (max-pools, pads) runs outside, in torch.
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
// Design: a gather, so the result is deterministic without float atomics.
// For a fixed (azimuth, sample distance) the map from a source cell to the
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
// shared-memory staging and no presence skip yet.  Numerics as K1:
// --fmad=false, IEEE divide, host trig table.

#include <cuda_runtime.h>

#define HZ_MAX_LEVELS 32

// Must match horayzon_tpu_torch/ops/replay.py::_BwdParams field by field.
struct BwdParams {
  const int* ids;    // (a_num, in0, in1) winner ids of the argmax forward
  const float* g;    // (a_num, in0, in1) cotangent of the raw ratio
  const float* aux;  // (a_num, in0, in1) D of parabola winners
  const float* trig; // (a_num, 2) float32 (sin az, cos az)
  float* zcot;       // (in0, in1) cotangent of z_org
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
    const float sh_i = p.trig[2 * az + 1] / p.dy;
    const float sh_j = p.trig[2 * az] / p.dx;
    const Src src{p.ids + az * plane, p.g + az * plane, p.aux + az * plane,
                  p.in0, p.in1};

    // d2 near field, per step (pallas_sweep.py:1864-1936)
    for (int m = 0; m < p.nx; ++m) {
      const float s = (float)(m + 1) * p.step;
      gather0(acc, src, s, sh_i, sh_j, i_base, j_base,
              [&](int id, long long cell) {
                return id == 2 * m ? __ldg(src.g + cell) * (1.0f / s) : 0.0f;
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
                  const float gq = __ldg(src.g + cell) * (1.0f / d);
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
                  return q >= p.nx ? __ldg(src.g + cell) * (1.0f / s) : 0.0f;
                }
                const int mm = (id - 1) >> 1;
                if ((id & 1) == 0 || mm < q || mm > q + 2 || mm < p.nx + 1 ||
                    mm >= p.n_dense) {
                  return 0.0f;
                }
                const float d = __ldg(src.aux + cell);
                if (!(d > 1e-3f)) return 0.0f;
                const float gq = __ldg(src.g + cell) * (1.0f / d);
                const float s0 = (float)(mm - 1) * p.step;
                // position q is sample 2 of mm = q, 1 of q+1, 0 of q+2
                return gq * envelope(2 - (mm - q), p.inv_l1 * (d - s0));
              });
    }
  }
  p.cot[0][(long long)R * p.lvl_w[0] + C] = acc;
}

// Cotangent of mip level `lvl`: one thread per target cell of the level's
// box.  A mip winner at distance s puts g / s on its coarse cell
// (a + round(s*sh)) floor-divided by 2^lvl (pallas_sweep.py:2024-2038), so
// the sources of target row Rc at shift ri are the k rows with
// off0 + i + ri in [k*(Rc - pad), k*(Rc - pad) + k).
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
    const float sh_i = p.trig[2 * az + 1] / p.dy;
    const float sh_j = p.trig[2 * az] / p.dx;
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
                acc += __ldg(g + cell) * (1.0f / s);
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

// z_org cotangent: one thread per inner cell, the winners' terms summed over
// the azimuths in order (pallas_sweep.py:1877, 1915, 1974, 2087).
__global__ void __launch_bounds__(256)
replay_zorg_kernel(const BwdParams p) {
  const long long plane = (long long)p.in0 * p.in1;
  const long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= plane) return;
  float acc = 0.0f;
  for (int az = 0; az < p.a_num; ++az) {
    const long long o = az * plane + cell;
    const int id = p.ids[o];
    const float gv = p.g[o];
    float term = 0.0f;
    if (id < 2 * p.n_dense) {
      const int m = id >> 1;
      if ((id & 1) == 0) {
        term = -(gv * (1.0f / ((float)(m + 1) * p.step)));
      } else if (m < p.nx || m >= p.nx + 1) {  // the d1 gate drops m == nx
        const float d = p.aux[o];
        if (d > 1e-3f) term = -(gv * (1.0f / d));
      }
    } else {
      int id_off = 2 * p.n_dense;
      for (int ph = 1; ph < p.n_phases; ++ph) {
        const int m = id - id_off;
        if (m >= 0 && m < p.ph_n[ph]) {
          const float s = fminf(p.ph_s_first[ph] + (float)m * p.ph_step[ph],
                                p.dist);
          term = -(gv * (1.0f / s));
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

}  // namespace

// Launch K3's passes on `stream` (a cudaStream_t) of `device`: the level-0
// gather, one gather per mip level with a non-empty box, and the z_org sum.
// The caller zeroes the level cotangents (cells outside the boxes stay 0).
// Returns the first cudaError_t (0 on success).  Does not synchronise.
extern "C" int horizon_replay_bwd_launch(const BwdParams* params, int n_levels,
                                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const BwdParams& p = *params;
  const dim3 block(32, 8);
  if (p.box_r1[0] > p.box_r0[0] && p.box_c1[0] > p.box_c0[0]) {
    replay_level0_kernel<<<box_grid(p, 0, block), block, 0, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  for (int lvl = 1; lvl < n_levels; ++lvl) {
    if (p.box_r1[lvl] <= p.box_r0[lvl] || p.box_c1[lvl] <= p.box_c0[lvl]) {
      continue;
    }
    replay_mip_kernel<<<box_grid(p, lvl, block), block, 0, st>>>(p, lvl);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const long long cells = (long long)p.in0 * p.in1;
  replay_zorg_kernel<<<(unsigned)((cells + 255) / 256), 256, 0, st>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* horizon_replay_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int horizon_replay_bwd_params_size() {
  return (int)sizeof(BwdParams);
}
