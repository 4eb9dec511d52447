// Copyright (c) 2026
// MIT License
//
// Kernel K5: the read floor, a microbenchmark of the sweep's core primitive
// on Hopper.
//
// Replaces tools/read_floor.py::main::kernel (launched there by `run`
// through pl.pallas_call).  The TPU tool measured what bounded the TPU
// sweep: a dynamic unaligned (t0+1, t1+1) windowed read from a VMEM-resident
// window (an aligned slab load plus sublane/lane rolls), with the minimal
// work per sample, a bilinear blend and a running max of he / s.  This kernel
// measures the same function as this card has to compute it.  One thread
// owns one (cell, direction), a block is 32 x 8 cells of one direction and
// the grid (column blocks, row blocks, directions): K1's launch
// (csrc/horizon_sweep.cu), so the access pattern is K1's, and what on the
// TPU is one windowed read per tile is here four loads (bilinear) or one
// load (nearest) per thread.  For every step m = 0 .. n_steps-1 of one cell
// per step along the direction (sh_i, sh_j) = (sin, cos) >= 0:
//
//   s = m + 1;  dif = s * sh_i;  djf = s * sh_j;  di = floor(dif), dj = floor(djf)
//   bilinear: the 2 x 2 cells at (row + di, col + dj), lerped along the
//             columns (top, bot), then along the rows (he), in the TPU
//             body's order (tools/read_floor.py:112-116);
//   nearest:  he = the cell at (row + di, col + dj);
//   aligned:  nearest with the column shift rounded up to the next multiple
//             of 32 cells, dj' = ((dj + 32) / 32) * 32.  With the cell block
//             at a column offset that is a multiple of 32 and a row stride
//             that is one too, the 32 threads of a warp then read exactly one
//             128-byte line: the read minus sector misalignment (an
//             unaligned warp row touches two lines, or five 32-byte sectors
//             instead of four).  The TPU mode of this name was the read
//             minus its realignment rolls; rows need no rounding here;
//   acc = max(acc, he * (1 / s)), from -1e30.
//
// Each of the three runs from two sources (template SMEM):
//   * the window in global memory, read through L1/L2 with __ldg: what K1
//     does today;
//   * the block's strip staged in shared memory: the counterpart of the
//     TPU's VMEM-resident window and the layout a redesigned K1 would use.
//     The strip of all n_steps of a 32 x 8 block spans up to
//     (9 + n_steps) x (33 + n_steps) cells, 276 KB at 246 steps, more than
//     the 227 KB a block can have, so the strip is staged per direction and
//     per chunk of `chunk` steps: the bounding box of the chunk's shifted
//     block windows, (9 + hi_i - lo_i) x (33 + hi_j - lo_j) cells, loaded
//     row by row (threadIdx.y strides the rows, threadIdx.x the columns, so
//     a warp's loads coalesce), then read by every step of the chunk.
//     Dynamic shared memory; above 48 KB the launch raises the kernel's
//     limit with cudaFuncSetAttribute.
//   MODE_STAGE is the staging alone: each thread keeps the max of the cells
//   it staged (the bilinear mode's boxes), so the loads cannot be dropped
//   and the shared-memory modes' time can be split into staging and reads.
//
// Two more modes measure ceilings without a dependent address:
//   * stream: n_steps independent, coalesced float4 loads per thread,
//     folded with max.  Thread t (its linear index in (direction, row,
//     col)) reads quad (t + m * rot) mod nq of the window in step m; rot is
//     a large odd stride (the wrapper takes the golden-ratio fraction of
//     nq), so successive steps of the resident blocks land far apart.  On
//     a window inside the 50 MB of L2 this is L2's read rate.  On a window
//     only a few times L2 a share of the reads still hits it (the 105 MB
//     window reads faster than device memory can deliver): that row is a
//     mix.  Device memory's read rate is the row of a window many times L2
//     (the tool's third window, 1 GiB);
//   * alu (the TPU's `vpu`): no loads; per step y = acc + s, then 8 rounds
//     of x = x * sh_i + sh_j; y = y * sh_j + sh_i; x = max(x, y): two
//     dependent multiply-add chains and a max merge, 41 float32 operations
//     a step.  Built like every kernel of the port with --fmad=false, so
//     each multiply and each add is its own instruction: the ceiling of
//     float32 arithmetic as the port's kernels must write it.
//
// What bounds it: by the roofline the function is bound by operations (20
// float32 operations per bilinear sample against 4 bytes of output per
// (cell, direction)).  What the modes are built to tell apart is which part
// of the machine a sample really waits for: L2 sector traffic (aligned
// against nearest), the load path's latency and bandwidth (the shared
// source against the global one, stage alone), device memory (stream on a
// window many times L2) or instruction throughput (alu).  On an H100 the global and
// the shared source take the same time and the aligned read is no faster,
// while alu runs near one instruction per lane and clock: a sample costs
// the instructions it executes (about 57 per bilinear sample, with its IEEE
// divide, floors, conversions and 64-bit addresses), not its loads.
// Every mode writes its running max, so no load can be proven unused.
// Numerics: --fmad=false and IEEE division (1.0f / s with nvcc's default
// -prec-div=true) make every mode bit-equal to its plain torch version
// (horayzon_tpu_torch/ops/read_floor.py).

#include <cuda_runtime.h>

// Must match horayzon_tpu_torch/ops/read_floor.py::_RfParams field by field.
struct RfParams {
  const float* win;   // (w0, w1) window, row-major
  const float* trig;  // (a_num, 2) float32 (sh_i, sh_j), both >= 0
  float* out;         // (a_num, n0, n1) running maxima
  int w0, w1;         // window shape; w1 is the row stride
  int n0, n1, a_num;  // cells and directions
  int off0, off1;     // window position of cell (0, 0)
  int n_steps;
  int chunk;          // steps per staged strip (shared source)
  int ld;             // row stride of the strip in shared memory [floats]
  long long nq;       // float4 quads of the window (stream)
  long long rot;      // quads between a thread's successive reads (stream)
};

namespace {

constexpr float kInit = -1.0e30f;
constexpr int kBlockCols = 32;
constexpr int kBlockRows = 8;

enum Mode {
  MODE_BILINEAR = 0,
  MODE_NEAREST = 1,
  MODE_ALIGNED = 2,
  MODE_STREAM = 3,
  MODE_ALU = 4,
  MODE_STAGE = 5
};

// Row and column shift of step distance s (tools/read_floor.py:95-98); the
// aligned mode rounds the column shift up to a multiple of the warp width.
template <int MODE>
__device__ __forceinline__ void shifts(float s, float sh_i, float sh_j,
                                       float* dif, float* djf, int* di,
                                       int* dj) {
  *dif = s * sh_i;
  *djf = s * sh_j;
  *di = (int)floorf(*dif);
  *dj = (int)floorf(*djf);
  if constexpr (MODE == MODE_ALIGNED) {
    *dj = ((*dj + kBlockCols) / kBlockCols) * kBlockCols;
  }
}

// One sample from `p`, the cell at (row + di, col + dj), with row stride ld
// (tools/read_floor.py:111-119).
template <int MODE, bool SMEM>
__device__ __forceinline__ float sample(const float* p, int ld, float dif,
                                        float djf, int di, int dj) {
  if constexpr (MODE != MODE_BILINEAR) return SMEM ? p[0] : __ldg(p);
  const float w00 = SMEM ? p[0] : __ldg(p);
  const float w01 = SMEM ? p[1] : __ldg(p + 1);
  const float w10 = SMEM ? p[ld] : __ldg(p + ld);
  const float w11 = SMEM ? p[ld + 1] : __ldg(p + ld + 1);
  const float fi = dif - floorf(dif);
  const float fj = djf - floorf(djf);
  const float top = (1.0f - fj) * w00 + fj * w01;
  const float bot = (1.0f - fj) * w10 + fj * w11;
  return (1.0f - fi) * top + fi * bot;
}

template <int MODE, bool SMEM>
__global__ void __launch_bounds__(kBlockCols* kBlockRows)
    read_floor_kernel(const RfParams p) {
  extern __shared__ float strip[];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * kBlockCols + tx;
  const int i = blockIdx.y * kBlockRows + ty;
  const int k = blockIdx.z;
  const bool live = i < p.n0 && j < p.n1;
  const float sh_i = p.trig[2 * k];
  const float sh_j = p.trig[2 * k + 1];
  float acc = kInit;

  if constexpr (MODE == MODE_STREAM) {
    // a thread past the ragged edge reads too (its index is still unique)
    const long long t =
        ((long long)k * (gridDim.y * kBlockRows) + i) *
            (gridDim.x * kBlockCols) + j;
    const float4* w4 = reinterpret_cast<const float4*>(p.win);
    long long q = t % p.nq;
#pragma unroll 4
    for (int m = 0; m < p.n_steps; ++m) {
      const float4 v = __ldg(w4 + q);
      acc = fmaxf(acc, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
      q += p.rot;
      if (q >= p.nq) q -= p.nq;
    }
  } else if constexpr (MODE == MODE_ALU) {
    for (int m = 0; m < p.n_steps; ++m) {
      const float s = (float)(m + 1);
      float x = acc;
      float y = acc + s;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        x = x * sh_i + sh_j;
        y = y * sh_j + sh_i;
        x = fmaxf(x, y);
      }
      acc = x;
    }
  } else if constexpr (!SMEM) {
    // window position of this thread's cell; a thread past the ragged edge
    // reads its block's last live cell and writes nothing
    const int ci = p.off0 + min(i, p.n0 - 1);
    const int cj = p.off1 + min(j, p.n1 - 1);
    const float* cell = p.win + (long long)ci * p.w1 + cj;
    for (int m = 0; m < p.n_steps; ++m) {
      const float s = (float)(m + 1);
      float dif, djf;
      int di, dj;
      shifts<MODE>(s, sh_i, sh_j, &dif, &djf, &di, &dj);
      const float he = sample<MODE, false>(cell + (long long)di * p.w1 + dj,
                                           p.w1, dif, djf, di, dj);
      acc = fmaxf(acc, he * (1.0f / s));
    }
  } else {
    // the staging mode stages the bilinear mode's boxes
    constexpr int RD = (MODE == MODE_STAGE) ? MODE_BILINEAR : MODE;
    constexpr int EXTRA = (RD == MODE_BILINEAR) ? 1 : 0;
    const int b0 = p.off0 + blockIdx.y * kBlockRows;
    const int b1 = p.off1 + blockIdx.x * kBlockCols;
    for (int m0 = 0; m0 < p.n_steps; m0 += p.chunk) {
      const int m1 = min(m0 + p.chunk, p.n_steps);
      // the shifts grow with s (sh >= 0), so the chunk's first and last
      // steps bound its box
      float dif, djf;
      int lo_i, lo_j, hi_i, hi_j;
      shifts<RD>((float)(m0 + 1), sh_i, sh_j, &dif, &djf, &lo_i, &lo_j);
      shifts<RD>((float)m1, sh_i, sh_j, &dif, &djf, &hi_i, &hi_j);
      const int box_h = kBlockRows + hi_i - lo_i + EXTRA;
      const int box_w = kBlockCols + hi_j - lo_j + EXTRA;
      const float* src = p.win + (long long)(b0 + lo_i) * p.w1 + (b1 + lo_j);
      for (int r = ty; r < box_h; r += kBlockRows) {
        for (int c = tx; c < box_w; c += kBlockCols) {
          const float v = __ldg(src + (long long)r * p.w1 + c);
          strip[r * p.ld + c] = v;
          if constexpr (MODE == MODE_STAGE) acc = fmaxf(acc, v);
        }
      }
      __syncthreads();
      if constexpr (MODE != MODE_STAGE) {
        for (int m = m0; m < m1; ++m) {
          const float s = (float)(m + 1);
          int di, dj;
          shifts<RD>(s, sh_i, sh_j, &dif, &djf, &di, &dj);
          const float he = sample<RD, true>(
              strip + (ty + di - lo_i) * p.ld + (tx + dj - lo_j), p.ld, dif,
              djf, di, dj);
          acc = fmaxf(acc, he * (1.0f / s));
        }
      }
      __syncthreads();
    }
  }
  if (live) p.out[((long long)k * p.n0 + i) * p.n1 + j] = acc;
}

template <int MODE, bool SMEM>
int launch(const RfParams* params, int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        read_floor_kernel<MODE, SMEM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 block(kBlockCols, kBlockRows);
  const dim3 grid((params->n1 + kBlockCols - 1) / kBlockCols,
                  (params->n0 + kBlockRows - 1) / kBlockRows, params->a_num);
  read_floor_kernel<MODE, SMEM>
      <<<grid, block, smem_bytes, (cudaStream_t)stream>>>(*params);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch K5 in `mode` (the Mode enum) from the global (smem = 0) or the
// shared-memory source (smem = 1, with smem_bytes of dynamic shared memory
// for a strip of row stride params->ld) on `stream` (a cudaStream_t) of
// `device`; return the cudaError_t of the launch (0 on success; an unknown
// mode or source gives cudaErrorInvalidValue).  Do not synchronise.
extern "C" int read_floor_launch(const RfParams* params, int mode, int smem,
                                 int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!smem) {
    switch (mode) {
      case MODE_BILINEAR:
        return launch<MODE_BILINEAR, false>(params, 0, stream);
      case MODE_NEAREST:
        return launch<MODE_NEAREST, false>(params, 0, stream);
      case MODE_ALIGNED:
        return launch<MODE_ALIGNED, false>(params, 0, stream);
      case MODE_STREAM:
        return launch<MODE_STREAM, false>(params, 0, stream);
      case MODE_ALU:
        return launch<MODE_ALU, false>(params, 0, stream);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (mode) {
    case MODE_BILINEAR:
      return launch<MODE_BILINEAR, true>(params, smem_bytes, stream);
    case MODE_NEAREST:
      return launch<MODE_NEAREST, true>(params, smem_bytes, stream);
    case MODE_ALIGNED:
      return launch<MODE_ALIGNED, true>(params, smem_bytes, stream);
    case MODE_STAGE:
      return launch<MODE_STAGE, true>(params, smem_bytes, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* read_floor_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int read_floor_params_size() { return (int)sizeof(RfParams); }
