// Copyright (c) 2026
// MIT License
//
// The far field of a simplified outer TIN on Hopper (R1): the coarse grid
// of horayzon_tpu_torch/ops/multires.py::coarse_grid_from_tin, built on the
// card.  One CTA per triangle rasterises it straight into the coarse cells
// its bounding box touches, the CTA's first three threads scatter its
// vertices into their cells, and a second kernel of the same launch lays
// the fine grid's max-pooled blocks over its window.
//
// Replaces no TPU kernel.  The JAX package rasterises the TIN in NumPy on
// the host (horayzon_tpu/ops/multires.py, rasterize_tin and
// coarse_grid_from_tin), and so did the port (its copy): a Python loop over
// the triangles, each a float64 meshgrid of its bounding box, onto a raster
// of up to 4 x 4 points a coarse cell (39.6 M points, a 317 MB float64
// array, for the 2 m deployment's 1574^2 coarse cells), then a 4 x 4
// max-pool, np.maximum.at over the used vertices and the overlay: about
// 8 s a call for 77,618 triangles, with the card idle.
//
// The coarse grid is a maximum of float32 values, so it needs no raster:
// rounding float64 to float32 is monotone, so the float32 of a raster
// point's float64 maximum is the maximum of its candidates' float32 values,
// and a maximum does not depend on the order its candidates come in.  So
// every (triangle, raster point) pair takes its float32 height straight
// into the point's coarse cell (pi / sub, pj / sub), in any order, and the
// result is the copy's bit for bit.  The one exception: where +0.0 and
// -0.0 compete for a cell's maximum, either may win here, as either may in
// NumPy's reductions; the two compare equal.
//
// Raster point (pi, pj) of triangle (a, b, c) (the wrapper,
// horayzon_tpu_torch/ops/tin_raster.py, computes the lattice's scalars on
// the host with coarse_grid_from_tin's own expressions):
//
//   vi = (y - y0) / sy, vj = (x - x0) / sx      each vertex, float64
//   box: ceil(min(vi) - 1e-9) .. floor(max(vi) + 1e-9), clamped to the
//        lattice, columns likewise; an empty box is skipped
//   d = (vi_b - vi_a)(vj_c - vj_a) - (vj_b - vj_a)(vi_c - vi_a);
//       |d| < 1e-12 is skipped
//   wb = ((pi - vi_a)(vj_c - vj_a) - (pj - vj_a)(vi_c - vi_a)) / d
//   wc = ((pj - vj_a)(vi_b - vi_a) - (pi - vi_a)(vj_b - vj_a)) / d
//   wa = (1 - wb) - wc
//   inside: wa, wb, wc >= -1e-6;  z = float32((wa z_a + wb z_b) + wc z_c)
//
// rasterize_tin's float64 operations in its order: built with --fmad=false
// (no contraction) and IEEE division, two true divisions by d, not a
// product with a reciprocal.  A vertex goes into coarse cell
// (floor((y - y0) / cy), floor((x - x0) / cx)) if that lies in the grid, as
// np.maximum.at puts the used vertices; the triangles the wrapper hands
// over use exactly those vertices.  The overlay takes each r x r block of
// the fine grid's rows and columns below multiples of r, its maximum, and
// the maximum of that and the coarse cell over it.
//
// Each thread of a triangle's CTA owns one coarse cell of the box at a
// time: it evaluates the cell's sub x sub raster points (16 at sub = 4)
// that lie in the box, keeps their maximum in a register and makes one
// global atomic maximum if any point was inside.  A box of any size is
// strided over the CTA's threads, so the large triangles of a real
// simplified TIN need nothing else.  A float maximum is an integer atomic:
// non-negative floats order as signed integers, negative ones in reverse
// as unsigned.
//
// What bounds it: 17 float64 operations a raster point of a box (two
// divisions among them; counted in chip_smoke.py), 84.6 M points for the
// 2 m deployment's 77,618 triangles of 33 x 33 points, 1.4 GFLOP, 0.04 ms
// at the card's 34 TFLOP/s; the bytes, the fine grid read once (105 MB),
// the coarse grid written and read (2 x 9.9 MB), 0.04 ms at 3.35 TB/s.
// A division is a sequence of about ten float64 instructions on this card,
// so the divisions, not the bytes, set the pace.

#include <cuda_runtime.h>
#include <math.h>

// Must match horayzon_tpu_torch/ops/tin_raster.py::_TrParams field by field.
struct TrParams {
  const float* verts;    // (n_vert, 3) x, y, z of the TIN's vertices
  const int* tris;       // (n_tri, 3) vertex indices
  const float* z_fine;   // (hf, wf) the fine grid
  float* z_coarse;       // (n_i, n_j), the pad value before the launch
  double x0, y0;         // the corner: raster point (0, 0), coarse cell (0, 0)
  double sx, sy;         // the raster's spacings (sy signed like dy)
  double cx, cy;         // the coarse spacings (grid.dx * r, grid.dy * r)
  int n_tri;
  int n_i, n_j;          // coarse shape; the raster is (n_i sub, n_j sub)
  int sub;               // raster points a coarse cell, along an axis
  int r;                 // fine cells a coarse cell, along an axis
  int hf, wf;            // fine shape
  int ci, cj;            // the coarse cell of fine cell (0, 0)
};

namespace {

constexpr int kThreads = 128;
constexpr int kOverlayCols = 32;
constexpr int kOverlayRows = 8;

// The float maximum of *addr and v, for values that are not NaN.
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (!signbit(v)) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

__global__ void __launch_bounds__(kThreads) tin_raster_kernel(
    const TrParams p) {
  __shared__ double s_vi[3], s_vj[3], s_vz[3];
  const long long t = blockIdx.x;
  if (threadIdx.x < 3) {
    const int v = __ldg(p.tris + 3 * t + threadIdx.x);
    const float* q = p.verts + 3LL * v;
    const double x = (double)__ldg(q);
    const double y = (double)__ldg(q + 1);
    const float z = __ldg(q + 2);
    s_vi[threadIdx.x] = (y - p.y0) / p.sy;
    s_vj[threadIdx.x] = (x - p.x0) / p.sx;
    s_vz[threadIdx.x] = (double)z;
    // the vertex into its coarse cell
    const double fi = floor((y - p.y0) / p.cy);
    const double fj = floor((x - p.x0) / p.cx);
    if (fi >= 0.0 && fi < (double)p.n_i && fj >= 0.0 && fj < (double)p.n_j) {
      atomic_max_float(p.z_coarse + (long long)fi * p.n_j + (long long)fj, z);
    }
  }
  __syncthreads();
  const double via = s_vi[0], vib = s_vi[1], vic = s_vi[2];
  const double vja = s_vj[0], vjb = s_vj[1], vjc = s_vj[2];
  const double h1 = (double)p.n_i * p.sub - 1.0;
  const double w1 = (double)p.n_j * p.sub - 1.0;
  // the bounding box, clamped to the lattice
  double i_lo = ceil(fmin(fmin(via, vib), vic) - 1.0e-9);
  double i_hi = floor(fmax(fmax(via, vib), vic) + 1.0e-9);
  double j_lo = ceil(fmin(fmin(vja, vjb), vjc) - 1.0e-9);
  double j_hi = floor(fmax(fmax(vja, vjb), vjc) + 1.0e-9);
  i_lo = i_lo < 0.0 ? 0.0 : i_lo;
  j_lo = j_lo < 0.0 ? 0.0 : j_lo;
  i_hi = i_hi > h1 ? h1 : i_hi;
  j_hi = j_hi > w1 ? w1 : j_hi;
  if (i_hi < i_lo || j_hi < j_lo) return;
  const double dib = vib - via, djb = vjb - vja;
  const double dic = vic - via, djc = vjc - vja;
  const double d = dib * djc - djb * dic;
  if (fabs(d) < 1.0e-12) return;
  const double za = s_vz[0], zb = s_vz[1], zc = s_vz[2];
  const int pi_lo = (int)i_lo, pi_hi = (int)i_hi;
  const int pj_lo = (int)j_lo, pj_hi = (int)j_hi;
  const int c_i0 = pi_lo / p.sub, c_j0 = pj_lo / p.sub;
  const long long n_cols = pj_hi / p.sub - c_j0 + 1;
  const long long n_cells = (pi_hi / p.sub - c_i0 + 1) * n_cols;
  const double tol = 1.0e-6;
  for (long long k = threadIdx.x; k < n_cells; k += kThreads) {
    const int ci = c_i0 + (int)(k / n_cols);
    const int cj = c_j0 + (int)(k % n_cols);
    const int i0 = max(ci * p.sub, pi_lo), i1 = min(ci * p.sub + p.sub - 1,
                                                     pi_hi);
    const int j0 = max(cj * p.sub, pj_lo), j1 = min(cj * p.sub + p.sub - 1,
                                                     pj_hi);
    float m = 0.0f;
    bool any = false;
    for (int pi = i0; pi <= i1; ++pi) {
      const double di = (double)pi - via;
      for (int pj = j0; pj <= j1; ++pj) {
        const double dj = (double)pj - vja;
        const double wb = (di * djc - dj * dic) / d;
        const double wc = (dj * dib - di * djb) / d;
        const double wa = (1.0 - wb) - wc;
        if (wa >= -tol && wb >= -tol && wc >= -tol) {
          const float z = (float)((wa * za + wb * zb) + wc * zc);
          m = (!any || z > m) ? z : m;
          any = true;
        }
      }
    }
    if (any) atomic_max_float(p.z_coarse + (long long)ci * p.n_j + cj, m);
  }
}

// np.maximum's and the reductions' NaN rule: a NaN wins.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

__global__ void __launch_bounds__(kOverlayCols* kOverlayRows)
    overlay_kernel(const TrParams p) {
  const int pc = blockIdx.x * kOverlayCols + threadIdx.x;
  const int pr = blockIdx.y * kOverlayRows + threadIdx.y;
  if (pr >= p.hf / p.r || pc >= p.wf / p.r) return;
  const float* src = p.z_fine + (long long)pr * p.r * p.wf
                     + (long long)pc * p.r;
  float m = __ldg(src);
  for (int a = 0; a < p.r; ++a) {
    const float* row = src + (long long)a * p.wf;
    for (int b = 0; b < p.r; ++b) m = nan_max(__ldg(row + b), m);
  }
  float* dst = p.z_coarse + (long long)(p.ci + pr) * p.n_j + (p.cj + pc);
  *dst = nan_max(*dst, m);
}

}  // namespace

// Launch R1 and then the overlay on `stream` (a cudaStream_t) of `device`;
// return the cudaError_t of the launches (0 on success).  Do not
// synchronise.
extern "C" int tin_raster_launch(const TrParams* params, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (params->n_tri > 0) {
    tin_raster_kernel<<<params->n_tri, kThreads, 0, s>>>(*params);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int rows = params->hf / params->r, cols = params->wf / params->r;
  if (rows > 0 && cols > 0) {
    const dim3 block(kOverlayCols, kOverlayRows);
    const dim3 grid((cols + kOverlayCols - 1) / kOverlayCols,
                    (rows + kOverlayRows - 1) / kOverlayRows);
    overlay_kernel<<<grid, block, 0, s>>>(*params);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tin_raster_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int tin_raster_params_size() { return (int)sizeof(TrParams); }
