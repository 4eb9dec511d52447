// Copyright (c) 2026
// MIT License
//
// The planarisation of a curved ENU mesh onto a regular lattice, on Hopper:
// horayzon_tpu_torch/regrid.py::planarize's Newton inversion and bilinear
// resample, one thread per lattice cell.
//
// Replaces no TPU kernel.  The JAX package runs this step in NumPy on the
// host (horayzon_tpu/regrid.py), and so did the port (regrid.py, its copy):
// single-threaded float64 over whole-lattice temporaries, about 20 s a call
// on the 1421 x 1368 lattice of a 972 x 1350 SRTM lon/lat mesh, with the
// card idle.  Every lattice cell is independent, so one thread keeps its
// cell's Newton iterate in registers and no temporary reaches memory.
//
// For lattice cell (i, j) (wrapper: horayzon_tpu_torch/ops/planarize.py,
// which computes the lattice and the affine seed on the host as regrid
// does):
//
//   x_t = x0 + j * spacing;  y_t = y_start -/+ i * spacing
//   (fj, fi) = A^-1 (x_t - b0, y_t - b1)                    the affine seed
//   num_iter times (regrid.invert_mapping):
//     fi_c, fj_c = clip(fi, 0, h - 1), clip(fj, 0, w - 1)
//     x_cur, y_cur = bilinear(x, y at fi_c, fj_c)
//     the Jacobian by differences over +-0.5 cell, each clipped to the
//     mesh, divided by the clipped step (at least 1e-9); det at least 1e-12
//     in magnitude; one Newton step from (fi_c, fj_c)
//   fi_c, fj_c clipped again; valid = inside the mesh (1e-6 slack) and
//   hypot(x_t - x_cur, y_t - y_cur) < 1;  z = float(bilinear(z at fi_c, fj_c))
//
// Every float64 operation is NumPy's, in regrid's order: built with
// --fmad=false (no contraction), IEEE division and sqrt, clip and maximum
// as NumPy's (a NaN propagates, a tie keeps the bound).  So fi, fj and z are
// bit-equal to regrid.planarize's; valid equal but where the error lies
// within an ulp of 1 m (hypot is the card's, not the C library's).
//
// What bounds it: per cell num_iter x (5 stencils x 2 fields x 4 reads) +
// 12 float64 reads, and 1,408 float64 operations (counted in
// tools/planarize_time.py), 6 IEEE divisions an iteration among them: the
// operations' bound is 0.081 ms at the card's 34 TFLOP/s on the SRTM
// lattice, the bytes' 0.022 ms (the mesh read once, 21 bytes a cell
// written).  The mesh (3 x 8 bytes a vertex, 31.5 MB at the SRTM mesh)
// sits in L2, and a warp's 32 cells along a lattice row read neighbouring
// mesh cells, so most reads hit L1.  On an H100 (700 W) the kernel takes
// 0.39 ms there, 21% of its bound: the division sequences and the gathers'
// L1 traffic, not device memory.

#include <cuda_runtime.h>
#include <math.h>

// Must match horayzon_tpu_torch/ops/planarize.py::_PlParams field by field.
struct PlParams {
  const double* x;       // (h, w) ENU mesh, row-major
  const double* y;
  const double* z;
  double* fi;            // (hr, wr) source row index of each lattice cell
  double* fj;            // (hr, wr) source column index
  float* z_out;          // (hr, wr) heights
  unsigned char* valid;  // (hr, wr) 1 inside the mesh and converged
  double x0;             // x_t = x0 + j * spacing
  double y_start;        // y_t = y_start -/+ i * spacing (y_desc / not)
  double spacing;
  double a00, a01, a10, a11;  // inverse of the affine seed's matrix
  double b0, b1;              // the seed's offset
  int h, w;                   // mesh shape
  int hr, wr;                 // lattice shape
  int y_desc;
  int num_iter;
};

namespace {

constexpr int kBlockCols = 32;
constexpr int kBlockRows = 8;

// NumPy's maximum and minimum inside np.clip and np.maximum: a NaN in `a`
// propagates, and a tie returns the bound.
__device__ __forceinline__ double np_max(double a, double b) {
  return (isnan(a) || a > b) ? a : b;
}

__device__ __forceinline__ double np_min(double a, double b) {
  return (isnan(a) || a < b) ? a : b;
}

__device__ __forceinline__ double np_clip(double v, double lo, double hi) {
  return np_min(np_max(v, lo), hi);
}

// regrid._bilinear's stencil at (fi, fj): the offset of the top-left vertex
// and the weights.  The float-to-integer conversion of a NaN gives 0 here
// and INT64_MIN on the host, both clipped to 0.
struct Stencil {
  long long o;
  double wi, wj;
};

__device__ __forceinline__ Stencil stencil(double fi, double fj, int h,
                                           int w) {
  long long i0 = (long long)floor(fi);
  long long j0 = (long long)floor(fj);
  i0 = i0 < 0 ? 0 : (i0 > h - 2 ? h - 2 : i0);
  j0 = j0 < 0 ? 0 : (j0 > w - 2 ? w - 2 : j0);
  Stencil s;
  s.o = i0 * w + j0;
  s.wi = np_clip(fi - (double)i0, 0.0, 1.0);
  s.wj = np_clip(fj - (double)j0, 0.0, 1.0);
  return s;
}

// ((1-wi)(1-wj) a00 + (1-wi) wj a01) + wi (1-wj) a10) + wi wj a11, as
// regrid._bilinear sums its four terms.
__device__ __forceinline__ double lerp(const double* __restrict__ a,
                                       const Stencil& s, int w) {
  const double* p = a + s.o;
  return ((((1.0 - s.wi) * (1.0 - s.wj)) * __ldg(p)
           + ((1.0 - s.wi) * s.wj) * __ldg(p + 1))
          + (s.wi * (1.0 - s.wj)) * __ldg(p + w))
         + (s.wi * s.wj) * __ldg(p + w + 1);
}

__global__ void __launch_bounds__(kBlockCols* kBlockRows)
    planarize_kernel(const PlParams p) {
  const int j = blockIdx.x * kBlockCols + threadIdx.x;
  const int i = blockIdx.y * kBlockRows + threadIdx.y;
  if (i >= p.hr || j >= p.wr) return;
  const double hm1 = (double)(p.h - 1);
  const double wm1 = (double)(p.w - 1);
  // the lattice's axes (regrid.planarize)
  const double xt = p.x0 + (double)j * p.spacing;
  const double yt = p.y_desc ? p.y_start - (double)i * p.spacing
                             : p.y_start + (double)i * p.spacing;
  // the affine seed (regrid.invert_mapping)
  const double r0 = xt - p.b0;
  const double r1 = yt - p.b1;
  double fj = p.a00 * r0 + p.a01 * r1;
  double fi = p.a10 * r0 + p.a11 * r1;

  for (int it = 0; it < p.num_iter; ++it) {
    const double fi_c = np_clip(fi, 0.0, hm1);
    const double fj_c = np_clip(fj, 0.0, wm1);
    const Stencil c = stencil(fi_c, fj_c, p.h, p.w);
    const double x_cur = lerp(p.x, c, p.w);
    const double y_cur = lerp(p.y, c, p.w);
    const double jp = np_clip(fj_c + 0.5, 0.0, wm1);
    const double jm = np_clip(fj_c - 0.5, 0.0, wm1);
    const double ip = np_clip(fi_c + 0.5, 0.0, hm1);
    const double im = np_clip(fi_c - 0.5, 0.0, hm1);
    const Stencil sjp = stencil(fi_c, jp, p.h, p.w);
    const Stencil sjm = stencil(fi_c, jm, p.h, p.w);
    const Stencil sip = stencil(ip, fj_c, p.h, p.w);
    const Stencil sim = stencil(im, fj_c, p.h, p.w);
    double dxdj = lerp(p.x, sjp, p.w) - lerp(p.x, sjm, p.w);
    double dydj = lerp(p.y, sjp, p.w) - lerp(p.y, sjm, p.w);
    double dxdi = lerp(p.x, sip, p.w) - lerp(p.x, sim, p.w);
    double dydi = lerp(p.y, sip, p.w) - lerp(p.y, sim, p.w);
    const double sj = np_max(jp - jm, 1e-9);
    const double si = np_max(ip - im, 1e-9);
    dxdj /= sj;
    dydj /= sj;
    dxdi /= si;
    dydi /= si;
    double det = dxdj * dydi - dxdi * dydj;
    det = fabs(det) < 1e-12 ? 1e-12 : det;
    const double rx = xt - x_cur;
    const double ry = yt - y_cur;
    fj = fj_c + (dydi * rx - dxdi * ry) / det;
    fi = fi_c + (-dydj * rx + dxdj * ry) / det;
  }

  const double fi_c = np_clip(fi, 0.0, hm1);
  const double fj_c = np_clip(fj, 0.0, wm1);
  const Stencil c = stencil(fi_c, fj_c, p.h, p.w);
  const double err = hypot(xt - lerp(p.x, c, p.w), yt - lerp(p.y, c, p.w));
  const bool inside = fi >= -1e-6 && fi <= hm1 + 1e-6 && fj >= -1e-6 &&
                      fj <= wm1 + 1e-6;
  const long long k = (long long)i * p.wr + j;
  p.fi[k] = fi_c;
  p.fj[k] = fj_c;
  p.z_out[k] = (float)lerp(p.z, c, p.w);
  p.valid[k] = (unsigned char)(inside && err < 1.0);
}

}  // namespace

// Launch the planarisation kernel on `stream` (a cudaStream_t) of `device`;
// return the cudaError_t of the launch (0 on success).  Do not synchronise.
extern "C" int planarize_launch(const PlParams* params, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kBlockCols, kBlockRows);
  const dim3 grid((params->wr + kBlockCols - 1) / kBlockCols,
                  (params->hr + kBlockRows - 1) / kBlockRows);
  planarize_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(*params);
  return (int)cudaGetLastError();
}

extern "C" const char* planarize_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int planarize_params_size() { return (int)sizeof(PlParams); }
