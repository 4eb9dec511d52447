// Copyright (c) 2026
// MIT License
//
// The curved geometry of a lon/lat DEM on Hopper (G1): lon/lat/height to
// ECEF to the local ENU mesh, and on the inner block the surface normals
// and north vectors rotated into ENU, one thread per outer cell.
//
// Replaces no TPU kernel.  The JAX package builds the geometry in NumPy on
// the host (horayzon_tpu/models/pipeline.py:108, CurvedPipeline.
// build_geometry: transform.lonlat2ecef, ecef2enu, ecef2enu_vector and
// direction.surf_norm, north_dir), and so did the port: float64 over
// whole-mesh temporaries, about 250 ms a call on a 972 x 1350 SRTM lon/lat
// mesh, with the card idle.  Every transcendental depends on one axis
// only, so the wrapper (horayzon_tpu_torch/ops/geometry.py) computes them
// on the host per row (sin and cos of the latitude, the prime vertical
// radius n and the z factor b^2 / a^2 * n) and per column (sin and cos of
// the longitude), with transform's own expressions, and each thread does
// the per-cell rest:
//
//   h = float64(height)                       (exact)
//   nh = n + h, zh = zf + h                   ellipsoid; on the sphere
//                                             nh = zh = float32(R + height)
//   x_e = (nh * cos_lat) * cos_lon, y_e = (nh * cos_lat) * sin_lon,
//   z_e = zh * sin_lat                        lonlat2ecef's order
//   d = (x_e, y_e, z_e) - origin
//   x = float32(r00 dx + r01 dy), y = float32((r10 dx + r11 dy) + r12 dz),
//   z = float32((r20 dx + r21 dy) + r22 dz)   ecef2enu's order
//
// and on the inner block also
//
//   v_n = float32(cos_lat cos_lon, cos_lat sin_lon, sin_lat)   surf_norm
//   q = (-x_e, -y_e, b - z_e); q -= ((q0 v0 + q1 v1) + q2 v2) v
//   v_north = float32(q / sqrt((q0^2 + q1^2) + q2^2))           north_dir
//   each rotated as fma(v2, r_k2, fma(v1, r_k1, v0 r_k0)), then float32
//
// Built with --fmad=false (no contraction), IEEE division and sqrt, so the
// mesh is bit-equal to the NumPy build.  ecef2enu_vector's rotation is a
// float64 matrix product through BLAS, whose summation order is the
// library's; OpenBLAS's x86-64 kernels sum three terms as the fused chain
// above, explicit here, and with them the normals and norths are bit-equal
// too.  Summed otherwise, a component differs by at most one float32 ulp of
// its value, or by the float64 rounding of the sum (below 2^-49) where the
// three terms cancel.
//
// What bounds it: 22 float64 operations an outer cell and 53 more an inner
// one (a fused multiply-add counts two; counted in chip_smoke.py), about
// 50 MFLOP at the SRTM mesh, 1.5 us at the card's 34 TFLOP/s; the bytes,
// 4 read and 12 written an outer cell and 24 written an inner one, about
// 30 MB there, 9 us at 3.35 TB/s.  So the kernel is bound by its writes,
// and a warp's 32 threads take 32 neighbouring cells of one row: the
// heights, the mesh and the column factors are read and written in whole
// lines, and the row factors are one broadcast a warp.  The vectors are
// stored interleaved, (n0, n1, 3), as the callers take them.  A call is
// bound by its two copies over PCIe (the heights up, the mesh and the
// vectors back into pageable host memory), not by the kernel.

#include <cuda_runtime.h>
#include <math.h>

// Must match horayzon_tpu_torch/ops/geometry.py::_GeoParams field by field,
// one field a line.
struct GeoParams {
  const float* height;  // (hgt, wid) heights above the ellipsoid [m]
  const double* rows;   // (4, hgt): sin_lat, cos_lat, n, zf
  const double* cols;   // (2, wid): sin_lon, cos_lon
  float* out;           // x, y, z (hgt, wid) each; vec_norm, vec_north
                        // (n0, n1, 3) each
  double ox;            // the ENU origin in ECEF [m]
  double oy;
  double oz;
  double r00;           // ecef2enu_vector's rotation, row by row
  double r01;
  double r02;
  double r10;
  double r11;
  double r12;
  double r20;
  double r21;
  double r22;
  double b;             // the polar semi-axis [m]
  int hgt;              // mesh shape
  int wid;
  int r0;               // the inner block's first row and column
  int c0;
  int n0;               // the inner block's shape
  int n1;
  int sphere;           // 1: nh = zh = float32(n + height)
};

namespace {

constexpr int kBlockCols = 32;
constexpr int kBlockRows = 8;

// ecef2enu_vector's product for each row k as OpenBLAS's x86-64 dgemm
// kernels sum it: a fused multiply-add chain in k order,
// fma(v2, r_k2, fma(v1, r_k1, v0 r_k0)), then float32.
__device__ __forceinline__ void rotate(float* dst, double v0, double v1,
                                       double v2, const GeoParams& p) {
  dst[0] = (float)fma(v2, p.r02, fma(v1, p.r01, v0 * p.r00));
  dst[1] = (float)fma(v2, p.r12, fma(v1, p.r11, v0 * p.r10));
  dst[2] = (float)fma(v2, p.r22, fma(v1, p.r21, v0 * p.r20));
}

__global__ void __launch_bounds__(kBlockCols* kBlockRows)
    geometry_kernel(const GeoParams p) {
  const int j = blockIdx.x * kBlockCols + threadIdx.x;
  const int i = blockIdx.y * kBlockRows + threadIdx.y;
  if (i >= p.hgt || j >= p.wid) return;
  const long long plane = (long long)p.hgt * p.wid;
  const long long k = (long long)i * p.wid + j;
  const float hf = p.height[k];
  const double sin_lat = p.rows[i];
  const double cos_lat = p.rows[p.hgt + i];
  const double sin_lon = p.cols[j];
  const double cos_lon = p.cols[p.wid + j];
  double nh, zh;
  if (p.sphere) {
    // lonlat2ecef's R + h on a float32 height is a float32 sum
    nh = (double)__fadd_rn((float)p.rows[2 * p.hgt + i], hf);
    zh = nh;
  } else {
    nh = p.rows[2 * p.hgt + i] + (double)hf;
    zh = p.rows[3 * p.hgt + i] + (double)hf;
  }
  const double ce = nh * cos_lat;
  const double xe = ce * cos_lon;
  const double ye = ce * sin_lon;
  const double ze = zh * sin_lat;
  const double dx = xe - p.ox;
  const double dy = ye - p.oy;
  const double dz = ze - p.oz;
  p.out[k] = (float)(p.r00 * dx + p.r01 * dy);
  p.out[plane + k] = (float)((p.r10 * dx + p.r11 * dy) + p.r12 * dz);
  p.out[2 * plane + k] = (float)((p.r20 * dx + p.r21 * dy) + p.r22 * dz);

  const int ii = i - p.r0;
  const int jj = j - p.c0;
  if (ii < 0 || ii >= p.n0 || jj < 0 || jj >= p.n1) return;
  // direction.surf_norm, then north_dir on the float32 normal
  const double v0 = (double)(float)(cos_lat * cos_lon);
  const double v1 = (double)(float)(cos_lat * sin_lon);
  const double v2 = (double)(float)sin_lat;
  const double q0 = -xe;
  const double q1 = -ye;
  const double q2 = p.b - ze;
  const double dot = (q0 * v0 + q1 * v1) + q2 * v2;
  const double t0 = q0 - dot * v0;
  const double t1 = q1 - dot * v1;
  const double t2 = q2 - dot * v2;
  const double norm = sqrt((t0 * t0 + t1 * t1) + t2 * t2);
  const double w0 = (double)(float)(t0 / norm);
  const double w1 = (double)(float)(t1 / norm);
  const double w2 = (double)(float)(t2 / norm);
  const long long inner = (long long)p.n0 * p.n1;
  float* vec = p.out + 3 * plane + 3 * ((long long)ii * p.n1 + jj);
  rotate(vec, v0, v1, v2, p);
  rotate(vec + 3 * inner, w0, w1, w2, p);
}

}  // namespace

// Launch the geometry kernel on `stream` (a cudaStream_t) of `device`;
// return the cudaError_t of the launch (0 on success).  Do not synchronise.
extern "C" int geometry_launch(const GeoParams* params, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kBlockCols, kBlockRows);
  const dim3 grid((params->wid + kBlockCols - 1) / kBlockCols,
                  (params->hgt + kBlockRows - 1) / kBlockRows);
  geometry_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(*params);
  return (int)cudaGetLastError();
}

extern "C" const char* geometry_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int geometry_params_size() { return (int)sizeof(GeoParams); }
