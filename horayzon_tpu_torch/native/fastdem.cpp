// Copyright (c) 2026
// MIT License
//
// Native host-side helpers for horayzon_tpu:
//
//  * load_esri_ascii   — fast parser for ESRI ASCII GRID files (the numpy
//                        loadtxt path the reference uses, load_dem.py:196,
//                        is ~20x slower on large DHM25 tiles).
//  * horizon_march     — multithreaded CPU reference ray-marcher over a
//                        bilinear heightfield.  Plays the role Intel Embree
//                        plays in the reference (independent trusted
//                        implementation, horizon_comp.cpp:241-498) and
//                        doubles as the measured CPU baseline for bench.py.
//  * shadow_march      — CPU occlusion test toward the sun (reference
//                        shadow_comp.cpp:386-491).
//
// Exposed with a plain C ABI for ctypes (no pybind11 dependency).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// ESRI ASCII GRID parser
// ---------------------------------------------------------------------------

// Parse whitespace-separated floats after skipping `skip_lines` header lines.
// Returns the number of values written (up to `capacity`), or -1 on error.
long load_esri_ascii(const char* path, int skip_lines, float* out,
                     long capacity) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::vector<char> buf(size + 1);
    if (std::fread(buf.data(), 1, size, f) != (size_t)size) {
        std::fclose(f);
        return -1;
    }
    std::fclose(f);
    buf[size] = '\0';

    char* p = buf.data();
    char* end = buf.data() + size;
    for (int i = 0; i < skip_lines && p < end; ++i) {
        while (p < end && *p != '\n') ++p;
        if (p < end) ++p;
    }
    long n = 0;
    while (p < end && n < capacity) {
        while (p < end && (*p == ' ' || *p == '\n' || *p == '\r'
                           || *p == '\t')) ++p;
        if (p >= end) break;
        char* next = nullptr;
        float v = std::strtof(p, &next);
        if (next == p) break;
        out[n++] = v;
        p = next;
    }
    return n;
}

// ---------------------------------------------------------------------------
// Bilinear heightfield sampling
// ---------------------------------------------------------------------------

static inline float bilinear(const float* z, long h, long w, double fi,
                             double fj) {
    long i0 = (long)std::floor(fi);
    long j0 = (long)std::floor(fj);
    if (i0 < 0) i0 = 0;
    if (j0 < 0) j0 = 0;
    if (i0 > h - 2) i0 = h - 2;
    if (j0 > w - 2) j0 = w - 2;
    double wi = fi - (double)i0;
    double wj = fj - (double)j0;
    if (wi < 0.0) wi = 0.0;
    if (wi > 1.0) wi = 1.0;
    if (wj < 0.0) wj = 0.0;
    if (wj > 1.0) wj = 1.0;
    const float* r0 = z + i0 * w + j0;
    const float* r1 = r0 + w;
    double top = (1.0 - wj) * r0[0] + wj * r0[1];
    double bot = (1.0 - wj) * r1[0] + wj * r1[1];
    return (float)((1.0 - wi) * top + wi * bot);
}

// ---------------------------------------------------------------------------
// Horizon ray march (planar geometry, like the reference's planar examples)
// ---------------------------------------------------------------------------

struct HorizonJob {
    const float* z;
    long h, w;
    double dx, dy;              // dy signed
    long off0, off1;
    long in0, in1;
    const double* azim;         // (a_num,)
    long a_num;
    double dist;                // search distance [m]
    double step;                // marching step [m]
    double ray_org_elev;
    double elev_low, elev_up;   // [rad]
    float* hori;                // (in0, in1, a_num)
    std::atomic<long>* counter; // row work queue
    std::atomic<long long>* samples;
};

static void horizon_worker(HorizonJob* job) {
    long n_steps = (long)std::floor(job->dist / job->step);
    std::vector<double> di(job->a_num * n_steps);
    std::vector<double> dj(job->a_num * n_steps);
    for (long k = 0; k < job->a_num; ++k) {
        double ux = std::sin(job->azim[k]);
        double uy = std::cos(job->azim[k]);
        for (long m = 0; m < n_steps; ++m) {
            double s = (double)(m + 1) * job->step;
            di[k * n_steps + m] = s * uy / job->dy;
            dj[k * n_steps + m] = s * ux / job->dx;
        }
    }
    long long local_samples = 0;
    for (;;) {
        long i = job->counter->fetch_add(1);
        if (i >= job->in0) break;
        for (long j = 0; j < job->in1; ++j) {
            double z0 = job->z[(i + job->off0) * job->w + (j + job->off1)]
                        + job->ray_org_elev;
            for (long k = 0; k < job->a_num; ++k) {
                double best = -1.0e30;
                const double* dik = &di[k * n_steps];
                const double* djk = &dj[k * n_steps];
                for (long m = 0; m < n_steps; ++m) {
                    double fi = (double)(i + job->off0) + dik[m];
                    double fj = (double)(j + job->off1) + djk[m];
                    if (fi < 0.0 || fi > (double)(job->h - 1)
                        || fj < 0.0 || fj > (double)(job->w - 1))
                        break;  // ray left the domain
                    double hgt = bilinear(job->z, job->h, job->w, fi, fj);
                    double s = (double)(m + 1) * job->step;
                    double r = (hgt - z0) / s;
                    if (r > best) best = r;
                    ++local_samples;
                }
                double ang = std::atan(best);
                if (ang < job->elev_low) ang = job->elev_low;
                if (ang > job->elev_up) ang = job->elev_up;
                job->hori[(i * job->in1 + j) * job->a_num + k] = (float)ang;
            }
        }
    }
    job->samples->fetch_add(local_samples);
}

// Returns the total number of heightfield samples taken (for rays/s
// accounting), or -1 on error.
long long horizon_march(const float* z, long h, long w, double dx, double dy,
                        long off0, long off1, long in0, long in1,
                        const double* azim, long a_num, double dist,
                        double step, double ray_org_elev, double elev_low,
                        double elev_up, int num_threads, float* hori) {
    if (num_threads <= 0)
        num_threads = (int)std::thread::hardware_concurrency();
    std::atomic<long> counter(0);
    std::atomic<long long> samples(0);
    HorizonJob job{z, h, w, dx, dy, off0, off1, in0, in1, azim, a_num,
                   dist, step, ray_org_elev, elev_low, elev_up, hori,
                   &counter, &samples};
    std::vector<std::thread> threads;
    for (int t = 0; t < num_threads; ++t)
        threads.emplace_back(horizon_worker, &job);
    for (auto& th : threads) th.join();
    return samples.load();
}

// ---------------------------------------------------------------------------
// Shadow occlusion march
// ---------------------------------------------------------------------------

// occluded[i,j] = 1 if terrain blocks the ray from cell (i,j) toward the
// sun position; 0 otherwise.
void shadow_march(const float* z, long h, long w, double dx, double dy,
                  long off0, long off1, long in0, long in1,
                  const double* sun_position, double step,
                  double ray_org_elev, int num_threads,
                  unsigned char* occluded) {
    if (num_threads <= 0)
        num_threads = (int)std::thread::hardware_concurrency();
    std::atomic<long> counter(0);
    double diag = std::hypot((double)h * std::fabs(dy),
                             (double)w * std::fabs(dx));
    long n_steps = (long)std::floor(diag / step);
    auto worker = [&]() {
        for (;;) {
            long i = counter.fetch_add(1);
            if (i >= in0) break;
            for (long j = 0; j < in1; ++j) {
                double x0 = (double)(j + off1) * dx;
                double y0 = (double)(i + off0) * dy;
                double z0 = z[(i + off0) * w + (j + off1)] + ray_org_elev;
                double sx = sun_position[0] - x0;
                double sy = sun_position[1] - y0;
                double sz = sun_position[2] - z0;
                double mag = std::sqrt(sx * sx + sy * sy + sz * sz);
                sx /= mag; sy /= mag; sz /= mag;
                double dh = std::hypot(sx, sy);
                unsigned char occ = 0;
                if (dh > 1e-12) {
                    double m = sz / dh;
                    double ui = (sy / dh) / dy;
                    double uj = (sx / dh) / dx;
                    for (long mstep = 0; mstep < n_steps; ++mstep) {
                        double s = (double)(mstep + 1) * step;
                        double fi = (double)(i + off0) + s * ui;
                        double fj = (double)(j + off1) + s * uj;
                        if (fi < 0.0 || fi > (double)(h - 1)
                            || fj < 0.0 || fj > (double)(w - 1))
                            break;
                        double hgt = bilinear(z, h, w, fi, fj);
                        if (hgt > z0 + s * m) { occ = 1; break; }
                    }
                }
                occluded[i * in1 + j] = occ;
            }
        }
    };
    std::vector<std::thread> threads;
    for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// 2x2 max-pyramid level build (host-side preprocessing helper)
// ---------------------------------------------------------------------------

void max_downsample2(const float* z, long h, long w, float pad_value,
                     float* out) {
    long ho = (h + 1) / 2;
    long wo = (w + 1) / 2;
    for (long i = 0; i < ho; ++i) {
        for (long j = 0; j < wo; ++j) {
            float m = pad_value;
            for (long a = 0; a < 2; ++a) {
                long ii = 2 * i + a;
                if (ii >= h) continue;
                for (long b = 0; b < 2; ++b) {
                    long jj = 2 * j + b;
                    if (jj >= w) continue;
                    float v = z[ii * w + jj];
                    if (v > m) m = v;
                }
            }
            out[i * wo + j] = m;
        }
    }
}

}  // extern "C"
