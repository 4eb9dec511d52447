// Copyright (c) 2026
// MIT License
//
// Measured CPU baseline: BVH occlusion ray tracing of the DEM triangle
// mesh, with the reference's warm-started horizon search so the ray count
// per (cell, azimuth) matches what HORAYZON reports (~2 with
// ray_guess_const; horizon_comp.cpp:384-496,807-810).
//
// HORAYZON's hot path is Embree rtcOccluded1 over a triangulated DEM.
// Embree is not available in this environment, so this file provides an
// Embree-class stand-in measured on the same machine: a binned-median BVH2
// over the 2-triangles-per-quad mesh, Moller-Trumbore any-hit traversal,
// multithreaded over cells.  It lacks Embree's SIMD packet/stream
// optimisations (typically another ~1.5-3x) — BASELINE.md records how the
// bench combines this measured figure with that bracket.
//
// Exposed C ABI (see native/bvhbase.py):
//   bvh_build(z, h, w, dx, dy)            -> opaque handle (heap pointer)
//   bvh_horizon(handle, ...)              -> total rays shot
//   bvh_free(handle)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Node {
    float bmin[3];
    float bmax[3];
    // leaf: start/count into tri index array; inner: left child is idx+1,
    // right child stored in `right`.  count == 0 marks an inner node.
    int32_t right_or_start;
    int32_t count;
    uint8_t axis;
};

struct Scene {
    // Vertex grid is implicit (heightfield); triangles are derived from
    // the quad index on the fly to keep memory at 4 B/triangle.
    std::vector<float> z;       // (h, w) row-major heights
    int64_t h = 0, w = 0;
    double dx = 0.0, dy = 0.0;  // dy signed (north-up: negative)
    std::vector<int32_t> tris;  // permutation of triangle ids
    std::vector<Node> nodes;
};

inline void tri_vertices(const Scene& s, int32_t tid, float v[3][3]) {
    // Quad (i, j) spans rows i..i+1, cols j..j+1; triangle 2*q+0 is the
    // (00, 01, 10) half, 2*q+1 the (01, 11, 10) half.
    int64_t q = tid >> 1;
    int64_t i = q / (s.w - 1);
    int64_t j = q % (s.w - 1);
    auto set = [&](float* v3, int64_t ii, int64_t jj) {
        v3[0] = (float)(jj * s.dx);
        v3[1] = (float)(ii * s.dy);
        v3[2] = s.z[ii * s.w + jj];
    };
    if ((tid & 1) == 0) {
        set(v[0], i, j); set(v[1], i, j + 1); set(v[2], i + 1, j);
    } else {
        set(v[0], i, j + 1); set(v[1], i + 1, j + 1); set(v[2], i + 1, j);
    }
}

inline void tri_bounds(const Scene& s, int32_t tid, float* bmin, float* bmax,
                       float* centroid) {
    float v[3][3];
    tri_vertices(s, tid, v);
    for (int a = 0; a < 3; ++a) {
        float lo = std::min(v[0][a], std::min(v[1][a], v[2][a]));
        float hi = std::max(v[0][a], std::max(v[1][a], v[2][a]));
        bmin[a] = lo; bmax[a] = hi;
        centroid[a] = 0.5f * (lo + hi);
    }
}

void build_node(Scene& s, std::vector<float>& cent, int32_t node_idx,
                int32_t start, int32_t count) {
    Node& n = s.nodes[node_idx];
    n.bmin[0] = n.bmin[1] = n.bmin[2] = 3.0e38f;
    n.bmax[0] = n.bmax[1] = n.bmax[2] = -3.0e38f;
    for (int32_t k = start; k < start + count; ++k) {
        float bmin[3], bmax[3], c[3];
        tri_bounds(s, s.tris[k], bmin, bmax, c);
        for (int a = 0; a < 3; ++a) {
            n.bmin[a] = std::min(n.bmin[a], bmin[a]);
            n.bmax[a] = std::max(n.bmax[a], bmax[a]);
        }
    }
    if (count <= 4) {
        n.right_or_start = start;
        n.count = count;
        n.axis = 0;
        return;
    }
    // median split on the widest centroid axis
    float cmin[3] = {3.0e38f, 3.0e38f, 3.0e38f};
    float cmax[3] = {-3.0e38f, -3.0e38f, -3.0e38f};
    for (int32_t k = start; k < start + count; ++k) {
        for (int a = 0; a < 3; ++a) {
            float c = cent[3 * (int64_t)k + a];
            cmin[a] = std::min(cmin[a], c);
            cmax[a] = std::max(cmax[a], c);
        }
    }
    int axis = 0;
    float ext = cmax[0] - cmin[0];
    for (int a = 1; a < 3; ++a)
        if (cmax[a] - cmin[a] > ext) { ext = cmax[a] - cmin[a]; axis = a; }
    int32_t mid = start + count / 2;
    // partition tris and their cached centroids together
    std::vector<int32_t> order(count);
    for (int32_t k = 0; k < count; ++k) order[k] = k;
    std::nth_element(order.begin(), order.begin() + count / 2, order.end(),
                     [&](int32_t a, int32_t b) {
                         return cent[3 * (int64_t)(start + a) + axis]
                              < cent[3 * (int64_t)(start + b) + axis];
                     });
    std::vector<int32_t> t2(count);
    std::vector<float> c2(3 * (size_t)count);
    for (int32_t k = 0; k < count; ++k) {
        t2[k] = s.tris[start + order[k]];
        for (int a = 0; a < 3; ++a)
            c2[3 * (size_t)k + a] = cent[3 * (int64_t)(start + order[k]) + a];
    }
    std::memcpy(&s.tris[start], t2.data(), sizeof(int32_t) * count);
    std::memcpy(&cent[3 * (size_t)start], c2.data(),
                sizeof(float) * 3 * count);

    n.count = 0;
    n.axis = (uint8_t)axis;
    int32_t left = (int32_t)s.nodes.size();
    s.nodes.emplace_back();
    build_node(s, cent, left, start, count / 2);
    int32_t right = (int32_t)s.nodes.size();
    s.nodes.emplace_back();
    s.nodes[node_idx].right_or_start = right;   // (vector may reallocate)
    build_node(s, cent, right, mid, count - count / 2);
}

inline bool box_hit(const Node& n, const float* org, const float* inv_dir,
                    float tmax) {
    float t0 = 0.0f, t1 = tmax;
    for (int a = 0; a < 3; ++a) {
        float ta = (n.bmin[a] - org[a]) * inv_dir[a];
        float tb = (n.bmax[a] - org[a]) * inv_dir[a];
        if (ta > tb) std::swap(ta, tb);
        t0 = std::max(t0, ta);
        t1 = std::min(t1, tb);
        if (t0 > t1) return false;
    }
    return true;
}

inline bool tri_hit(const Scene& s, int32_t tid, const float* org,
                    const float* dir, float tmax) {
    float v[3][3];
    tri_vertices(s, tid, v);
    float e1[3], e2[3];
    for (int a = 0; a < 3; ++a) {
        e1[a] = v[1][a] - v[0][a];
        e2[a] = v[2][a] - v[0][a];
    }
    float p[3] = {dir[1] * e2[2] - dir[2] * e2[1],
                  dir[2] * e2[0] - dir[0] * e2[2],
                  dir[0] * e2[1] - dir[1] * e2[0]};
    float det = e1[0] * p[0] + e1[1] * p[1] + e1[2] * p[2];
    if (std::fabs(det) < 1e-12f) return false;
    float inv = 1.0f / det;
    float tv[3] = {org[0] - v[0][0], org[1] - v[0][1], org[2] - v[0][2]};
    // +-1e-4 barycentric slack: grazing rays can thread the float32 crack
    // along shared edges (both halves reject by ~1 ulp) and then run for
    // kilometres *under* the surface — a catastrophic false miss for an
    // occlusion query.  Slight double-coverage along edges is harmless
    // for any-hit (the accepted point lies in the neighbour triangle).
    const float be = 1e-4f;
    float u = (tv[0] * p[0] + tv[1] * p[1] + tv[2] * p[2]) * inv;
    if (u < -be || u > 1.0f + be) return false;
    float q[3] = {tv[1] * e1[2] - tv[2] * e1[1],
                  tv[2] * e1[0] - tv[0] * e1[2],
                  tv[0] * e1[1] - tv[1] * e1[0]};
    float w = (dir[0] * q[0] + dir[1] * q[1] + dir[2] * q[2]) * inv;
    if (w < -be || u + w > 1.0f + be) return false;
    float t = (e2[0] * q[0] + e2[1] * q[1] + e2[2] * q[2]) * inv;
    return t > 1e-4f && t < tmax;
}

bool occluded(const Scene& s, const float* org, const float* dir,
              float tmax) {
    float inv_dir[3];
    for (int a = 0; a < 3; ++a)
        inv_dir[a] = 1.0f / (std::fabs(dir[a]) > 1e-20f
                             ? dir[a] : copysignf(1e-20f, dir[a]));
    int32_t stack[96];
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
        const Node& n = s.nodes[stack[--sp]];
        if (!box_hit(n, org, inv_dir, tmax)) continue;
        if (n.count > 0) {
            for (int32_t k = n.right_or_start;
                 k < n.right_or_start + n.count; ++k)
                if (tri_hit(s, s.tris[k], org, dir, tmax)) return true;
        } else {
            // build order invariant: a node's left child is allocated
            // immediately after it (depth-first), right child is explicit
            int32_t left = (int32_t)(&n - s.nodes.data()) + 1;
            // near-child-first by ray direction on the split axis
            if (dir[n.axis] >= 0.0f) {
                stack[sp++] = n.right_or_start;
                stack[sp++] = left;
            } else {
                stack[sp++] = left;
                stack[sp++] = n.right_or_start;
            }
        }
    }
    return false;
}

}  // namespace

extern "C" {

void* bvh_build(const float* z, int64_t h, int64_t w, double dx, double dy) {
    auto* s = new Scene();
    s->h = h; s->w = w; s->dx = dx; s->dy = dy;
    s->z.assign(z, z + h * w);
    int64_t ntri = 2 * (h - 1) * (w - 1);
    s->tris.resize(ntri);
    for (int64_t k = 0; k < ntri; ++k) s->tris[k] = (int32_t)k;
    std::vector<float> cent(3 * (size_t)ntri);
    for (int64_t k = 0; k < ntri; ++k) {
        float bmin[3], bmax[3];
        tri_bounds(*s, (int32_t)k, bmin, bmax, &cent[3 * (size_t)k]);
    }
    s->nodes.reserve((size_t)(2.1 * ntri / 4 + 64));
    s->nodes.emplace_back();
    build_node(*s, cent, 0, 0, (int32_t)ntri);
    return s;
}

void bvh_free(void* handle) { delete (Scene*)handle; }

// single-ray occlusion query (test hook)
int bvh_occluded(void* handle, const float* org, const float* dir,
                 double tmax) {
    return occluded(*(const Scene*)handle, org, dir, (float)tmax) ? 1 : 0;
}

// Horizon with the reference's warm-started elevation search
// (ray_guess_const): binary search on the first azimuth, +-hori_acc/5
// index stepping warm-started from the previous azimuth after that.
// Returns the total number of occlusion rays shot (the reference's
// "Number of rays shot" metric, horizon_comp.cpp:807-810).
int64_t bvh_horizon(void* handle, int64_t off0, int64_t off1,
                    int64_t in0, int64_t in1, int64_t azim_num,
                    double dist_search, double hori_acc_deg,
                    double elev_low_deg, double elev_up_deg,
                    double ray_org_elev, int n_threads, float* hori_out) {
    const Scene& s = *(const Scene*)handle;
    const float acc = (float)(hori_acc_deg * M_PI / 180.0);
    const float elev_low = (float)(elev_low_deg * M_PI / 180.0);
    const float elev_up = (float)(elev_up_deg * M_PI / 180.0);
    const int elev_num = (int)std::ceil((elev_up - elev_low) / (acc / 5.0f));
    std::vector<float> elev_ang(elev_num), elev_sin(elev_num),
        elev_cos(elev_num);
    for (int i = 0; i < elev_num; ++i) {
        elev_ang[i] = elev_low + i * (acc / 5.0f);
        elev_sin[i] = std::sin(elev_ang[i]);
        elev_cos[i] = std::cos(elev_ang[i]);
    }
    std::vector<float> azim_sin(azim_num), azim_cos(azim_num);
    for (int64_t k = 0; k < azim_num; ++k) {
        double phi = 2.0 * M_PI * (double)k / (double)azim_num;
        azim_sin[k] = (float)std::sin(phi);
        azim_cos[k] = (float)std::cos(phi);
    }
    std::atomic<int64_t> total_rays{0};
    if (n_threads <= 0)
        n_threads = (int)std::thread::hardware_concurrency();

    auto worker = [&](int64_t r_lo, int64_t r_hi) {
        int64_t rays = 0;
        for (int64_t i = r_lo; i < r_hi; ++i) {
            for (int64_t j = 0; j < in1; ++j) {
                int64_t gi = off0 + i, gj = off1 + j;
                float org[3] = {(float)(gj * s.dx), (float)(gi * s.dy),
                                s.z[gi * s.w + gj] + (float)ray_org_elev};
                float* hb = hori_out + (i * in1 + j) * azim_num;
                auto shoot = [&](int64_t k, int ie) {
                    float dir[3] = {elev_cos[ie] * azim_sin[k],
                                    elev_cos[ie] * azim_cos[k],
                                    elev_sin[ie]};
                    ++rays;
                    return occluded(s, org, dir, (float)dist_search);
                };
                // first azimuth: binary search
                float lo = elev_low, up = elev_up;
                float samp = 0.5f * (lo + up);
                int ie = (int)std::lround((samp - elev_low) / (acc / 5.0f));
                for (int guard = 0; guard < 64
                     && std::max(up - elev_ang[ie], elev_ang[ie] - lo)
                        > acc; ++guard) {
                    if (shoot(0, ie)) lo = elev_ang[ie];
                    else up = elev_ang[ie];
                    samp = 0.5f * (lo + up);
                    ie = (int)std::lround((samp - elev_low) / (acc / 5.0f));
                }
                hb[0] = samp;
                int ie_prev_azim = ie;
                for (int64_t k = 1; k < azim_num; ++k) {
                    int cur = std::max(ie_prev_azim - 5, 0);
                    int prev = cur;
                    bool hit = true;
                    int count = 0;
                    while (hit) {
                        prev = cur;
                        cur = std::min(cur + 10, elev_num - 1);
                        hit = shoot(k, cur);
                        ++count;
                        if (cur == elev_num - 1 && hit) break;
                    }
                    if (count > 1) {
                        samp = 0.5f * (elev_ang[prev] + elev_ang[cur]);
                    } else {
                        cur = std::min(ie_prev_azim + 5, elev_num - 1);
                        hit = false;
                        while (!hit) {
                            prev = cur;
                            cur = std::max(cur - 10, 0);
                            hit = shoot(k, cur);
                            if (cur == 0 && !hit) break;
                        }
                        samp = 0.5f * (elev_ang[prev] + elev_ang[cur]);
                    }
                    ie = (int)std::lround((samp - elev_low) / (acc / 5.0f));
                    ie = std::min(std::max(ie, 0), elev_num - 1);
                    hb[k] = elev_ang[ie];
                    ie_prev_azim = ie;
                }
            }
        }
        total_rays.fetch_add(rays, std::memory_order_relaxed);
    };

    std::vector<std::thread> pool;
    int64_t rows_per = (in0 + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t r_lo = t * rows_per;
        int64_t r_hi = std::min(in0, r_lo + rows_per);
        if (r_lo >= r_hi) break;
        pool.emplace_back(worker, r_lo, r_hi);
    }
    for (auto& th : pool) th.join();
    return total_rays.load();
}

}  // extern "C"
