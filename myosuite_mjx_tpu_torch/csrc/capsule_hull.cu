// Capsule against a convex mesh hull for Hopper (sm_90a): one capsule-mesh
// type group's whole narrowphase in one launch.
//
// Replaces no Pallas kernel: the JAX package runs this query as XLA ops
// (myosuite_mjx_tpu/engine/collision.py `_capsule_hull`). The port's plain
// code (engine/collision.py `_capsule_hull`) stays the CPU and grad path and
// this kernel's reference; on the card it ran as some 3,700 small kernels a
// forward, dozens for each of its 32 dependent trips. This kernel does the
// same arithmetic for each (env, pair):
//   the capsule's ends a, b = pos -/+ half x axis (its frame's column 2);
//   both into the hull's frame: a_l = R2^T (a - pos2), seg_l = R2^T
//     (b - pos2) - a_l;
//   32 golden-section trips on [lo, hi] = [0, 1], no early exit: m1 = hi -
//     g (hi - lo), m2 = lo + g (hi - lo), f(t) the signed distance of
//     a_l + t seg_l to the hull (the largest face-plane distance where it
//     is <= 0, inside; else the root of the least squared distance to a
//     triangle, Ericson's regions); [lo, hi] = f(m1) < f(m2) ? [lo, m2] :
//     [m1, hi];
//   t = (lo + hi) / 2, c = a + t (b - a), and c as a sphere of the
//     capsule's radius against the hull: inside, the least deep face
//     (largest plane distance, ties to the first face); outside, the
//     nearest triangle's closest point (ties to the first face) and the
//     unit vector to it (norm clamped at 1e-15); dist - r, the mid point
//     of the hull's and the sphere's surface points, and the normal from
//     the capsule into the hull, in the world frame.
// The region tests run in the reference's order of precedence and only
// the region's own point is computed: the reference computes every
// candidate and selects one, so the values are the same.
//
// What bounds it on this card. It reads 20 numbers an (env, pair) (the two
// positions, the hull's frame, the capsule's axis, radius and half
// length) and writes 7: 2.7 MB at track29's [4096 envs, 6 pairs] in
// float32, 0.8 us at 3.35 TB/s. Its arithmetic is 33 hull queries of
// 2 x F faces a trip (F 12 on track29's cube) at some 70 operations a face:
// 1.3 G operations, 20 us at 67 TFLOP/s. So operations bound it, and far
// above that bound each (env, pair)'s chain of 32 dependent trips does.
// The design keeps that chain in registers and the card full:
// - One warp per (env, pair), `kWarps` a block; 24,576 warps at track29's
//   shape fill the 132 SMs a few times over. Lanes 0-15 evaluate the trip's
//   first probe, lanes 16-31 its second, one face a lane and the faces in
//   chunks of 16 where F > 16, so each trip is one pass over the faces, a
//   4-step butterfly (min of squared distances, max of plane distances:
//   exact in any order) and one exchange between the halves. Every lane
//   then holds the same bits, so the bracket update is warp-uniform.
// - The final query spreads the faces over all 32 lanes; its arg-min and
//   arg-max reduce (value, face) pairs, ties to the lower face, and the
//   closest point comes from the lane that owns the winning face.
// - The hull (its triangles and face equations: 13 numbers a face) is read
//   through the read-only data cache. Every warp of the group reads the
//   same faces (624 bytes for the cube in float32), so they stay in L1;
//   a face's edges are formed where they are used, as the plain path
//   forms them. One path serves every F.
// - No FMA contraction (this file is built with -fmad=false), correctly
//   rounded sqrt and IEEE division, and each sum of three in the order of
//   the ATen reduction the plain path runs (`sum_last`, `sum_mid`), so a
//   value rounds as the plain path rounds it on the card.
#include <cmath>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarps = 4;                       // warps a block
constexpr int kTrips = 32;                      // collision._GOLDEN_TRIPS
constexpr double kGolden = 0.6180339887498949;  // collision._GOLDEN
constexpr double kMinVal = 1e-15;               // collision._MINVAL

// `x.sum(-1)` over a last axis of three: ATen's reduction splits it over
// two threads, (x0 + x2) on one, x1 on the other, then adds the two
template <typename T>
__device__ __forceinline__ T sum_last(T x0, T x1, T x2) {
  return (x0 + x2) + x1;
}

// `x.sum(-2)` over a middle axis of three: one thread adds in order
template <typename T>
__device__ __forceinline__ T sum_mid(T x0, T x1, T x2) {
  return (x0 + x1) + x2;
}

template <typename T>
__device__ __forceinline__ T dot3(const T* x, const T* y) {
  return sum_last(x[0] * y[0], x[1] * y[1], x[2] * y[2]);
}

// min, max and the correctly rounded root of each type
__device__ __forceinline__ float min_of(float x, float y) { return fminf(x, y); }
__device__ __forceinline__ double min_of(double x, double y) {
  return fmin(x, y);
}
__device__ __forceinline__ float max_of(float x, float y) { return fmaxf(x, y); }
__device__ __forceinline__ double max_of(double x, double y) {
  return fmax(x, y);
}
__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }

// torch.clamp(x, min=lo): NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return x != x ? x : max_of(x, lo);
}

// torch.clamp(x, 0, 1)
template <typename T>
__device__ __forceinline__ T clamp01(T x) {
  return x != x ? x : min_of(max_of(x, T(0)), T(1));
}

// One launch's problem: p1, p2 [items, 3]; m1, m2 [items, 3, 3]; s1 the
// capsule's sizes at s1[b * s1_b + g * s1_g + k]; tris [F, 3, 3], eqs [F, 4];
// out dist [items], pos and n [items, 3]; items = batch x pairs.
template <typename T>
struct Problem {
  const T* p1;
  const T* m1;
  const T* s1;
  long s1_b;
  long s1_g;
  const T* p2;
  const T* m2;
  const T* tris;
  const T* eqs;
  T* dist;
  T* pos;
  T* n;
  long items;
  int pairs;
  int faces;
};

// The closest point on face f's triangle to p (`_closest_on_tri`), the
// squared distance to it (`_hull_sq_dists`) and p's plane distance
// (`_plane_dists`); tris [F, 3, 3] and eqs [F, 4] read through the
// read-only cache.
template <typename T>
__device__ __forceinline__ void face_query(const T* __restrict__ tris,
                                           const T* __restrict__ eqs, int f,
                                           const T* p, T* pt, T& d2,
                                           T& plane) {
  T a[3], b[3], c[3], ab[3], ac[3], ap[3], bp[3], cp[3];
  for (int k = 0; k < 3; ++k) {
    a[k] = __ldg(tris + 9 * f + k);
    b[k] = __ldg(tris + 9 * f + 3 + k);
    c[k] = __ldg(tris + 9 * f + 6 + k);
    ab[k] = b[k] - a[k];
    ac[k] = c[k] - a[k];
    ap[k] = p[k] - a[k];
    bp[k] = p[k] - b[k];
    cp[k] = p[k] - c[k];
  }
  const T d1 = dot3(ab, ap), d2_ = dot3(ac, ap);
  const T d3 = dot3(ab, bp), d4 = dot3(ac, bp);
  const T d5 = dot3(ab, cp), d6 = dot3(ac, cp);
  const T va = d3 * d6 - d5 * d4;
  const T vb = d5 * d2_ - d1 * d6;
  const T vc = d1 * d4 - d3 * d2_;
  const T e43 = d4 - d3, e56 = d5 - d6;
  const T lo = T(kMinVal);
  // the reference's where chain, last (strongest) first
  if (d1 <= T(0) && d2_ <= T(0)) {
    for (int k = 0; k < 3; ++k) pt[k] = a[k];
  } else if (d3 >= T(0) && d4 <= d3) {
    for (int k = 0; k < 3; ++k) pt[k] = b[k];
  } else if (d6 >= T(0) && d5 <= d6) {
    for (int k = 0; k < 3; ++k) pt[k] = c[k];
  } else if ((vc <= T(0) && d1 >= T(0) && d3 <= T(0)) ||
             (vb <= T(0) && d2_ >= T(0) && d6 <= T(0)) ||
             (va <= T(0) && e43 >= T(0) && e56 >= T(0))) {
    // an edge: base + clamp(num / clamp(den, min), 0, 1) x edge
    const bool on_ab = vc <= T(0) && d1 >= T(0) && d3 <= T(0);
    const bool on_ac = !on_ab && vb <= T(0) && d2_ >= T(0) && d6 <= T(0);
    const T num = on_ab ? d1 : (on_ac ? d2_ : e43);
    const T den = on_ab ? d1 - d3 : (on_ac ? d2_ - d6 : e43 + e56);
    const T s = clamp01(num / clamp_min(den, lo));
    for (int k = 0; k < 3; ++k) {
      const T base = on_ab || on_ac ? a[k] : b[k];
      const T edge = on_ab ? ab[k] : (on_ac ? ac[k] : c[k] - b[k]);
      pt[k] = base + s * edge;
    }
  } else {
    const T denom = clamp_min((va + vb) + vc, lo);
    const T v = vb / denom, w = vc / denom;
    for (int k = 0; k < 3; ++k) pt[k] = (a[k] + v * ab[k]) + w * ac[k];
  }
  const T dx = pt[0] - p[0], dy = pt[1] - p[1], dz = pt[2] - p[2];
  d2 = sum_last(dx * dx, dy * dy, dz * dz);
  const T n[3] = {__ldg(eqs + 4 * f), __ldg(eqs + 4 * f + 1),
                  __ldg(eqs + 4 * f + 2)};
  plane = dot3(p, n) + __ldg(eqs + 4 * f + 3);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    capsule_hull_kernel(Problem<T> pr) {
  const int lane = threadIdx.x & 31;
  const long item = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (item >= pr.items) return;
  const long bi = item / pr.pairs, gi = item % pr.pairs;
  const T* p1 = pr.p1 + 3 * item;
  const T* m1 = pr.m1 + 9 * item;
  const T* p2 = pr.p2 + 3 * item;
  const T* m2 = pr.m2 + 9 * item;
  const T* s1 = pr.s1 + bi * pr.s1_b + gi * pr.s1_g;
  const T r = s1[0], half = s1[1];

  // `_capsule_ends`, then both ends into the hull's frame
  T a[3], b[3], va[3], vb[3], a_l[3], seg_l[3];
  for (int k = 0; k < 3; ++k) {
    const T h = half * m1[3 * k + 2];
    a[k] = p1[k] - h;
    b[k] = p1[k] + h;
    va[k] = a[k] - p2[k];
    vb[k] = b[k] - p2[k];
  }
  for (int k = 0; k < 3; ++k) {
    a_l[k] = sum_mid(m2[k] * va[0], m2[3 + k] * va[1], m2[6 + k] * va[2]);
    seg_l[k] =
        sum_mid(m2[k] * vb[0], m2[3 + k] * vb[1], m2[6 + k] * vb[2]) - a_l[k];
  }

  // the golden-section search: lanes 0-15 the probe m1, 16-31 m2
  const T golden = static_cast<T>(kGolden);
  const T inf = static_cast<T>(INFINITY);
  const bool second = lane >= 16;
  const int fl = lane & 15;
  T lo = T(0), hi = T(1);
  for (int trip = 0; trip < kTrips; ++trip) {
    const T step = golden * (hi - lo);
    const T t1 = hi - step, t2 = lo + step;
    const T t = second ? t2 : t1;
    T p[3];
    for (int k = 0; k < 3; ++k) p[k] = a_l[k] + t * seg_l[k];
    T d2min = inf, depth = -inf;
    for (int f = fl; f < pr.faces; f += 16) {
      T pt[3], d2, plane;
      face_query(pr.tris, pr.eqs, f, p, pt, d2, plane);
      d2min = min_of(d2min, d2);
      depth = max_of(depth, plane);
    }
    for (int o = 8; o > 0; o >>= 1) {
      d2min = min_of(d2min, __shfl_xor_sync(kFullMask, d2min, o));
      depth = max_of(depth, __shfl_xor_sync(kFullMask, depth, o));
    }
    const T f = depth <= T(0) ? depth : root(clamp_min(d2min, T(0)));
    const T other = __shfl_xor_sync(kFullMask, f, 16);
    const bool left = second ? other < f : f < other;
    if (left) {
      hi = t2;
    } else {
      lo = t1;
    }
  }

  // `_sphere_hull` at the bracket's middle
  const T t = T(0.5) * (lo + hi);
  T c[3], v[3], p[3];
  for (int k = 0; k < 3; ++k) {
    c[k] = a[k] + t * (b[k] - a[k]);
    v[k] = c[k] - p2[k];
  }
  for (int k = 0; k < 3; ++k) {
    p[k] = sum_mid(m2[k] * v[0], m2[3 + k] * v[1], m2[6 + k] * v[2]);
  }
  // `_point_hull`: each lane's nearest face and deepest plane, first
  // faces winning ties, then the same over the warp
  T d2min = inf, depth = -inf, cp[3] = {T(0), T(0), T(0)};
  int kmin = 0x7fffffff, kmax = 0x7fffffff;
  for (int f = lane; f < pr.faces; f += 32) {
    T pt[3], d2, plane;
    face_query(pr.tris, pr.eqs, f, p, pt, d2, plane);
    if (d2 < d2min) {
      d2min = d2;
      kmin = f;
      for (int k = 0; k < 3; ++k) cp[k] = pt[k];
    }
    if (plane > depth) {
      depth = plane;
      kmax = f;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const T od2 = __shfl_xor_sync(kFullMask, d2min, o);
    const int ok = __shfl_xor_sync(kFullMask, kmin, o);
    if (od2 < d2min || (od2 == d2min && ok < kmin)) {
      d2min = od2;
      kmin = ok;
    }
    const T odp = __shfl_xor_sync(kFullMask, depth, o);
    const int oj = __shfl_xor_sync(kFullMask, kmax, o);
    if (odp > depth || (odp == depth && oj < kmax)) {
      depth = odp;
      kmax = oj;
    }
  }
  // the nearest face's lane holds its closest point
  for (int k = 0; k < 3; ++k) {
    cp[k] = __shfl_sync(kFullMask, cp[k], kmin & 31);
  }
  if (lane != 0) return;
  // (only NaN inputs leave a face unset)
  const T* n_in = pr.eqs + 4 * (kmax < pr.faces ? kmax : 0);
  const bool inside = depth <= T(0);
  T x[3], surf[3], nl[3];
  for (int k = 0; k < 3; ++k) x[k] = p[k] - cp[k];
  const T norm = clamp_min(root(sum_last(x[0] * x[0], x[1] * x[1],
                                         x[2] * x[2])),
                           T(kMinVal));
  for (int k = 0; k < 3; ++k) {
    surf[k] = inside ? p[k] - depth * n_in[k] : cp[k];
    nl[k] = inside ? n_in[k] : x[k] / norm;
  }
  const T dist_c = inside ? depth : root(clamp_min(d2min, T(0)));
  pr.dist[item] = dist_c - r;
  for (int k = 0; k < 3; ++k) {
    const T* row = m2 + 3 * k;
    const T nk = -sum_last(row[0] * nl[0], row[1] * nl[1], row[2] * nl[2]);
    const T hull = p2[k] + sum_last(row[0] * surf[0], row[1] * surf[1],
                                    row[2] * surf[2]);
    const T sph = c[k] + nk * r;
    pr.n[3 * item + k] = nk;
    pr.pos[3 * item + k] = T(0.5) * (hull + sph);
  }
}

template <typename T>
int launch(const T* p1, const T* m1, const T* s1, int s1_b, int s1_g,
           const T* p2, const T* m2, const T* tris, const T* eqs, int faces,
           T* dist, T* pos, T* n, int batch, int pairs, void* stream) {
  if (batch <= 0 || pairs <= 0 || faces <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Problem<T> pr{p1,   m1,  s1,   s1_b, s1_g,  p2,
                      m2,   tris, eqs, dist, pos,   n,
                      static_cast<long>(batch) * pairs, pairs, faces};
  const auto st = static_cast<cudaStream_t>(stream);
  const long blocks = (pr.items + kWarps - 1) / kWarps;
  capsule_hull_kernel<T>
      <<<static_cast<unsigned>(blocks), kWarps * 32, 0, st>>>(pr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface for ctypes. p1, p2 [batch, pairs, 3] and m1, m2 [batch,
// pairs, 3, 3] contiguous; the capsule's radius and half length at
// s1[b * s1_b + g * s1_g + 0 / 1]; the hull's tris [faces, 3, 3] and eqs
// [faces, 4] contiguous; out dist [batch, pairs], pos and n [batch, pairs,
// 3]; all on the current device. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success); does not synchronise.
extern "C" int capsule_hull_f32(const float* p1, const float* m1,
                                const float* s1, int s1_b, int s1_g,
                                const float* p2, const float* m2,
                                const float* tris, const float* eqs,
                                int faces, float* dist, float* pos, float* n,
                                int batch, int pairs, void* stream) {
  return launch<float>(p1, m1, s1, s1_b, s1_g, p2, m2, tris, eqs, faces, dist,
                       pos, n, batch, pairs, stream);
}

extern "C" int capsule_hull_f64(const double* p1, const double* m1,
                                const double* s1, int s1_b, int s1_g,
                                const double* p2, const double* m2,
                                const double* tris, const double* eqs,
                                int faces, double* dist, double* pos,
                                double* n, int batch, int pairs,
                                void* stream) {
  return launch<double>(p1, m1, s1, s1_b, s1_g, p2, m2, tris, eqs, faces,
                        dist, pos, n, batch, pairs, stream);
}
