// Batched primal Newton solve of the constraint rows for Hopper (sm_90a):
// each env's whole solve, warm start to its own exit, in one launch.
//
// Replaces no Pallas kernel: the JAX package runs this solve as XLA ops
// (myosuite_mjx_tpu/engine/solver.py, a lax.while_loop of two-iteration
// blocks under vmap). The port's eager code (engine/solver.py `_steps`)
// stays the CPU path and this kernel's reference; on the card it ran as
// some 3,000 small kernels a substep replayed from CUDA graphs, with one
// host sync a block, and 54-63% of that work went to envs that had already
// exited. This kernel does the same arithmetic per env:
//   prologue: start from the warm start or qacc_smooth, whichever costs
//     less (both costs in one pass over J); jar = J qacc - aref,
//     M (qacc - qacc_smooth), the cost;
//   blocks of kBlock iterations while it < iterations and the last
//     improvement > tol (tested at block ends only, as the reference);
//   iteration: w = D [eq | jar < 0], grad = M dx + J^T (w jar),
//     H = M + J^T diag(w) J, Cholesky with the pivot clamped (1e-30 in
//     float32, as csrc/spd_solve.cu; the smallest normal in float64, as
//     csrc/spd_solve_general.cu), p = -H^-1 grad, the exact line search
//     on the piecewise quadratic (4 bracket growths by 16, then at most
//     min(ls_iterations, 6) safeguarded Newton / bisection trips on phi'),
//     the descent test grad.p < -1e-16, and the step taken only where the
//     cost falls;
//   out: qacc, force = -w(jar) jar, the iterations run.
// The only work left out gives the same values: a row with w = 0 adds
// nothing to grad and H (every row still enters the cost and each phi',
// phi''); a bracket growth after phi'(hi) >= 0 and a trip after
// |phi'| <= ls_tol pmp change nothing, so the loops stop there; an env
// stops at its own exit.
//
// What bounds it on this card. Per env it must read qM, qacc_smooth, the
// warm start, J, aref and D once and write qacc, force and the count:
// 14.9 KB at hand23's [R 119, nv 23] float32, 61.0 MB at B 4096, 18.2 us
// at 3.35 TB/s; 25.6 KB at legs80's [138, 34], 31.3 us. Its FLOPs (an
// iteration is ~2 R nv for J p plus nv^2 per row in force and nv^3 / 3
// for the factor, a few times over) take under 2 us at 67 TFLOP/s. So
// bytes bound it, and far above that bound each env's chain of dependent
// steps does: some 5-10 iterations, each a factor of nv columns and a line
// search of up to 12 passes over the rows, each pass ending in a warp
// reduction. The design keeps that chain short and the card full:
// - One warp per env, `kWarps` envs per block (fewer where shared memory
//   is short); 4,096-32,768 envs fill the 132 SMs. Every value a branch
//   reads is warp-uniform: sums use a butterfly, whose partners add the
//   same two numbers, so all lanes hold the same bits.
// - Rows over lanes: row i = 32 k + lane keeps jar_i, (J p)_i, D_i and
//   its equality flag where only its lane touches them, so no sync guards
//   them: in the warp's shared memory, or, for an env whose rows do not
//   fit there, in a scratch [B, 2, R] (which the caller allocates only
//   then: newton_solve_needs_scratch) and the inputs. So R has no bound
//   at compile time. A pass over the rows ends in one warp sum.
// - J v reads J coalesced: for 32 rows at a time, lane c takes column c of
//   each row (the warp walks the env's contiguous R x nv block) and one
//   transposing butterfly (31 shuffles) leaves row 32 k + lane's sum on
//   its lane, so nothing re-reads J from L1 lane by lane.
// - H over lanes by rows: lane r sums row r of J^T diag(w) J in registers,
//   up to 32 columns at a time, over the rows in force only (a ballot per
//   32 rows; each such row of J read in one coalesced load, its entries
//   passed by shuffle, the next row loaded while one is summed), adds M
//   (kept in shared memory from the start) and stores the row in shared
//   memory. The Cholesky runs in place,
//   left-looking, lane r on row r: at column j each lane's sum over its
//   row of L against row j is fed by loads alone, so it pipelines, where
//   a right-looking update would read and write shared memory in one
//   chain. The substitutions ride on shuffles. Rows of the shared tiles
//   sit at an odd stride, so a warp's lanes hit distinct banks.
// - NP, the padded nv, is 32 x the slots a lane holds of an nv-vector:
//   32 (hand23's 23 and every nv <= 32) or 64 (legs80's 34, every
//   nv <= 64). Every loop over columns and rows runs to the env's own nv
//   and R, so the padding costs idle lanes, not trips. nv > 64 stays on
//   the graph path (engine/solver.py).
// Correctly rounded sqrt and IEEE division, FFMA contraction, no fast math
// and no tensor cores: the card tests hold it to the eager loop.
#include <cmath>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarps = 4;                  // envs per block, at most
constexpr int kBlock = 2;  // iterations between two exit tests (solver._BLOCK)
constexpr size_t kMaxShared = 232448;      // a block's shared memory (H100)

template <typename T>
struct Floor;  // a Cholesky pivot's floor
template <>
struct Floor<float> {
  static constexpr float value = 1e-30f;
};
template <>
struct Floor<double> {
  static constexpr double value = 2.2250738585072014e-308;
};

// One launch's problem: inputs [B, ...] contiguous, eq [R] (eq_stride 0) or
// [B, R] (eq_stride R), rows a scratch [B, 2, R] or null where each
// env's rows fit in shared memory.
template <typename T>
struct Problem {
  const T* qM;
  const T* x0;
  const T* ws;
  const T* J;
  const T* aref;
  const T* D;
  const unsigned char* eq;
  long eq_stride;
  T* qacc;
  T* force;
  int* iters;
  T* rows;
  long batch;
  int R;
  int nv;
  int iterations;
  int ls_iterations;
  T tol;
  T ls_tol;
  bool rows_shared;  // each warp keeps its rows in shared memory
};

// Shared memory of one warp: in T, M and H at an odd row stride, 1 / L_jj,
// an nv-vector that every lane reads and, with `rows`, the rows' jar, J p
// and D; after every warp's T, with `rows`, its rows' equality flags.
__host__ __device__ inline long warp_floats(int n, int R, bool rows) {
  return 2L * n * (n | 1) + 2L * n + (rows ? 3L * R : 0L);
}
__host__ __device__ inline long warp_flags(int R, bool rows) {
  return rows ? (R + 15L) / 16 * 16 : 0L;
}
// Whether one env's rows fit in a block's shared memory beside its tiles.
inline bool rows_fit(int nv, int R, size_t size) {
  return warp_floats(nv, R, true) * size + warp_flags(R, true) <= kMaxShared;
}

// Columns of H that a lane sums in registers at a time: all of them below
// 32, 16 at a time above (a chunk never straddles two slots).
template <int RP>
constexpr int kCols = RP == 1 ? 32 : 16;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// 1 / x correctly rounded, as IEEE division gives it
__device__ __forceinline__ float reciprocal(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double reciprocal(double x) {
  return __drcp_rn(x);
}

// as torch.clamp(x, min=m): NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T m) {
  return x < m ? m : x;
}

// part[k]: this lane's share of row k's sum (k < 32). Returns the warp's
// sum of row `lane` on lane `lane`: at offset o a lane keeps the rows
// whose bit o matches its own and sends its partner the others.
template <typename T>
__device__ __forceinline__ T transpose_sum(T (&part)[32], int lane) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int k = 0; k < o; ++k) {
      const T send = upper ? part[k] : part[k + o];
      const T keep = upper ? part[k + o] : part[k];
      part[k] = keep + __shfl_xor_sync(kFullMask, send, o);
    }
  }
  return part[0];
}

// One env on one warp. Lane l holds entries l + 32 p (p < RP) of each
// nv-vector and rows 32 k + l of each R-vector.
template <typename T, int RP>
struct Env {
  const T* __restrict__ M;
  const T* __restrict__ J;
  const T* __restrict__ aref;
  const T* D;              // [R], in shared memory or the input's
  const unsigned char* eq;  // [R], as D
  T* jar;  // [R], in shared memory, or in the scratch past it
  T* jp;   // [R]
  T* Ms;   // shared: M [n][ld]
  T* Hs;   // shared: H, then its factor L [n][ld]
  T* inv;  // shared: 1 / L_jj [n]
  T* vs;   // shared: a vector every lane reads [n]
  int n, R, ld, lane;

  __device__ bool has(int p) const { return lane + 32 * p < n; }

  __device__ T weight(int i, T j) const {
    return (eq[i] || j < T(0)) ? D[i] : T(0);
  }

  // entry j of a vector, from the lane that holds it
  __device__ T entry(const T (&v)[RP], int j) const {
    T x = v[0];
#pragma unroll
    for (int p = 1; p < RP; ++p) x = (j >> 5) == p ? v[p] : x;
    return __shfl_sync(kFullMask, x, j & 31);
  }

  __device__ T dot(const T (&a)[RP], const T (&b)[RP]) const {
    T s = T(0);
#pragma unroll
    for (int p = 0; p < RP; ++p) s = fma(a[p], b[p], s);
    return warp_sum(s);
  }

  // out = A v for a shared [n][ld] tile A: v goes to shared memory, and
  // lane r sums its row against it
  __device__ void mat_vec(const T* A, const T (&v)[RP], T (&out)[RP]) const {
    __syncwarp();  // the last readers of vs are done
#pragma unroll
    for (int p = 0; p < RP; ++p) {
      if (has(p)) vs[lane + 32 * p] = v[p];
    }
    __syncwarp();
#pragma unroll
    for (int p = 0; p < RP; ++p) {
      T s = T(0);
      if (has(p)) {
        const T* __restrict__ a = A + (lane + 32 * p) * ld;
        const T* __restrict__ x = vs;
#pragma unroll 4
        for (int c = 0; c < n; ++c) s = fma(a[c], x[c], s);
      }
      out[p] = s;
    }
  }

  // (J v)_i for i = i0 + lane (0 past R), v held as a vector. Every load
  // is made, from a clamped row and column, so that all 32 rows' loads
  // are in flight at once; the clamped ones are multiplied by 0.
  __device__ T rows_dot(const T (&v)[RP], int i0) const {
    T part[32];
    const int last = R - 1 - i0;  // rows k > last lie past R
    int col[RP];
#pragma unroll
    for (int p = 0; p < RP; ++p) {
      col[p] = has(p) ? lane + 32 * p : n - 1;
    }
    const T* Ji = J + static_cast<long>(i0) * n;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const T* Jk = Ji + (k < last ? k : last) * n;
      T s = T(0);
#pragma unroll
      for (int p = 0; p < RP; ++p) {
        s = fma(Jk[col[p]], k <= last && has(p) ? v[p] : T(0), s);
      }
      part[k] = s;
    }
    return transpose_sum(part, lane);
  }

  // row k of J by lanes: out[p] = J_kc for c = lane + 32 p, 0 past nv
  __device__ void row_of_J(int k, T (&out)[RP]) const {
    const T* Jk = J + static_cast<long>(k) * n;
#pragma unroll
    for (int p = 0; p < RP; ++p) out[p] = has(p) ? Jk[lane + 32 * p] : T(0);
  }

  // cost(q) = 0.5 (dx . M dx + sum_i w_i jar_i^2), dx = q - x0 and
  // jar = J q - aref, of both starts q = ws and q = x0 in one pass over J
  // (each chunk of rows read twice, the second time from L1): writes each
  // one's M dx and cost, ws's jar to jar and x0's to jp
  __device__ void start_costs(const T (&ws)[RP], const T (&x0)[RP],
                              T (&Mw)[RP], T (&Mx)[RP], T& cw, T& cx) const {
    T dw[RP], dx[RP];
#pragma unroll
    for (int p = 0; p < RP; ++p) {
      dw[p] = ws[p] - x0[p];
      dx[p] = x0[p] - x0[p];
    }
    mat_vec(Ms, dw, Mw);
    mat_vec(Ms, dx, Mx);
    const T quad_w = dot(dw, Mw);
    const T quad_x = dot(dx, Mx);
    T sw = T(0), sx = T(0);
    for (int i0 = 0; i0 < R; i0 += 32) {
      const T jw = rows_dot(ws, i0);
      const T jx = rows_dot(x0, i0);
      const int i = i0 + lane;
      if (i < R) {
        const T a = jw - aref[i];
        const T b = jx - aref[i];
        jar[i] = a;
        jp[i] = b;
        sw = fma(weight(i, a) * a, a, sw);
        sx = fma(weight(i, b) * b, b, sx);
      }
    }
    cw = T(0.5) * (quad_w + warp_sum(sw));
    cx = T(0.5) * (quad_x + warp_sum(sx));
  }

  // (phi'(a), phi''(a)) of the line search along p
  __device__ void dphi(T a, T pmx, T pmp, T& d, T& dd) const {
    T s1 = T(0), s2 = T(0);
    for (int i = lane; i < R; i += 32) {
      const T jpi = jp[i];
      const T ja = fma(a, jpi, jar[i]);
      const T wjp = weight(i, ja) * jpi;
      s1 = fma(wjp, ja, s1);
      s2 = fma(wjp, jpi, s2);
    }
    d = fma(a, pmp, pmx) + warp_sum(s1);
    dd = pmp + warp_sum(s2);
  }

  // One Newton iteration on the carry (q, M dx, cost; jar with the
  // rows). Returns the improvement; the carry moves only where the cost
  // fell.
  __device__ T iterate(T (&q)[RP], T (&Mdx)[RP], const T (&x0)[RP], T& cost,
                       int ls_iterations, T ls_tol) {
    // grad and H = M + J^T diag(w) J over the rows in force (a ballot
    // per 32 rows): lane r sums row r of H in registers, kCols<RP>
    // columns at a time. Row k of J comes in one coalesced load a slot,
    // lane c taking J_kc, which is J_kr for its own row r = c; the J_kc
    // it pairs them with come by shuffle. The next row in force is
    // loaded while this one is summed.
    constexpr int C = kCols<RP>;
    T g[RP];
#pragma unroll
    for (int p = 0; p < RP; ++p) g[p] = T(0);
    __syncwarp();  // the last iteration's substitutions read other rows
    for (int c0 = 0; c0 < n; c0 += C) {
      T acc[RP][C];
#pragma unroll
      for (int p = 0; p < RP; ++p) {
#pragma unroll
        for (int q = 0; q < C; ++q) acc[p][q] = T(0);
      }
      for (int i0 = 0; i0 < R; i0 += 32) {
        const int i = i0 + lane;
        T w = T(0), wj = T(0);
        if (i < R) {
          const T j = jar[i];
          w = weight(i, j);
          wj = w * j;
        }
        unsigned live = __ballot_sync(kFullMask, w != T(0));
        T next[RP];
        if (live) row_of_J(i0 + __ffs(live) - 1, next);
        while (live) {
          const int k = __ffs(live) - 1;
          live &= live - 1;
          T a[RP];
#pragma unroll
          for (int p = 0; p < RP; ++p) a[p] = next[p];
          if (live) row_of_J(i0 + __ffs(live) - 1, next);
          const T wk = __shfl_sync(kFullMask, w, k);
          const T wjk = __shfl_sync(kFullMask, wj, k);
          T src = a[0];  // the slot that holds columns c0 ..
#pragma unroll
          for (int p = 1; p < RP; ++p) src = (c0 >> 5) == p ? a[p] : src;
#pragma unroll
          for (int p = 0; p < RP; ++p) {
            if (c0 == 0) g[p] = fma(a[p], wjk, g[p]);
            a[p] *= wk;
          }
#pragma unroll
          for (int q = 0; q < C; ++q) {
            const T b = __shfl_sync(kFullMask, src, (c0 + q) & 31);
#pragma unroll
            for (int p = 0; p < RP; ++p) acc[p][q] = fma(a[p], b, acc[p][q]);
          }
        }
      }
#pragma unroll
      for (int p = 0; p < RP; ++p) {
        if (!has(p)) continue;
        const int r = lane + 32 * p;
#pragma unroll
        for (int q = 0; q < C; ++q) {
          const int c = c0 + q;
          if (c < n) Hs[r * ld + c] = Ms[r * ld + c] + acc[p][q];
        }
      }
    }
#pragma unroll
    for (int p = 0; p < RP; ++p) g[p] = Mdx[p] + g[p];
    __syncwarp();

    // Cholesky, left-looking: at column j lane r >= j sums its row of L
    // against row j, lane j's sum gives the pivot, and lanes below write
    // L_rj over H_rj. Only loads feed the sums, so they pipeline.
    for (int j = 0; j < n; ++j) {
      T s[RP];
#pragma unroll
      for (int p = 0; p < RP; ++p) {
        const int r = lane + 32 * p;
        T acc = T(0);
        if (r >= j && r < n) {
          const T* __restrict__ hr = Hs + r * ld;
          const T* __restrict__ hj = Hs + j * ld;
#pragma unroll 4
          for (int k = 0; k < j; ++k) acc = fma(hr[k], hj[k], acc);
        }
        s[p] = acc;
      }
      const T d = sqrt(fmax(Hs[j * ld + j] - entry(s, j), Floor<T>::value));
      const T dinv = reciprocal(d);
#pragma unroll
      for (int p = 0; p < RP; ++p) {
        const int r = lane + 32 * p;
        if (r > j && r < n) Hs[r * ld + j] = (Hs[r * ld + j] - s[p]) * dinv;
      }
      if (lane == 0) inv[j] = dinv;
      __syncwarp();
    }
    // L y = grad, then L^T x = y; p = -x
    T v[RP];
#pragma unroll
    for (int p = 0; p < RP; ++p) v[p] = g[p];
    for (int j = 0; j < n; ++j) {
      const T yj = entry(v, j) * inv[j];
#pragma unroll
      for (int p = 0; p < RP; ++p) {
        const int r = lane + 32 * p;
        if (r > j && r < n) v[p] = fma(-Hs[r * ld + j], yj, v[p]);
        if (r == j) v[p] = yj;
      }
    }
    for (int i = n - 1; i >= 0; --i) {
      const T xi = entry(v, i) * inv[i];
#pragma unroll
      for (int p = 0; p < RP; ++p) {
        const int r = lane + 32 * p;
        if (r < i) v[p] = fma(-Hs[i * ld + r], xi, v[p]);
        if (r == i) v[p] = xi;
      }
    }
    T pv[RP], mp[RP];
#pragma unroll
    for (int p = 0; p < RP; ++p) pv[p] = -v[p];
    mat_vec(Ms, pv, mp);

    // line search along p: J p into the scratch, with phi'(0), phi''(0)
    const T pmx = dot(pv, Mdx);
    const T pmp = clamp_min(dot(pv, mp), T(1e-15));
    T s1 = T(0), s2 = T(0);
    for (int i0 = 0; i0 < R; i0 += 32) {
      const T jpi = rows_dot(pv, i0);
      const int i = i0 + lane;
      if (i < R) {
        jp[i] = jpi;
        const T j = jar[i];
        const T wjp = weight(i, j) * jpi;
        s1 = fma(wjp, j, s1);
        s2 = fma(wjp, jpi, s2);
      }
    }
    const T d0 = fma(T(0), pmp, pmx) + warp_sum(s1);
    const T dd0 = pmp + warp_sum(s2);
    const T a0 = clamp_min(-d0 / dd0, T(1e-10));
    T df0, ddf0;
    dphi(a0, pmx, pmp, df0, ddf0);
    // bracket [lo, hi] with phi'(lo) <= 0 <= phi'(hi), growing hi by 16x
    T hi = a0, dfh = df0, unused;
    for (int t = 0; t < 4 && dfh < T(0); ++t) {
      hi *= T(16);
      dphi(hi, pmx, pmp, dfh, unused);
    }
    T lo = df0 < T(0) ? a0 : T(0);
    hi = df0 < T(0) ? hi : a0;
    // safeguarded 1D Newton on phi' (piecewise linear), bisection fallback
    T alpha = a0, df = df0, ddf = ddf0;
    const int trips = ls_iterations < 6 ? ls_iterations : 6;
    for (int t = 0; t < trips && fabs(df) > ls_tol * pmp; ++t) {
      const T step = alpha - df / clamp_min(ddf, T(1e-15));
      const T mid = T(0.5) * (lo + hi);
      const T nxt = (step > lo && step < hi) ? step : mid;
      T dfn, ddfn;
      dphi(nxt, pmx, pmp, dfn, ddfn);
      ddf = ddfn;
      if (dfn < T(0)) lo = nxt;
      if (dfn >= T(0)) hi = nxt;
      alpha = nxt;
      df = dfn;
    }
    if (!(dot(g, pv) < T(-1e-16))) alpha = T(0);

    // the step and its cost
    T qn[RP], Mn[RP], dx[RP];
#pragma unroll
    for (int p = 0; p < RP; ++p) {
      qn[p] = fma(alpha, pv[p], q[p]);
      Mn[p] = fma(alpha, mp[p], Mdx[p]);
      dx[p] = qn[p] - x0[p];
    }
    const T quad = dot(dx, Mn);
    T s = T(0);
    for (int i = lane; i < R; i += 32) {
      const T j = fma(alpha, jp[i], jar[i]);
      s = fma(weight(i, j) * j, j, s);
    }
    const T next = T(0.5) * (quad + warp_sum(s));
    const T improvement = cost - next;
    if (improvement > T(0)) {
#pragma unroll
      for (int p = 0; p < RP; ++p) {
        q[p] = qn[p];
        Mdx[p] = Mn[p];
      }
      cost = next;
      for (int i = lane; i < R; i += 32) jar[i] = fma(alpha, jp[i], jar[i]);
    }
    return improvement;
  }
};

// At most 128 registers a thread, so that 4 blocks of 4 envs fit an SM:
// each warp's chain is latency-bound, and more warps in flight hide more
// of it than registers kept to spare a few spills would.
template <typename T, int RP>
__global__ void __launch_bounds__(kWarps * 32, 4)
    newton_solve_kernel(const Problem<T> pr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long b = static_cast<long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (b >= pr.batch) return;  // the whole warp
  const int n = pr.nv;
  const int R = pr.R;
  Env<T, RP> e;
  e.M = pr.qM + b * n * n;
  e.J = pr.J + b * R * n;
  e.aref = pr.aref + b * R;
  const int warps = blockDim.x >> 5;
  e.n = n;
  e.R = R;
  e.ld = n | 1;
  e.lane = lane;
  e.Ms = reinterpret_cast<T*>(smem_raw) +
         warp * warp_floats(n, R, pr.rows_shared);
  e.Hs = e.Ms + n * e.ld;
  e.inv = e.Hs + n * e.ld;
  e.vs = e.inv + n;
  if (pr.rows_shared) {  // the rows' state and constants: lane-private
    e.jar = e.vs + n;
    e.jp = e.jar + R;
    T* D = e.jp + R;
    unsigned char* eq = smem_raw +
                        warps * warp_floats(n, R, true) * sizeof(T) +
                        warp * warp_flags(R, true);
    for (int i = lane; i < R; i += 32) {
      D[i] = pr.D[b * R + i];
      eq[i] = pr.eq[b * pr.eq_stride + i];
    }
    e.D = D;
    e.eq = eq;
  } else {  // rows past shared memory: the scratch and the inputs
    e.jar = pr.rows + b * 2 * R;
    e.jp = e.jar + R;
    e.D = pr.D + b * R;
    e.eq = pr.eq + b * pr.eq_stride;
  }
  for (int k = lane; k < n * n; k += 32) e.Ms[(k / n) * e.ld + k % n] = e.M[k];
  __syncwarp();

  T x0[RP], ws[RP], q[RP], Mdx[RP], Mx[RP], cost, cost_x0;
#pragma unroll
  for (int p = 0; p < RP; ++p) {
    const int c = lane + 32 * p;
    x0[p] = e.has(p) ? pr.x0[b * n + c] : T(0);
    ws[p] = e.has(p) ? pr.ws[b * n + c] : T(0);
  }
  // warm start: the cheaper of ws and x0 (x0 where the costs do not compare)
  e.start_costs(ws, x0, Mdx, Mx, cost, cost_x0);
  if (cost < cost_x0) {
#pragma unroll
    for (int p = 0; p < RP; ++p) q[p] = ws[p];
  } else {
#pragma unroll
    for (int p = 0; p < RP; ++p) {
      q[p] = x0[p];
      Mdx[p] = Mx[p];
    }
    cost = cost_x0;
    for (int i = lane; i < R; i += 32) e.jar[i] = e.jp[i];
  }
  T improvement = static_cast<T>(INFINITY);
  int it = 0;
  while (it < pr.iterations && improvement > pr.tol) {
    for (int t = 0; t < kBlock; ++t) {
      improvement = e.iterate(q, Mdx, x0, cost, pr.ls_iterations, pr.ls_tol);
      ++it;
    }
  }

#pragma unroll
  for (int p = 0; p < RP; ++p) {
    if (e.has(p)) pr.qacc[b * n + lane + 32 * p] = q[p];
  }
  for (int i = lane; i < R; i += 32) {
    const T j = e.jar[i];
    pr.force[b * R + i] = -e.weight(i, j) * j;
  }
  if (lane == 0) pr.iters[b] = it;
}

template <typename T, int RP>
int launch(Problem<T> pr, cudaStream_t stream) {
  // the most envs a block (up to kWarps) whose shared memory fits, the
  // rows in shared memory if one env's fit there
  const auto bytes = [&](int warps, bool rows) {
    return warps * (warp_floats(pr.nv, pr.R, rows) * sizeof(T) +
                    warp_flags(pr.R, rows));
  };
  pr.rows_shared = rows_fit(pr.nv, pr.R, sizeof(T));
  if (!pr.rows_shared && pr.rows == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int warps = kWarps;
  while (warps > 1 && bytes(warps, pr.rows_shared) > kMaxShared) --warps;
  const size_t smem = bytes(warps, pr.rows_shared);
  if (smem > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        newton_solve_kernel<T, RP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long blocks = (pr.batch + warps - 1) / warps;
  newton_solve_kernel<T, RP>
      <<<static_cast<unsigned>(blocks), warps * 32, smem, stream>>>(pr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int solve(const T* qM, const T* x0, const T* ws, const T* J, const T* aref,
          const T* D, const unsigned char* eq, int eq_stride, T* qacc,
          T* force, int* iters, T* rows, int batch, int R, int nv,
          int iterations, int ls_iterations, double tol, double ls_tol,
          void* stream) {
  if (batch <= 0 || R < 0 || nv <= 0 || nv > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Problem<T> pr{qM,    x0,    ws,         J,          aref,
                      D,     eq,    eq_stride,  qacc,       force,
                      iters, rows,  batch,      R,          nv,
                      iterations, ls_iterations,
                      static_cast<T>(tol), static_cast<T>(ls_tol), false};
  const auto st = static_cast<cudaStream_t>(stream);
  return nv <= 32 ? launch<T, 1>(pr, st) : launch<T, 2>(pr, st);
}

}  // namespace

// C interface for ctypes. qM [batch, nv, nv]; x0 (qacc_smooth), ws (the
// warm start) and qacc [batch, nv]; J [batch, R, nv]; aref, D and force
// [batch, R]; eq one byte a row, [R] (eq_stride 0) or [batch, R] (eq_stride
// R); iters [batch] int32; rows a scratch [batch, 2, R], or null where
// newton_solve_needs_scratch says 0; all contiguous on the current device.
// Launches on `stream` and returns the cudaError_t of the launch (0 on
// success); does not synchronise.
extern "C" int newton_solve_f32(const float* qM, const float* x0,
                                const float* ws, const float* J,
                                const float* aref, const float* D,
                                const unsigned char* eq, int eq_stride,
                                float* qacc, float* force, int* iters,
                                float* rows, int batch, int R, int nv,
                                int iterations, int ls_iterations,
                                double tol, double ls_tol, void* stream) {
  return solve<float>(qM, x0, ws, J, aref, D, eq, eq_stride, qacc, force,
                      iters, rows, batch, R, nv, iterations, ls_iterations,
                      tol, ls_tol, stream);
}

extern "C" int newton_solve_f64(const double* qM, const double* x0,
                                const double* ws, const double* J,
                                const double* aref, const double* D,
                                const unsigned char* eq, int eq_stride,
                                double* qacc, double* force, int* iters,
                                double* rows, int batch, int R, int nv,
                                int iterations, int ls_iterations,
                                double tol, double ls_tol, void* stream) {
  return solve<double>(qM, x0, ws, J, aref, D, eq, eq_stride, qacc, force,
                       iters, rows, batch, R, nv, iterations, ls_iterations,
                       tol, ls_tol, stream);
}

// 1 where one env's rows at [R, nv] do not fit in shared memory, so the
// launch needs the scratch; 0 where they fit (elem_size 4 or 8).
extern "C" int newton_solve_needs_scratch(int R, int nv, int elem_size) {
  return rows_fit(nv, R, static_cast<size_t>(elem_size)) ? 0 : 1;
}
