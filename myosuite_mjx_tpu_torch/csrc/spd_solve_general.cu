// Batched SPD solve A[s] x[s] = b[s] for Hopper (sm_90a): every system the
// register kernel (spd_solve.cu) does not take, i.e. float64 at any n and
// float32 with n > 64.
//
// What it replaces: the reference sends a batch to the Pallas kernel
// (myosuite_mjx_tpu/ops/pallas_linalg.py:77 spd_solve_batched) only inside
// use_pallas's gate (float32, 4 <= n <= 64, pallas_linalg.py:111-121); every
// other solve of the same call, myosuite_mjx_tpu/ops/linalg.py:93-104
// _spd_solve_vmap, takes the unrolled chol_factor + cho_solve
// (linalg.py:19-73). This kernel computes exactly that route: a right-looking
// Cholesky with the pivot clamped at finfo(dtype).tiny (FLT_MIN / DBL_MIN,
// not the register kernel's 1e-30; a NaN pivot stays NaN), column j divided
// by d = sqrt(max(a_jj, tiny)) on and below the diagonal (so L_jj = a_jj / d,
// as chol_factor), then forward and back substitution. The engine reaches it
// through ops/linalg.spd_solve when it runs in float64 on the card or on a
// model with nv > 64.
//
// What bounds it on this card: the bytes, A and b read and x written once
// (8n^2 + 16n bytes per system in float64), against 2n^3/3 + 2n^2 flops per
// system at 34 TFLOP/s in float64 or 67 in float32: bytes bound it up to
// n ~ 100 in float64. Above that bound, one system's dependent chain (a
// square root and two divisions per column) and, for large n, the trailing
// update's shared-memory traffic set the pace.
//
// Design: three routes, chosen in `launch` by type and n.
// (a) reg_kernel, float64 with n <= 64: the register kernel's structure in
//     doubles. NP (8, 16, 24, 32, 48, 64) is the padded size, a template
//     parameter, so loops unroll and register indices are static; rows and
//     columns n..NP-1 are the identity. A group of G lanes solves one system,
//     lane l holding rows l, l + G, ...; slot p keeps only the columns its
//     rows can reach (0 .. G(p+1)-1), so a lane holds NP^2/2G + NP/2 doubles:
//     G = 8 up to NP 24, 16 at 32 and 48, 32 at 64 keep that at or below 96.
//     The pivot and l_kj come by __shfl_sync (width G), no shared memory and
//     no barrier in the factor; the forward substitution rides along with
//     column j (a padded row's y is 0, so an infinite y cannot reach the real
//     rows through the padding). Each warp loads its systems with one bulk
//     copy (cp.async.bulk) on its own mbarrier when they are whole and
//     16-byte aligned, with plain loads otherwise (a misaligned view, the
//     ragged end). The factor is then staged over the same shared memory
//     (rows at the odd stride NP + 1; systems at a stride of G modulo the
//     elements a bank cycle holds) and read transposed by the back
//     substitution, whose reads are conflict-free.
// (b) tile_kernel, float32 at any n and float64 with n > 64, while the
//     system fits the opt-in shared memory: W warps per system and S
//     systems per block, chosen from the card's occupancy; the tile
//     [n + 1][ld] in shared memory with an odd row stride ld > n (column
//     reads conflict-free), b as its row n, copied in with cp.async. A
//     blocked right-looking factor, panels of P = 32 bytes of columns (8
//     floats, 4 doubles). In a panel, per column: every thread reads the
//     pivot; threads own rows and update the panel's later columns of
//     their rows (row n with y_j = v_j / L_jj: the forward substitution);
//     column j is scaled in place one column later, when nobody reads it,
//     and 1 / L_jj is kept in column n. Then the trailing triangle takes
//     the panel's P rank-1 updates at once: lanes own columns and hold
//     their l_kp in registers, the warps split the rows in runs of four,
//     each element read and written once per panel instead of once per
//     column (no index division, no thread with a discarded pair). Every
//     barrier covers the system's threads only: __syncwarp at W = 1, a
//     named barrier otherwise; one per column and two per panel. The back
//     substitution runs on the system's first warp, x in registers, with
//     no division in its chain.
// (c) inplace_kernel, above the shared-memory limit: one block per system,
//     working in place in the L output, which the wrapper always allocates,
//     two barriers per column.
// Every launch is on the caller's stream, allocates nothing and never
// synchronises the host, so it can be captured in a CUDA graph; a kernel's
// dynamic shared memory limit is raised once, where a route needs more
// than 48 KB. Correctly rounded sqrt and IEEE division (no fast math);
// L_ij is a_ij times 1/d, and y and x use 1/L_jj, each reciprocal an IEEE
// division.
#include <cfloat>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kDefaultSharedLimit = 48 * 1024;

template <typename T>
__device__ __forceinline__ T tiny_of();
template <>
__device__ __forceinline__ float tiny_of<float>() {
  return FLT_MIN;
}
template <>
__device__ __forceinline__ double tiny_of<double>() {
  return DBL_MIN;
}

// sqrt(max(piv, tiny)) with a NaN pivot kept NaN (fmax would drop it)
template <typename T>
__device__ __forceinline__ T clamped_sqrt(T piv) {
  const T tiny = tiny_of<T>();
  return sqrt(piv < tiny ? tiny : piv);
}

// ---- PTX helpers: mbarrier, bulk copy, cp.async, named barrier ----

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(d),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait_parity0(uint32_t bar) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  } while (!done);
}

// one element from device memory to shared memory, asynchronously
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// barrier over `threads` threads (whole warps) under barrier id `id`
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- route (a): float64, n <= 64, systems in registers ----

// Lanes per system and systems per block, by padded size.
template <int NP>
constexpr int kRegGroup = NP <= 24 ? 8 : (NP <= 48 ? 16 : 32);
template <int NP>
constexpr int kRegSystems = NP <= 24 ? 8 : (NP <= 48 ? 4 : 2);

// Elements between the staged factors of two systems: at least NP (NP + 1)
// and G modulo the elements one pass over the 32 banks holds, so that the
// lanes of the systems that share a pass hit distinct banks.
template <typename T, int NP, int G>
__host__ __device__ constexpr int stage_stride() {
  constexpr int per_pass = 128 / static_cast<int>(sizeof(T));
  int t = NP * (NP + 1);
  while (t % per_pass != G % per_pass) ++t;
  return t;
}

template <int NP, int G, int SB>
__global__ void __launch_bounds__(SB * G)
    reg_kernel(const double* __restrict__ a, const double* __restrict__ b,
               double* __restrict__ x, double* __restrict__ l, long batch,
               int n, int store_l) {
  constexpr int SPW = 32 / G;               // systems per warp
  constexpr int RP = NP / G;                // rows per lane
  constexpr int LD = NP + 1;                // odd row stride of a staged L
  constexpr int TS = stage_stride<double, NP, G>();
  constexpr int kTrips = (NP * NP + G - 1) / G;  // group passes over n*n
  static_assert(NP % G == 0 && (SB * G) % 32 == 0, "whole rows and warps");
  static_assert((SPW * TS * sizeof(double)) % 16 == 0, "aligned warp areas");
  // per warp SPW * TS doubles: its systems' A as in device memory (SPW * n^2
  // <= SPW * TS), then, once A is in registers, its staged factors
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t loaded[SB / SPW];  // an mbarrier a warp

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gl = lane % G;                  // lane within the system's group
  const int ws = lane / G;                  // system within the warp
  const int nn = n * n;
  const long s0 = static_cast<long>(blockIdx.x) * SB + warp * SPW;
  if (s0 >= batch) return;  // a warp with no system (ragged last block)
  const int count = batch - s0 < SPW ? static_cast<int>(batch - s0) : SPW;
  const bool live_sys = ws < count;
  const long s = s0 + ws;
  double* area = reinterpret_cast<double*>(smem_raw) + warp * SPW * TS;
  const double* aw = a + s0 * nn;
  const uint32_t bytes = static_cast<uint32_t>(count * nn) * sizeof(double);
  const bool bulk = count == SPW && bytes % 16 == 0 &&
                    (reinterpret_cast<uintptr_t>(aw) & 15) == 0;
  const uint32_t bar =
      static_cast<uint32_t>(__cvta_generic_to_shared(&loaded[warp]));

  if (bulk) {  // warp-uniform
    if (lane == 0) mbar_init(bar);
    __syncwarp();
    if (lane == 0) bulk_copy(area, aw, bytes, bar);
  } else {  // the warp copies its live systems, contiguous in a
    const int m = count * nn;
#pragma unroll 4
    for (int e = lane; e < m; e += 32) area[e] = aw[e];
  }
  double v[RP];  // right-hand side, then spoilt (y is kept apart)
#pragma unroll
  for (int p = 0; p < RP; ++p) {
    const int row = gl + G * p;
    v[p] = live_sys && row < n ? b[s * n + row] : 0.0;
  }
  if (bulk) {
    mbar_wait_parity0(bar);
  } else {
    __syncwarp();
  }

  // rows into registers (rows and columns n..NP-1: identity); the row index
  // is clamped so that every read stays inside the warp's area. Slot p
  // holds rows G*p .. G*p + G-1, so only columns below G*(p+1) are kept.
  const double* tile = area + ws * nn;
  double r[RP][NP];
#pragma unroll
  for (int p = 0; p < RP; ++p) {
    const int row = gl + G * p;
    const bool live = row < n;
    const int ncols = live ? n : 0;
    const double* src = tile + (live ? row : n - 1) * n;
#pragma unroll
    for (int c = 0; c < NP; ++c) {
      if (c >= G * (p + 1)) {
        r[p][c] = 0.0;  // above every row of the slot: never read
        continue;
      }
      const double pad = c == row ? 1.0 : 0.0;
      r[p][c] = c < ncols ? src[c] : pad;
    }
  }

  // right-looking Cholesky in registers: L overwrites the lower triangle.
  // Row k lives on lane k % G of the group, in slot k / G. Column j is
  // scaled by 1/d, its diagonal too (L_jj = a_jj / d); the forward
  // substitution L y = b rides along: y_j = v_j / L_jj goes out with
  // column j. Rows above j take the same arithmetic on entries above their
  // diagonal, which nothing reads.
  double inv[RP];  // 1 / L_ii of the lane's own rows
  double y[RP];
#pragma unroll
  for (int p = 0; p < RP; ++p) inv[p] = 1.0, y[p] = 0.0;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const double piv = __shfl_sync(kFullMask, r[j / G][j], j % G, G);
    const double dinv = 1.0 / clamped_sqrt(piv);
    const double linv = 1.0 / (piv * dinv);
    double yj = __shfl_sync(kFullMask, v[j / G] * linv, j % G, G);
    yj = j < n ? yj : 0.0;
    if (gl == j % G) {
      inv[j / G] = linv;
      y[j / G] = yj;
    }
#pragma unroll
    for (int p = 0; p < RP; ++p) {
      if (G * p + G - 1 < j) continue;  // every row of this slot is above j
      r[p][j] *= dinv;
      v[p] -= r[p][j] * yj;
    }
#pragma unroll
    for (int k = j + 1; k < NP; ++k) {
      const double lkj = __shfl_sync(kFullMask, r[k / G][j], k % G, G);
#pragma unroll
      for (int p = 0; p < RP; ++p) {
        if (G * p + G - 1 < k) continue;  // no row of this slot reaches k
        r[p][k] -= r[p][j] * lkj;
      }
    }
  }

  // stage the factor (each slot's columns) over the area, once every lane
  // of the warp has read its A
  __syncwarp();
  double* T = area + ws * TS;
#pragma unroll
  for (int p = 0; p < RP; ++p) {
    const int row = gl + G * p;
#pragma unroll
    for (int c = 0; c < G * (p + 1); ++c) T[row * LD + c] = r[p][c];
  }
  __syncwarp();

  // back substitution L^T x = y: x_i = v_i / L_ii goes out from its lane,
  // then every row k < i takes v_k -= L_ik x_i, L_ik read transposed
#pragma unroll
  for (int p = 0; p < RP; ++p) v[p] = y[p];
#pragma unroll
  for (int i = NP - 1; i >= 0; --i) {
    const double xi =
        __shfl_sync(kFullMask, v[i / G] * inv[i / G], i % G, G);
    if (gl == i % G) y[i / G] = xi;  // y now holds x
#pragma unroll
    for (int p = 0; p < RP; ++p) {
      if (G * p >= i) continue;  // no row of this slot is above i
      const int row = gl + G * p;
      const double upd = v[p] - T[i * LD + row] * xi;
      v[p] = row < i ? upd : v[p];
    }
  }

  if (!live_sys) return;
#pragma unroll
  for (int p = 0; p < RP; ++p) {
    const int row = gl + G * p;
    if (row < n) x[s * n + row] = y[p];
  }
  if (store_l) {  // element e = i*n + c of the factor, zero above i
    double* ls = l + s * nn;
    const int di = G / n;
    const int dc = G - di * n;
    int i = gl / n;
    int c = gl - i * n;
#pragma unroll
    for (int t = 0; t < kTrips; ++t) {
      const int e = gl + G * t;
      if (e < nn) ls[e] = c <= i ? T[i * LD + c] : 0.0;
      i += di;
      c += dc;
      if (c >= n) {
        c -= n;
        ++i;
      }
    }
  }
}

// ---- route (b): the tile in shared memory, W warps per system ----

constexpr int kTileSlots = 8;  // rows per lane in the back substitution:
                               // n <= 32 * kTileSlots
constexpr int kTileRows = 4;   // rows a warp updates together
constexpr int kTileChunk = 2;  // 32-column slots a lane updates together
constexpr int kTileMaxThreads = 256;

// odd and > n: column reads conflict-free, column n free for 1 / L_jj
__host__ __device__ inline int tile_ld(int n) { return (n + 1) | 1; }

template <typename T>
size_t tile_bytes(int n) {
  return static_cast<size_t>(n + 1) * tile_ld(n) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kTileMaxThreads)
    tile_kernel(const T* __restrict__ a, const T* __restrict__ b,
                T* __restrict__ x, T* __restrict__ l, long batch, int n,
                int warps, int systems, int store_l) {
  constexpr int U = kTileSlots;
  constexpr int R = kTileRows;
  constexpr int UC = kTileChunk;
  constexpr int P = 32 / sizeof(T);  // panel width: 8 floats, 4 doubles
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int W = warps;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sys = warp / W;       // system within the block
  const int w = warp - sys * W;   // warp within the system
  const int tid = w * 32 + lane;  // thread within the system
  const int nt = 32 * W;
  const long s = static_cast<long>(blockIdx.x) * systems + sys;
  if (s >= batch) return;  // the system's warps leave together
  const int ld = tile_ld(n);
  const long nn = static_cast<long>(n) * n;
  // [n + 1][ld]: rows 0..n-1 A, then L in the lower triangle (A's upper
  // triangle is never touched) and 1 / L_jj in column n; row n b, then y
  T* t = reinterpret_cast<T*>(smem_raw) +
         static_cast<size_t>(sys) * (n + 1) * ld;
  auto sync = [&]() {
    if (W == 1) {
      __syncwarp();
    } else {
      named_barrier(1 + sys, nt);
    }
  };

  const T* as = a + s * nn;
  for (int i = w; i < n; i += W)
    for (int c = lane; c < n; c += 32) cp_async(t + i * ld + c, as + i * n + c);
  for (int c = tid; c < n; c += nt) cp_async(t + n * ld + c, b + s * n + c);
  cp_async_wait_all();
  sync();

  // blocked right-looking factor, panels of P columns. In a panel, column
  // by column: every thread reads the pivot, thread 0 keeps 1 / L_jj in
  // column n, column j-1 (read no more) is scaled in place, and each
  // thread updates the panel's later columns of its rows i > j (row n with
  // y_j = v_j / L_jj: the forward substitution). Then the panel's last
  // column is scaled and the trailing triangle takes the panel's P rank-1
  // updates at once, from registers.
  for (int j0 = 0; j0 < n; j0 += P) {
    const int jend = min(j0 + P, n);
    T dinv = T(1), linv = T(1);
    for (int j = j0; j < jend; ++j) {
      sync();  // column j is final in rows > j
      if (j > j0) {  // column j-1: L, and y_{j-1}
        for (int i = j - 1 + tid; i < n; i += nt) t[i * ld + j - 1] *= dinv;
        if (tid == 0) t[n * ld + j - 1] *= linv;
      }
      const T piv = t[j * ld + j];
      dinv = T(1) / clamped_sqrt(piv);
      linv = T(1) / (piv * dinv);
      if (tid == 0) t[j * ld + n] = linv;
      T lkp[P - 1];  // l_kj of the panel's rows k = j + 1 + c
#pragma unroll
      for (int c = 0; c < P - 1; ++c) {
        const int k = j + 1 + c;
        lkp[c] = k < jend ? t[k * ld + j] * dinv : T(0);
      }
      for (int i = j + 1 + tid; i <= n; i += nt) {  // rows, column j
        const T lij = t[i * ld + j] * (i < n ? dinv : linv);
        const int kend = i < n ? min(jend, i + 1) : jend;
#pragma unroll
        for (int c = 0; c < P - 1; ++c) {
          const int k = j + 1 + c;
          if (k < kend) t[i * ld + k] -= lij * lkp[c];
        }
      }
    }
    sync();
    for (int i = jend - 1 + tid; i < n; i += nt) t[i * ld + jend - 1] *= dinv;
    if (tid == 0) t[n * ld + jend - 1] *= linv;
    sync();
    // trailing rows i = jend..n, columns k = jend..min(i, n-1), in chunks of
    // 32 * UC columns (lane: k = k0 + lane + 32u); warp w takes the rows in
    // runs of R, every W-th run
    for (int k0 = jend; k0 < n; k0 += 32 * UC) {
      T lk[UC][P];  // the lane's columns' L_kp, p in the panel
#pragma unroll
      for (int u = 0; u < UC; ++u) {
        const int k = k0 + lane + 32 * u;
#pragma unroll
        for (int p = 0; p < P; ++p)
          lk[u][p] = k < n && j0 + p < jend ? t[k * ld + j0 + p] : T(0);
      }
      for (int i0 = k0 + R * w; i0 <= n; i0 += R * W) {
        T li[R][P];   // the rows' L_ip (row n: y_p)
        int last[R];  // the row's last column, -1 past row n
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int i = i0 + q;
          last[q] = i <= n ? min(i, n - 1) : -1;
#pragma unroll
          for (int p = 0; p < P; ++p)
            li[q][p] = i <= n && j0 + p < jend ? t[i * ld + j0 + p] : T(0);
        }
        const int span = min(i0 + R - 1, n - 1) - k0;  // columns k0..k0+span
#pragma unroll
        for (int u = 0; u < UC; ++u) {
          if (32 * u > span) break;  // warp-uniform
          const int k = k0 + lane + 32 * u;
          T acc[R];
#pragma unroll
          for (int q = 0; q < R; ++q)
            acc[q] = k <= last[q] ? t[(i0 + q) * ld + k] : T(0);
#pragma unroll
          for (int p = 0; p < P; ++p)
#pragma unroll
            for (int q = 0; q < R; ++q) acc[q] -= li[q][p] * lk[u][p];
#pragma unroll
          for (int q = 0; q < R; ++q)
            if (k <= last[q]) t[(i0 + q) * ld + k] = acc[q];
        }
      }
    }
  }
  sync();

  // back substitution L^T x = y on the first warp, lane l holding rows
  // l + 32u: x_i = v_i / L_ii (v_i from its lane, 1 / L_ii from column n),
  // rows k < i take v_k -= L_ik x_i from row i of L (contiguous:
  // conflict-free)
  if (w == 0) {
    T vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = lane + 32 * u;
      vr[u] = k < n ? t[n * ld + k] : T(0);
    }
    for (int i = n - 1; i >= 0; --i) {
      const int ui = i >> 5;
      T own = vr[0];
#pragma unroll
      for (int u = 1; u < U; ++u) own = u == ui ? vr[u] : own;
      const T xi = __shfl_sync(kFullMask, own, i & 31) * t[i * ld + n];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = lane + 32 * u;
        if (k < i) {
          vr[u] -= t[i * ld + k] * xi;
        } else if (k == i) {
          vr[u] = xi;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = lane + 32 * u;
      if (k < n) x[s * n + k] = vr[u];
    }
  }
  if (store_l) {  // the factor with its upper triangle zeroed
    T* ls = l + s * nn;
    for (int i = w; i < n; i += W)
      for (int c = lane; c < n; c += 32)
        ls[i * n + c] = c <= i ? t[i * ld + c] : T(0);
  }
}

// ---- route (c): above the shared-memory limit, in place in L ----

template <typename T>
__global__ void __launch_bounds__(256)
    inplace_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   T* __restrict__ x, T* __restrict__ l, int n) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const long s = blockIdx.x;
  const long nn = static_cast<long>(n) * n;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  T* w = l + s * nn;  // the system's n x n tile, row major
  T* v = sm;          // right-hand side, then x
  T* y = v + n;       // forward substitution's y

  const T* as = a + s * nn;
  for (long e = tid; e < nn; e += nt) w[e] = as[e];
  for (int i = tid; i < n; i += nt) v[i] = b[s * n + i];
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    // phase 1: every thread reads the pivot; rows below j are scaled (the
    // diagonal is written in phase 2, once nobody reads the pivot any more)
    const T piv = w[j * n + j];
    const T d = clamped_sqrt(piv);
    const T ljj = piv / d;
    for (int i = j + 1 + tid; i < n; i += nt) w[i * n + j] = w[i * n + j] / d;
    __syncthreads();
    // phase 2: the rank-1 update of the trailing lower triangle, the
    // forward substitution's column j, and the diagonal
    const T yj = v[j] / ljj;
    const int m = n - j - 1;
    const int base = j + 1;
    for (int e = tid; e < m * m; e += nt) {
      const int r = e / m;
      const int c = e - r * m;
      if (c <= r) {
        const int i = base + r;
        const int k = base + c;
        w[i * n + k] -= w[i * n + j] * w[k * n + j];
      }
    }
    for (int k = base + tid; k < n; k += nt) v[k] -= w[k * n + j] * yj;
    if (tid == 0) {
      w[j * n + j] = ljj;
      y[j] = yj;
    }
    __syncthreads();
  }

  // back substitution L^T x = y by rows of L: x_i = y_i / L_ii, then
  // y_k -= L_ik x_i for k < i; x goes to v
  for (int i = n - 1; i >= 0; --i) {
    const T xi = y[i] / w[i * n + i];
    for (int k = tid; k < i; k += nt) y[k] -= w[i * n + k] * xi;
    if (tid == 0) v[i] = xi;
    __syncthreads();
  }

  for (int i = tid; i < n; i += nt) x[s * n + i] = v[i];
  for (long e = tid; e < nn; e += nt) {  // clear the upper triangle
    const long i = e / n;
    if (e - i * n > i) w[e] = T(0);
  }
}

// ---- launches ----

struct DeviceLimits {
  int optin = 0;  // shared memory a block may opt in to
  int err = 0;    // a cudaError_t, if reading it failed
};

const DeviceLimits& limits() {
  static DeviceLimits lim;  // read once
  if (lim.optin == 0 && lim.err == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &lim.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) {
      lim.optin = 0;
      lim.err = static_cast<int>(err);
    }
  }
  return lim;
}

// raise a kernel's dynamic shared memory limit to `bytes`, once (its
// static shared memory comes on top and must fit the opt-in limit too)
template <typename Kernel>
int raise_shared(Kernel kernel, int bytes, bool* raised) {
  if (*raised) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  *raised = true;
  return 0;
}

template <int NP>
int launch_reg(const double* a, const double* b, double* x, double* l,
               int batch, int n, int store_l, cudaStream_t stream) {
  constexpr int G = kRegGroup<NP>;
  constexpr int SB = kRegSystems<NP>;
  const size_t smem = static_cast<size_t>(SB) *
                      stage_stride<double, NP, G>() * sizeof(double);
  static bool raised = false;
  if (smem > kDefaultSharedLimit) {
    const int err = raise_shared(reg_kernel<NP, G, SB>,
                                 static_cast<int>(smem), &raised);
    if (err) return err;
  }
  const long blocks = (static_cast<long>(batch) + SB - 1) / SB;
  reg_kernel<NP, G, SB><<<static_cast<unsigned>(blocks), SB * G, smem,
                          stream>>>(a, b, x, l, batch, n, store_l);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
bool tile_fits(int n) {
  return n <= 32 * kTileSlots &&
         tile_bytes<T>(n) <= static_cast<size_t>(limits().optin);
}

// Warps per system and systems per block of route (b) at size n, chosen
// once per n from the card's occupancy (shared memory and registers): the
// fewest warps per system (1 to 8) that bring an SM to 32 resident warps,
// else the most resident warps; then the systems per block (1, 2 or 4)
// that keep the most systems resident.
template <typename T>
int tile_shape(int n, int* warps, int* systems) {
  static int cached[32 * kTileSlots + 1][2];
  if (cached[n][0] == 0) {
    const size_t bytes = tile_bytes<T>(n);
    int best = -1;
    for (int W = 1; W <= 8; W *= 2) {
      int resident = 0, best_s = 1;  // systems an SM holds, and S for it
      for (int S = 1; S <= 4 && S * W * 32 <= kTileMaxThreads; S *= 2) {
        if (S * bytes > static_cast<size_t>(limits().optin)) break;
        int blocks = 0;
        const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, tile_kernel<T>, S * W * 32, S * bytes);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (blocks * S > resident) {
          resident = blocks * S;
          best_s = S;
        }
      }
      if (resident * W > best) {
        best = resident * W;
        cached[n][0] = W;
        cached[n][1] = best_s;
      }
      if (best >= 32) break;
    }
  }
  *warps = cached[n][0];
  *systems = cached[n][1];
  return 0;
}

template <typename T>
int launch_tile(const T* a, const T* b, T* x, T* l, int batch, int n,
                int store_l, cudaStream_t stream) {
  static bool raised = false;
  int err = raise_shared(tile_kernel<T>, limits().optin, &raised);
  if (err) return err;
  int W = 0, S = 0;
  err = tile_shape<T>(n, &W, &S);
  if (err) return err;
  const long blocks = (static_cast<long>(batch) + S - 1) / S;
  tile_kernel<T><<<static_cast<unsigned>(blocks), S * W * 32,
                   S * tile_bytes<T>(n), stream>>>(a, b, x, l, batch, n, W,
                                                   S, store_l);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_inplace(const T* a, const T* b, T* x, T* l, int batch, int n,
                   cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(n) * sizeof(T);
  if (smem > static_cast<size_t>(limits().optin)) return cudaErrorInvalidValue;
  static bool raised = false;
  if (smem > kDefaultSharedLimit) {
    const int err = raise_shared(inplace_kernel<T>, limits().optin, &raised);
    if (err) return err;
  }
  const int threads = n <= 16 ? 32 : (n <= 48 ? 128 : 256);
  inplace_kernel<T><<<static_cast<unsigned>(batch), threads, smem, stream>>>(
      a, b, x, l, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* a, const T* b, T* x, T* l, int batch, int n, int store_l,
           cudaStream_t stream) {
  if (limits().err) return limits().err;
  if constexpr (std::is_same<T, double>::value) {
    if (n <= 8) return launch_reg<8>(a, b, x, l, batch, n, store_l, stream);
    if (n <= 16) return launch_reg<16>(a, b, x, l, batch, n, store_l, stream);
    if (n <= 24) return launch_reg<24>(a, b, x, l, batch, n, store_l, stream);
    if (n <= 32) return launch_reg<32>(a, b, x, l, batch, n, store_l, stream);
    if (n <= 48) return launch_reg<48>(a, b, x, l, batch, n, store_l, stream);
    if (n <= 64) return launch_reg<64>(a, b, x, l, batch, n, store_l, stream);
  }
  if (tile_fits<T>(n)) return launch_tile<T>(a, b, x, l, batch, n, store_l,
                                             stream);
  return launch_inplace<T>(a, b, x, l, batch, n, stream);
}

}  // namespace

// C interface for ctypes. a and l [batch, n, n], b and x [batch, n], all of
// one type, contiguous, on the current device; l is always given (the
// working tile above the shared-memory limit) and holds the lower Cholesky
// factor on return when store_l is set (and always when the system did not
// fit shared memory). Launches on `stream` and returns the cudaError_t of the
// launch (0 on success); does not synchronise.
extern "C" int spd_solve_general_f32(const float* a, const float* b, float* x,
                                     float* l, int batch, int n, int store_l,
                                     void* stream) {
  if (batch <= 0 || n <= 0 || l == nullptr) return cudaErrorInvalidValue;
  return launch<float>(a, b, x, l, batch, n, store_l,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int spd_solve_general_f64(const double* a, const double* b,
                                     double* x, double* l, int batch, int n,
                                     int store_l, void* stream) {
  if (batch <= 0 || n <= 0 || l == nullptr) return cudaErrorInvalidValue;
  return launch<double>(a, b, x, l, batch, n, store_l,
                        static_cast<cudaStream_t>(stream));
}

// The largest n whose system the kernel stages in shared memory (route (b);
// above it route (c) works in place in L), for elements of `elem_bytes`
// (4 or 8); a negative cudaError_t on failure.
extern "C" int spd_solve_general_max_shared_n(int elem_bytes) {
  if (limits().err) return -limits().err;
  int n = 0;
  while (n + 1 <= 32 * kTileSlots &&
         static_cast<size_t>(n + 2) * tile_ld(n + 1) * elem_bytes <=
             static_cast<size_t>(limits().optin))
    ++n;
  return n;
}
