// Batched small SPD solve A[s] x[s] = b[s] for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel myosuite_mjx_tpu/ops/pallas_linalg.py
// (spd_solve_batched, kernel body _solve_kernel): a right-looking Cholesky
// with every pivot clamped to >= 1e-30 before the square root, then forward
// and back substitution, float32. The physics step calls it for M^-1
// qfrc_smooth, once per Newton iteration, and in the implicit-damping
// integrator, about 8 to 10 times per substep, at n = nv = 23 and B = 4096
// environments.
//
// What bounds it on this card: at [4096, 23] the kernel must move 9.42 MB
// (A, b and x once each; 18.1 MB when it also writes the factor), 2.81 us at
// 3.35 TB/s, and do ~38 MFLOP (2n^3/3 + 2n^2 per system), 0.56 us at
// 67 TFLOP/s. So bytes bound it. Above that bound, one system's latency
// sets the pace: on an H100 one block of 8 systems alone takes about three
// quarters of the time of the whole batch (chip_smoke.py prints both), most
// of it the factor, whose ~1,400 dependent instructions one warp issues in
// order; the load of the batch adds the rest, since a right-looking factor
// cannot start before its system is in. A warp per system, one row per
// lane, would leave a quarter of the lanes idle at n = 23 and issue every
// update on all 32 lanes; a group of 8 lanes per system does neither.
//
// Design. NP (8, 16, 24, 32 or 64) is the padded size, a template
// parameter, so every loop unrolls and every register index is static; the
// wrapper's n picks the smallest NP >= n. A group of G = 8 lanes solves one
// system (4 systems per warp; G = 32 at NP = 64), lane l holding rows
// l, l + G, ..., so each lane carries NP / G rows and every broadcast feeds
// NP / G updates.
// - Load: the SB systems of a block are contiguous in [B, n, n]. One thread
//   copies all SB*n*n floats into shared memory with one TMA bulk copy
//   (cp.async.bulk) that completes on an mbarrier, when the start and the
//   size are 16-byte aligned and the block is full. Otherwise (a misaligned
//   view, the ragged end of the batch) each warp copies its systems with
//   plain loads, all issued before the first use. Either way a system pays
//   about one memory latency before it starts.
// - Rows into registers, rows and columns n..NP-1 set to the identity, as
//   the Pallas kernel pads its batch with identity systems.
// - Factor in registers: at column j the pivot comes from its lane by
//   __shfl_sync (width G), every lane scales its a_ij, and for each k > j
//   l_kj comes from its lane by __shfl_sync and every lane updates a_ik,
//   without a predicate: rows above k write only their upper triangle,
//   which is cleared before anything reads it. No shared memory, no
//   __syncwarp. The forward substitution rides along: y_j = v_j * (1 / L_jj)
//   goes out with column j, so it adds no steps to the chain.
// - Back substitution: the strictly lower L is staged once in shared memory
//   (rows at the odd stride NP + 1, systems at a stride of G modulo 32, so
//   a warp's lanes hit 32 distinct banks) and read transposed: lane k reads
//   L_ik and x_i goes out by shuffle, row by row. A reduction over the
//   group per row would cost log2(G) shuffles against one shuffle and one
//   conflict-free shared load, and the staged tile is what the factor is
//   stored from anyway.
// - Stores: x by lane, coalesced within the group; the factor, when asked
//   for, from the staged tile with its diagonal put back, coalesced.
// Correctly rounded sqrtf and IEEE division (no fast math): the error bounds
// of chip_smoke.py and the card tests assume them.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kPivotFloor = 1e-30f;

// Lanes per system: 8 up to NP = 32 (4 systems per warp), a whole warp at 64.
template <int NP>
constexpr int kGroup = NP <= 32 ? 8 : 32;
// Systems per block: 8, or 4 where the tiles are large (above 48 KB of
// shared memory the launch raises the kernel's limit).
template <int NP>
constexpr int kSystems = NP <= 24 ? 8 : 4;

__device__ __forceinline__ void wait_parity0(uint32_t bar) {
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

// Floats between the staged factors of two systems: at least NP * (NP + 1)
// and G modulo 32, so that the G lanes of each of a warp's 32 / G systems
// hit 32 distinct banks.
template <int NP, int G>
__host__ __device__ constexpr int stage_stride() {
  int t = NP * (NP + 1);
  while (t % 32 != G % 32) ++t;
  return t;
}

template <int NP, int G, int SB>
__global__ void __launch_bounds__(SB * G)
    spd_solve_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ x, float* __restrict__ l, long batch,
                     int n) {
  constexpr int SPW = 32 / G;               // systems per warp
  constexpr int RP = NP / G;                // rows per lane
  constexpr int LD = NP + 1;                // odd row stride of a staged L
  constexpr int TS = stage_stride<NP, G>();
  constexpr int kTrips = (NP * NP + G - 1) / G;  // group passes over n*n
  // [SB][n][n] A as in device memory, then [SB][TS] staged factors
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t loaded;  // mbarrier of the bulk copy

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gl = lane % G;                  // lane within the system's group
  const int sys = warp * SPW + lane / G;    // system within the block
  const int nn = n * n;
  const long s0 = static_cast<long>(blockIdx.x) * SB;
  const long count = batch - s0 < SB ? batch - s0 : SB;
  const float* ablock = a + s0 * nn;
  const uint32_t bytes = static_cast<uint32_t>(SB * nn) * sizeof(float);
  const bool bulk = count == SB && bytes % 16 == 0 &&
                    (reinterpret_cast<uintptr_t>(ablock) & 15) == 0;
  const uint32_t bar =
      static_cast<uint32_t>(__cvta_generic_to_shared(&loaded));

  if (bulk) {  // block-uniform
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const uint32_t dst =
          static_cast<uint32_t>(__cvta_generic_to_shared(smem));
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar),
          "r"(bytes)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(dst),
          "l"(ablock), "r"(bytes), "r"(bar)
          : "memory");
    }
  }
  // only in a ragged last block: a warp with no system leaves; a warp with
  // some stays whole (the shuffles need every lane) and masks the rest
  if (warp * SPW >= count) return;
  const bool live_sys = sys < count;
  const long s = s0 + sys;

  if (!bulk) {  // the warp copies its live systems, contiguous in a
    const int m = (count - warp * SPW < SPW ? count - warp * SPW : SPW) * nn;
    const float* aw = ablock + warp * SPW * nn;
    float* tw = smem + warp * SPW * nn;
#pragma unroll
    for (int t = 0; t < (SPW * NP * NP + 31) / 32; ++t) {
      const int e = lane + 32 * t;
      if (e < m) tw[e] = aw[e];
    }
  }
  float v[RP];  // right-hand side, then y, then x
#pragma unroll
  for (int p = 0; p < RP; ++p) {
    const int row = gl + G * p;
    v[p] = live_sys && row < n ? b[s * n + row] : 0.0f;
  }
  if (bulk) {
    wait_parity0(bar);
  } else {
    __syncwarp();
  }

  // rows into registers (rows and columns n..NP-1: identity); the row index
  // is clamped so that every read stays inside the shared tiles. Slot p
  // holds rows G*p .. G*p + G-1, so only columns in that band can meet the
  // diagonal.
  const float* tile = smem + sys * nn;
  float r[RP][NP];
#pragma unroll
  for (int p = 0; p < RP; ++p) {
    const int row = gl + G * p;
    const bool live = row < n;
    const int ncols = live ? n : 0;
    const float* src = tile + (live ? row : n - 1) * n;
#pragma unroll
    for (int c = 0; c < NP; ++c) {
      const float val = src[c];
      const float pad = (c >= G * p && c < G * p + G && c == row) ? 1.0f : 0.0f;
      r[p][c] = c < ncols ? val : pad;
    }
  }

  // right-looking Cholesky in registers: L overwrites the lower triangle.
  // Row k lives on lane k % G of the group, in slot k / G. The forward
  // substitution L y = b rides along: once column j is scaled, v_j (b_j
  // less the terms of columns < j) gives y_j, which goes out with column j.
  float diag[RP];  // L_ii of the lane's own rows
  float inv[RP];   // 1 / L_ii
  float y[RP];
#pragma unroll
  for (int p = 0; p < RP; ++p) diag[p] = inv[p] = y[p] = 1.0f;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const float piv = __shfl_sync(kFullMask, r[j / G][j], j % G, G);
    const float d = sqrtf(fmaxf(piv, kPivotFloor));
    const float dinv = 1.0f / d;
    const float yj = __shfl_sync(kFullMask, v[j / G] * dinv, j % G, G);
    if (gl == j % G) {
      diag[j / G] = d;
      inv[j / G] = dinv;
      y[j / G] = yj;
    }
#pragma unroll
    for (int p = 0; p < RP; ++p) {
      if (G * p + G - 1 < j) continue;  // every row of this slot is above j
      r[p][j] *= dinv;  // on and above the diagonal: cleared below
      v[p] -= r[p][j] * yj;  // rows <= j: spoilt, their y is kept
    }
#pragma unroll
    for (int k = j + 1; k < NP; ++k) {
      const float lkj = __shfl_sync(kFullMask, r[k / G][j], k % G, G);
#pragma unroll
      for (int p = 0; p < RP; ++p) {
        if (G * p + G - 1 < k) continue;  // no row of this slot reaches k
        r[p][k] -= r[p][j] * lkj;
      }
    }
  }

  // keep the strictly lower triangle: with zeros on and above the diagonal
  // the back substitution runs on every lane without a select
#pragma unroll
  for (int p = 0; p < RP; ++p) {
    const int row = gl + G * p;
#pragma unroll
    for (int c = 0; c < NP; ++c) {
      if (c >= G * p + G) {
        r[p][c] = 0.0f;
      } else if (c >= G * p) {
        r[p][c] = c < row ? r[p][c] : 0.0f;
      }
    }
  }

#pragma unroll
  for (int p = 0; p < RP; ++p) v[p] = y[p];

  // stage the strictly lower L for the transposed reads
  float* T = smem + SB * nn + sys * TS;
#pragma unroll
  for (int p = 0; p < RP; ++p) {
    const int row = gl + G * p;
#pragma unroll
    for (int c = 0; c < NP; ++c) T[row * LD + c] = r[p][c];
  }
  __syncwarp();

  // back substitution L^T x = y: lane k reads L_ik from the staged tile
  // (zero for k >= i)
#pragma unroll
  for (int i = NP - 1; i >= 0; --i) {
    const float xi =
        __shfl_sync(kFullMask, v[i / G] * inv[i / G], i % G, G);
#pragma unroll
    for (int p = 0; p < RP; ++p) {
      if (G * p >= i) continue;  // no row of this slot is above i
      const int row = gl + G * p;
      v[p] -= T[i * LD + row] * xi;
    }
  }
#pragma unroll
  for (int p = 0; p < RP; ++p) v[p] *= inv[p];

  if (l != nullptr) {  // put the diagonal into the staged factor
#pragma unroll
    for (int p = 0; p < RP; ++p) {
      const int row = gl + G * p;
      T[row * LD + row] = diag[p];
    }
    __syncwarp();
  }
  if (!live_sys) return;
#pragma unroll
  for (int p = 0; p < RP; ++p) {
    const int row = gl + G * p;
    if (row < n) x[s * n + row] = v[p];
  }
  if (l != nullptr) {  // element e = i*n + c of the factor is T[i][c]
    float* ls = l + s * nn;
    const int di = G / n;
    const int dc = G - di * n;
    int i = gl / n;
    int c = gl - i * n;
#pragma unroll
    for (int t = 0; t < kTrips; ++t) {
      const int e = gl + G * t;
      if (e < nn) ls[e] = T[i * LD + c];
      i += di;
      c += dc;
      if (c >= n) {
        c -= n;
        ++i;
      }
    }
  }
}

template <int NP>
int launch(const float* a, const float* b, float* x, float* l, long batch,
           int n, cudaStream_t stream) {
  constexpr int G = kGroup<NP>;
  constexpr int SB = kSystems<NP>;
  static_assert(NP % G == 0 && (SB * G) % 32 == 0, "whole rows, whole warps");
  const size_t smem = (static_cast<size_t>(SB) * n * n +
                       static_cast<size_t>(SB) * stage_stride<NP, G>()) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spd_solve_kernel<NP, G, SB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long blocks = (batch + SB - 1) / SB;
  spd_solve_kernel<NP, G, SB><<<static_cast<unsigned>(blocks), SB * G, smem,
                                stream>>>(a, b, x, l, batch, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface for ctypes. a [batch, n, n], b and x [batch, n], all float32,
// contiguous, on the current device; l is null or [batch, n, n] and then
// receives the Cholesky factor. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success); does not synchronise.
extern "C" int spd_solve_f32(const float* a, const float* b, float* x,
                             float* l, int batch, int n, void* stream) {
  if (batch <= 0 || n <= 0 || n > 64) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (n <= 8) return launch<8>(a, b, x, l, batch, n, st);
  if (n <= 16) return launch<16>(a, b, x, l, batch, n, st);
  if (n <= 24) return launch<24>(a, b, x, l, batch, n, st);
  if (n <= 32) return launch<32>(a, b, x, l, batch, n, st);
  return launch<64>(a, b, x, l, batch, n, st);
}
