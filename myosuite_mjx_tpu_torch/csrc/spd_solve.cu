// Batched small SPD solve A[s] x[s] = b[s] for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel myosuite_mjx_tpu/ops/pallas_linalg.py
// (spd_solve_batched, kernel body _solve_kernel): a right-looking Cholesky
// with every pivot clamped to >= 1e-30 before the square root, then forward
// and back substitution, float32. The physics step calls it three times per
// substep (M^-1 qfrc_smooth, the Newton step, the implicit-damping
// integrator) at n = nv = 23 and B = 4096 environments.
//
// What bounds it on this card: at n = 23 one system is about n^3/3 = 4k
// FMAs over 2.2 KB of input, so a whole [4096, 23, 23] batch is ~17 MFLOP
// over ~9 MB. Bytes take a few microseconds at 3.35 TB/s and the FMAs far
// less; the factor is a chain of n dependent steps, so latency and
// occupancy set the pace, not bandwidth or arithmetic.
//
// Design: one warp per system. The warp copies A into a shared-memory tile
// [n][ld] with coalesced loads, ld the smallest odd number >= n so that a
// column walk by the lanes (lane i reads row i) hits 32 distinct banks.
// Lane i owns rows i and i + 32. Each column step scales the column below
// the pivot, then every lane updates its own row of the trailing triangle;
// the pivot column is read as a shared-memory broadcast. The substitutions
// run column by column on a shared right-hand side. Only __syncwarp orders
// the steps, so warps of a block never wait for each other, and several
// warps (up to 8, as shared memory allows) share a block to keep the SMs
// full. There is no lane transpose and no identity padding: a warp past the
// end of the batch returns at once.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kMaxWarps = 8;
constexpr size_t kSmemBudget = 48 * 1024;

__global__ void spd_solve_kernel(const float* __restrict__ a,
                                 const float* __restrict__ b,
                                 float* __restrict__ x,
                                 float* __restrict__ l, int batch, int n,
                                 int ld) {
  extern __shared__ float smem[];
  const int warps = blockDim.x >> 5;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long s = static_cast<long>(blockIdx.x) * warps + w;
  if (s >= batch) return;  // whole warp leaves; no block-wide barrier below

  float* A = smem + static_cast<size_t>(w) * (n * ld + 3 * n);
  float* v = A + n * ld;   // right-hand side, then y, then x, in place
  float* linv = v + n;     // 1 / L[j][j]
  float* diag = linv + n;  // L[j][j]
  const float* as = a + s * n * n;

  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n;
    A[i * ld + (e - i * n)] = as[e];
  }
  for (int i = lane; i < n; i += 32) v[i] = b[s * n + i];
  __syncwarp();

  // right-looking Cholesky: L overwrites the lower triangle of A
  for (int j = 0; j < n; ++j) {
    const float d = sqrtf(fmaxf(A[j * ld + j], 1e-30f));
    const float inv = 1.0f / d;
    for (int i = j + 1 + lane; i < n; i += 32) A[i * ld + j] *= inv;
    if (lane == 0) {
      linv[j] = inv;
      diag[j] = d;
    }
    __syncwarp();
    for (int i = j + 1 + lane; i < n; i += 32) {
      const float lij = A[i * ld + j];
      for (int k = j + 1; k <= i; ++k) A[i * ld + k] -= lij * A[k * ld + j];
    }
    __syncwarp();
  }

  // forward substitution L y = b
  for (int j = 0; j < n; ++j) {
    const float yj = v[j] * linv[j];
    __syncwarp();
    if (lane == (j & 31)) v[j] = yj;
    for (int i = j + 1 + lane; i < n; i += 32) v[i] -= A[i * ld + j] * yj;
    __syncwarp();
  }

  // back substitution L^T x = y
  for (int i = n - 1; i >= 0; --i) {
    const float xi = v[i] * linv[i];
    __syncwarp();
    if (lane == (i & 31)) v[i] = xi;
    for (int k = lane; k < i; k += 32) v[k] -= A[i * ld + k] * xi;
    __syncwarp();
  }

  for (int i = lane; i < n; i += 32) x[s * n + i] = v[i];
  if (l != nullptr) {  // the factor, zeros above the diagonal
    for (int e = lane; e < n * n; e += 32) {
      const int i = e / n;
      const int j = e - i * n;
      l[s * n * n + e] = j < i ? A[i * ld + j] : (j == i ? diag[i] : 0.0f);
    }
  }
}

}  // namespace

// C interface for ctypes. a [batch, n, n], b and x [batch, n], all float32,
// contiguous, on the current device; l is null or [batch, n, n] and then
// receives the Cholesky factor. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success); does not synchronise.
extern "C" int spd_solve_f32(const float* a, const float* b, float* x,
                             float* l, int batch, int n, void* stream) {
  if (batch <= 0 || n <= 0 || n > kMaxN) return cudaErrorInvalidValue;
  const int ld = (n % 2) ? n : n + 1;
  const size_t per_warp = static_cast<size_t>(n * ld + 3 * n) * sizeof(float);
  int warps = static_cast<int>(kSmemBudget / per_warp);
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const int blocks = (batch + warps - 1) / warps;
  spd_solve_kernel<<<blocks, warps * 32, warps * per_warp,
                     static_cast<cudaStream_t>(stream)>>>(a, b, x, l, batch, n,
                                                          ld);
  return static_cast<int>(cudaGetLastError());
}
