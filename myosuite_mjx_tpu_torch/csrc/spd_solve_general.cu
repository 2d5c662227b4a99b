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
// not the register kernel's 1e-30), column j divided by d = sqrt(max(a_jj,
// tiny)) on and below the diagonal (so L_jj = a_jj / d, as chol_factor), then
// forward and back substitution by columns. The engine reaches it through
// ops/linalg.spd_solve when it runs in float64 on the card or on a model with
// nv > 64.
//
// What bounds it on this card: the bytes, A and b read and x written once
// (8n^2 + 16n bytes per system in float64), against 2n^3/3 + 2n^2 flops per
// system at 34 TFLOP/s in float64 or 67 in float32: bytes bound it up to
// n ~ 100 in float64. The design below is far above that bound: it is the
// simple version that is right (making it fast is later work).
//
// Design. One block per system. The system is staged in dynamic shared
// memory (the n x n tile, then the right-hand side and y) when
// n^2 * sizeof(T) + 2n * sizeof(T) fits the opt-in limit
// (cudaDevAttrMaxSharedMemoryPerBlockOptin, 227 KB on an H100: n <= 169 in
// float64, n <= 240 in float32); above it the same body works in place in the
// L output, which the wrapper always allocates, with only the two vectors in
// shared memory. Per column j: every thread reads the pivot and scales its
// rows of column j (phase 1); then the rank-1 update of the trailing lower
// triangle is spread over the block's threads, and the forward substitution
// rides along (y_j = v_j / L_jj, v_k -= L_kj y_j; phase 2). The back
// substitution goes by rows of L^T, one barrier each. The launch is on the
// caller's stream, allocates nothing and never synchronises the host, so it
// can be captured in a CUDA graph. The kernel's dynamic shared memory limit
// is raised once per instance, to the opt-in limit, when a tile needs more
// than 48 KB. Correctly rounded sqrt and IEEE division (no fast math).
#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

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

constexpr int kDefaultSharedLimit = 48 * 1024;

template <typename T>
__global__ void __launch_bounds__(256)
    spd_solve_general_kernel(const T* __restrict__ a, const T* __restrict__ b,
                             T* __restrict__ x, T* __restrict__ l, int n,
                             int in_shared, int store_l) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const long s = blockIdx.x;
  const long nn = static_cast<long>(n) * n;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  T* w = in_shared ? sm : l + s * nn;  // the system's n x n tile, row major
  T* v = in_shared ? sm + nn : sm;     // right-hand side, then x
  T* y = v + n;                        // forward substitution's y

  const T* as = a + s * nn;
  for (long e = tid; e < nn; e += nt) w[e] = as[e];
  for (int i = tid; i < n; i += nt) v[i] = b[s * n + i];
  __syncthreads();

  const T tiny = tiny_of<T>();
  for (int j = 0; j < n; ++j) {
    // phase 1: every thread reads the pivot; rows below j are scaled (the
    // diagonal is written in phase 2, once nobody reads the pivot any more)
    const T piv = w[j * n + j];
    const T d = sqrt(piv < tiny ? tiny : piv);  // NaN stays NaN, as clamp
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
  if (in_shared) {
    if (store_l) {  // the factor with its upper triangle zeroed
      T* ls = l + s * nn;
      for (long e = tid; e < nn; e += nt) {
        const long i = e / n;
        ls[e] = e - i * n <= i ? w[e] : T(0);
      }
    }
  } else {  // in place: clear the upper triangle, which still holds A's
    for (long e = tid; e < nn; e += nt) {
      const long i = e / n;
      if (e - i * n > i) w[e] = T(0);
    }
  }
}

int shared_optin() {
  static int optin = -1;  // queried once
  if (optin < 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return -static_cast<int>(err);
    int val = 0;
    err = cudaDeviceGetAttribute(&val, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
    if (err != cudaSuccess) return -static_cast<int>(err);
    optin = val;
  }
  return optin;
}

template <typename T>
size_t tile_bytes(int n) {
  return (static_cast<size_t>(n) * n + 2 * static_cast<size_t>(n)) *
         sizeof(T);
}

template <typename T>
int launch(const T* a, const T* b, T* x, T* l, int batch, int n, int store_l,
           cudaStream_t stream) {
  static bool raised = false;  // the instance's shared memory limit
  const int optin = shared_optin();
  if (optin < 0) return -optin;
  const bool in_shared = tile_bytes<T>(n) <= static_cast<size_t>(optin);
  const size_t smem =
      in_shared ? tile_bytes<T>(n) : 2 * static_cast<size_t>(n) * sizeof(T);
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  if (smem > kDefaultSharedLimit && !raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        spd_solve_general_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  const int threads = n <= 16 ? 32 : (n <= 48 ? 128 : 256);
  spd_solve_general_kernel<T><<<static_cast<unsigned>(batch), threads, smem,
                                stream>>>(a, b, x, l, n, in_shared ? 1 : 0,
                                          store_l);
  return static_cast<int>(cudaGetLastError());
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

// The largest n whose system the kernel stages in shared memory, for
// elements of `elem_bytes` (4 or 8); a negative cudaError_t on failure.
extern "C" int spd_solve_general_max_shared_n(int elem_bytes) {
  const int optin = shared_optin();
  if (optin < 0) return optin;
  size_t n = 0;
  while (((n + 1) * (n + 1) + 2 * (n + 1)) * elem_bytes <=
         static_cast<size_t>(optin))
    ++n;
  return static_cast<int>(n);
}
