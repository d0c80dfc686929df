// Fused GLM gradient for Hopper (sm_90a): out = X^T (err(X w, y) * mask).
//
// Replaces the TPU kernel repro/kernels/engine/engine.py::_glm_kernel
// (launched by glm_grad_pallas through pl.pallas_call). Same contract:
// x (N, D) f32, y (N,), w (D,), mask (N,) -> (D,) f32, with err z - y
// (linear), sigmoid(z) - y (logistic) or (y*z < 1 ? -y : 0) (svm), as in
// repro/kernels/engine/ref.py::glm_error.
//
// Bound: bytes. X is read once at N*D*4 bytes and each element takes two
// multiply-adds, far below the card's f32 rate per byte, so 3.35 TB/s of device
// memory is the bound. At the TRAIN path's merge batch (256, 54) X is 55 KB:
// the two launches' latency, not the bound, sets the time.
//
// Design: the TPU kernel carries the (D,) sum across a sequential grid; Hopper
// blocks run in no order, so the sum takes two launches. Pass 1: one block per
// tile of kRows rows; each warp computes z for its rows (lanes across D, then a
// shuffle reduction), keeps e = err(z, y) * mask in shared memory, and the
// block writes its partial sum over rows of e * x to scratch (n_tiles, D),
// re-reading its tile of X from L1/L2. Pass 2 sums the partials of each feature
// in tile order. No float atomics: the result is the same bits on every run.
// Tiles are 32 rows, so a 256-row merge batch spreads over 8 blocks and each
// thread's chain of dependent loads is 4 rows in pass 1 and 32 in its second
// half: at this size latency, not bandwidth, is what the tile size trades.
// Any N and D, no padding: the last tile masks its ragged rows itself.
// Logistic uses 1/(1+expf(-z)), not __expf, and no fast-math flag is set.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kReduceThreads = 256;

enum Act { kLinear = 0, kLogistic = 1, kSvm = 2 };

__device__ __forceinline__ float glm_error(float z, float y, int act) {
  if (act == kLinear) return z - y;
  if (act == kLogistic) return 1.0f / (1.0f + expf(-z)) - y;
  return (y * z < 1.0f) ? -y : 0.0f;
}

__global__ void __launch_bounds__(kThreads) glm_partial_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ w, const float* __restrict__ mask,
    float* __restrict__ partial, int n, int d, int act) {
  __shared__ float e_s[kRows];
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int r = warp; r < rows; r += kWarps) {
    const float* xr = x + (size_t)(row0 + r) * d;
    float z = 0.0f;
    for (int f = lane; f < d; f += 32) z = fmaf(xr[f], w[f], z);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      z += __shfl_xor_sync(0xffffffffu, z, off);
    if (lane == 0) e_s[r] = glm_error(z, y[row0 + r], act) * mask[row0 + r];
  }
  __syncthreads();

  for (int f = threadIdx.x; f < d; f += kThreads) {
    const float* xc = x + (size_t)row0 * d + f;
    float acc = 0.0f;
#pragma unroll 8
    for (int r = 0; r < rows; ++r) acc = fmaf(e_s[r], xc[(size_t)r * d], acc);
    partial[(size_t)blockIdx.x * d + f] = acc;
  }
}

__global__ void __launch_bounds__(kReduceThreads) glm_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ out, int n_tiles,
    int d) {
  const int f = blockIdx.x * kReduceThreads + threadIdx.x;
  if (f >= d) return;
  float acc = 0.0f;
#pragma unroll 8
  for (int t = 0; t < n_tiles; ++t) acc += partial[(size_t)t * d + f];
  out[f] = acc;
}

}  // namespace

extern "C" {

// Rows per pass-1 tile: the wrapper sizes the scratch as (ceil(n / rows), d).
int glm_grad_tile_rows() { return kRows; }

// out (d,) = X^T (err(X w, y) * mask) on `stream`, with n >= 1 and d >= 1.
// `partial` is scratch of ceil(n / kRows) * d floats. Returns
// cudaGetLastError() after the launches (0 when both were accepted).
int glm_grad(const void* x, const void* y, const void* w, const void* mask,
             void* partial, void* out, int n, int d, int act, void* stream) {
  const int n_tiles = (n + kRows - 1) / kRows;
  cudaStream_t s = (cudaStream_t)stream;
  glm_partial_kernel<<<n_tiles, kThreads, 0, s>>>(
      (const float*)x, (const float*)y, (const float*)w, (const float*)mask,
      (float*)partial, n, d, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  glm_reduce_kernel<<<(d + kReduceThreads - 1) / kReduceThreads,
                      kReduceThreads, 0, s>>>((const float*)partial,
                                              (float*)out, n_tiles, d);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
