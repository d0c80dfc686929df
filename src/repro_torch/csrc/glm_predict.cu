// GLM scoring for Hopper (sm_90a): out[i] = mask[i] > 0 ? act(x[i] . w) : 0.
//
// Replaces the TPU kernel repro/kernels/engine/engine.py::_glm_predict_kernel
// (launched by glm_predict_pallas through pl.pallas_call). Same contract:
// x (N, D) f32, w (D,), mask (N,) -> (N,) f32 with act z (linear),
// 1/(1+expf(-z)) (logistic) or (z >= 0 ? 1 : -1) (svm), as in
// repro/kernels/engine/ref.py::glm_act.
//
// Bound: bytes. Each element of X is read once for one multiply-add, far
// below the card's f32 rate per byte, so 3.35 TB/s of device memory sets the
// least time: the live rows of X, the mask and w read once, the output
// written once.
//
// Design: one warp per row, kRowsPerBlock rows per block. The TPU kernel pads
// N and D to 128 lanes; here lanes stride over D and the last block masks its
// ragged rows, so no padding is ever allocated. The dot product is each
// lane's fmaf chain followed by a fixed xor-shuffle tree: the same bits on
// every run, no float atomics. A dead row is skipped and written as 0 by a
// select, never as a product with the mask: a dead row of inf or 1e38 would
// otherwise give NaN. expf, not __expf, and no fast-math flag, so logistic
// rounds as torch.sigmoid's 1/(1+exp(-z)) does.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

enum Act { kLinear = 0, kLogistic = 1, kSvm = 2 };

__device__ __forceinline__ float glm_act(float z, int act) {
  if (act == kLinear) return z;
  if (act == kLogistic) return 1.0f / (1.0f + expf(-z));
  return z >= 0.0f ? 1.0f : -1.0f;
}

__global__ void __launch_bounds__(kThreads) glm_predict_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ mask, float* __restrict__ out, int n, int d,
    int act) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;
  const bool live = __ldg(mask + row) > 0.0f;
  float z = 0.0f;
  if (live) {  // warp-uniform: the whole warp serves one row
    const float* xr = x + (size_t)row * d;
    for (int f = lane; f < d; f += 32) z = fmaf(__ldg(xr + f), __ldg(w + f), z);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      z += __shfl_xor_sync(0xffffffffu, z, off);
  }
  if (lane == 0) out[row] = live ? glm_act(z, act) : 0.0f;
}

}  // namespace

extern "C" {

// out (n,) = where(mask > 0, act(x w), 0) on `stream`, with n >= 1. Returns
// cudaGetLastError() after the launch (0 when it was accepted).
int glm_predict(const void* x, const void* w, const void* mask, void* out,
                int n, int d, int act, void* stream) {
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  glm_predict_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)mask, (float*)out, n, d,
      act);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
