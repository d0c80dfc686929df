// RWKV6 chunkwise WKV recurrence for Hopper (sm_90a), forward (B6).
//
// Replaces the TPU kernel repro/kernels/wkv/wkv.py::_wkv_kernel (launched by
// wkv_pallas through pl.pallas_call). Same contract as its plain version
// repro_torch/kernels/wkv/ref.py::wkv_chunked_ref:
//   r, k (B, T, H, K), v (B, T, H, V), in f32 or bf16 (one type for all three);
//   lw (B, T, H, K) f32 log-decays (<= 0); u (H, K) f32; s0 (B, H, K, V) f32
//   -> y (B, T, H, V) in r's type, s_out (B, H, K, V) f32,
// all arithmetic in f32. Per (b, h) and chunk of C tokens, with cum the
// inclusive cumsum of lw over the chunk and q_ex = cum - lw:
//   y_t = (r_t e^{q_ex_t}) S + sum_{s<t} A[t,s] v_s + (sum_k r_t u k_t) v_t,
//   A[t,s] = sum_k r_t k_s e^{q_ex_t - cum_s},
//   S' = e^{cum_last} S + sum_s (k_s e^{cum_last - cum_s}) v_s^T.
// Every exponent is a difference of a decreasing cumsum taken the right way
// round, so it is <= 0: no overflow, no rescaling. Pairs s >= t are never
// computed (the TPU kernel computes and then masks them).
// With `states` non-null the kernel also writes each chunk's starting state
// to states (B*H, T/C, K, V), which the backward kernel (wkv_bwd.cu) reads.
//
// Bound: at the training shape (B*H = 320, T = 512, K = V = 64, C = 32, bf16
// r/k/v) each (b, h) reads r, k, v, lw once and writes y once, about 136 MB
// (0.041 ms at 3.35 TB/s); with the chunk states the backward needs, 220 MB
// (0.066 ms). The f32 work is about 3.6 GFLOP (0.054 ms at 67 TFLOP/s), 184 M
// of it exponentials (the A tile), which run on the special-function units
// at a fraction of that rate. So bytes bound a training call and operations
// an inference call, at comparable times.
//
// Design: the TPU grid (B*H, chunks) with the state in VMEM across the
// sequential chunk axis becomes one CTA per (b, h) that walks its chunks in
// order, with the (K, V) state in shared memory (16 KB at 64 x 64). The
// (C, C, K) decay tile of the TPU kernel (256 KB at C = 32, K = 64) is never
// staged: each A[t, s] is one thread's loop over k. Per chunk: load the tiles
// (bf16 upcast), cumsum per k column, then r e^{q_ex}, k e^{cum_last - cum},
// A and the bonus diagonal, then y per (t, v) and the state update per (k, v),
// each output owned by one thread. Rows of the shared tiles are padded by one
// word so that a warp reading a column touches 32 banks. No atomics: the same
// bits on every run. expf, not __expf, and no fast-math flag.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // the most a block may use on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// shared floats: S (K x V+1), r/k/cum/qex/rq/kl (C x K+1 each), v (C x V+1),
// A (C x C), D (C), elast (K)
__host__ __device__ inline size_t fwd_smem_floats(int K, int V, int C) {
  return (size_t)K * (V + 1) + 6 * (size_t)C * (K + 1) + (size_t)C * (V + 1) +
         (size_t)C * C + C + K;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) wkv_fwd_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ lw, const float* __restrict__ u,
    const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ s_out,
    float* __restrict__ states, int T_len, int H, int K, int V, int C) {
  extern __shared__ float sm[];
  const int KP = K + 1, VP = V + 1;
  float* S = sm;                        // K x VP
  float* rs = S + (size_t)K * VP;       // C x KP
  float* ks = rs + (size_t)C * KP;
  float* cum = ks + (size_t)C * KP;
  float* qex = cum + (size_t)C * KP;
  float* rq = qex + (size_t)C * KP;     // r e^{q_ex}
  float* kl = rq + (size_t)C * KP;      // k e^{cum_last - cum}
  float* vs = kl + (size_t)C * KP;      // C x VP
  float* A = vs + (size_t)C * VP;       // C x C
  float* D = A + (size_t)C * C;         // C
  float* elast = D + C;                 // K

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int nc = T_len / C;
  const float* uh = u + (size_t)h * K;

  for (int i = tid; i < K * V; i += kThreads)
    S[(i / V) * VP + i % V] = s0[(size_t)bh * K * V + i];
  __syncthreads();

  for (int c = 0; c < nc; ++c) {
    if (states != nullptr) {
      float* dst = states + ((size_t)bh * nc + c) * K * V;
      for (int i = tid; i < K * V; i += kThreads) dst[i] = S[(i / V) * VP + i % V];
    }
    // tiles of the chunk: token t of the chunk is row t
    for (int i = tid; i < C * K; i += kThreads) {
      const int t = i / K, kk = i % K;
      const size_t g = (((size_t)b * T_len + (size_t)c * C + t) * H + h) * K + kk;
      rs[t * KP + kk] = to_f(r[g]);
      ks[t * KP + kk] = to_f(k[g]);
      cum[t * KP + kk] = lw[g];
    }
    for (int i = tid; i < C * V; i += kThreads) {
      const int t = i / V, vv = i % V;
      const size_t g = (((size_t)b * T_len + (size_t)c * C + t) * H + h) * V + vv;
      vs[t * VP + vv] = to_f(v[g]);
    }
    __syncthreads();
    // inclusive cumsum down each k column, in token order
    for (int kk = tid; kk < K; kk += kThreads) {
      float run = 0.0f;
      for (int t = 0; t < C; ++t) {
        const float l = cum[t * KP + kk];
        qex[t * KP + kk] = run;  // (run + l) - l in the reference: the sum before t
        run += l;
        cum[t * KP + kk] = run;
      }
      elast[kk] = expf(run);
    }
    __syncthreads();
    for (int i = tid; i < C * K; i += kThreads) {
      const int t = i / K, kk = i % K;
      rq[t * KP + kk] = rs[t * KP + kk] * expf(qex[t * KP + kk]);
      kl[t * KP + kk] = ks[t * KP + kk] * expf(cum[(C - 1) * KP + kk] - cum[t * KP + kk]);
    }
    for (int i = tid; i < C * C; i += kThreads) {
      const int t = i / C, s = i % C;
      float acc = 0.0f;
      if (s < t) {
        const float* rt = rs + t * KP;
        const float* qt = qex + t * KP;
        const float* ksr = ks + s * KP;
        const float* cs = cum + s * KP;
        for (int kk = 0; kk < K; ++kk) acc = fmaf(rt[kk] * ksr[kk], expf(qt[kk] - cs[kk]), acc);
      }
      A[t * C + s] = acc;
    }
    for (int t = tid; t < C; t += kThreads) {
      float acc = 0.0f;
      for (int kk = 0; kk < K; ++kk) acc = fmaf(rs[t * KP + kk] * uh[kk], ks[t * KP + kk], acc);
      D[t] = acc;
    }
    __syncthreads();
    for (int i = tid; i < C * V; i += kThreads) {
      const int t = i / V, vv = i % V;
      float acc = 0.0f;
      for (int kk = 0; kk < K; ++kk) acc = fmaf(rq[t * KP + kk], S[kk * VP + vv], acc);
      for (int s = 0; s < t; ++s) acc = fmaf(A[t * C + s], vs[s * VP + vv], acc);
      acc = fmaf(D[t], vs[t * VP + vv], acc);
      const size_t g = (((size_t)b * T_len + (size_t)c * C + t) * H + h) * V + vv;
      y[g] = from_f<T>(acc);
    }
    __syncthreads();
    for (int i = tid; i < K * V; i += kThreads) {
      const int kk = i / V, vv = i % V;
      float acc = elast[kk] * S[kk * VP + vv];
      for (int s = 0; s < C; ++s) acc = fmaf(kl[s * KP + kk], vs[s * VP + vv], acc);
      S[kk * VP + vv] = acc;
    }
    __syncthreads();
  }
  for (int i = tid; i < K * V; i += kThreads)
    s_out[(size_t)bh * K * V + i] = S[(i / V) * VP + i % V];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* lw, const void* u,
           const void* s0, void* y, void* s_out, void* states, int B, int T_len, int H,
           int K, int V, int C, cudaStream_t s) {
  const size_t bytes = fwd_smem_floats(K, V, C) * sizeof(float);
  if (bytes > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  // raised once per size, at the first call (outside any CUDA graph capture)
  static size_t attr_bytes = 0;
  cudaError_t err;
  if (bytes > attr_bytes) {
    err = cudaFuncSetAttribute(wkv_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    attr_bytes = bytes;
  }
  wkv_fwd_kernel<T><<<B * H, kThreads, bytes, s>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)lw, (const float*)u,
      (const float*)s0, (T*)y, (float*)s_out, (float*)states, T_len, H, K, V, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y, s_out (and states when non-null) from r, k, v, lw, u, s0 on `stream`;
// T_len % C == 0, B * H >= 1. bf16 != 0: r, k, v and y are bf16, else f32.
// Returns cudaGetLastError() after the launch (0 when it was accepted), or
// cudaErrorInvalidValue when the tiles of one chunk exceed shared memory.
int wkv_fwd(const void* r, const void* k, const void* v, const void* lw, const void* u,
            const void* s0, void* y, void* s_out, void* states, int B, int T_len, int H,
            int K, int V, int C, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(r, k, v, lw, u, s0, y, s_out, states, B, T_len, H, K, V,
                                 C, s);
  return launch<float>(r, k, v, lw, u, s0, y, s_out, states, B, T_len, H, K, V, C, s);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
