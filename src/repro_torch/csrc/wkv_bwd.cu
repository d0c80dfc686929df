// Backward of the RWKV6 chunkwise WKV recurrence for Hopper (sm_90a), B6-bwd.
//
// No TPU counterpart: the reference cannot differentiate its Pallas kernel
// (jax.grad of repro/kernels/wkv/wkv.py::wkv_pallas fails) and trains through
// the jnp form repro/models/ssm.py::wkv_chunked. This kernel computes the
// gradients of wkv.cu's (y, s_out) with respect to (r, k, v, lw, u, s0), the
// plain version being autograd through
// repro_torch/kernels/wkv/ref.py::wkv_chunked_ref (wkv_bwd_ref):
//   inputs as wkv.cu, plus states (B*H, T/C, K, V) f32 (each chunk's starting
//   state, written by wkv.cu), s_out, dy (B, T, H, V) in r's type and
//   ds_out (B, H, K, V) f32 or null (zero)
//   -> dr, dk (B, T, H, K), dv (B, T, H, V) in r's type, dlw (B, T, H, K) f32,
//      du (H, K) f32, ds0 (B, H, K, V) f32.
//
// Math, per (b, h), walking the chunks backwards with dS the gradient of the
// state after the chunk (ds_out for the last one). Within a chunk, with cum,
// q_ex, A[t,s] (s < t) and D_t = sum_k r_t u k_t as in the forward, and
// G[t,s] = dy_t . v_s:
//   dv_s = (k_s e^{cum_last - cum_s}) dS + sum_{t>s} A[t,s] dy_t + D_s dy_s
//   dr_t = e^{q_ex_t} (S0 dy_t) + sum_{s<t} G[t,s] k_s e^{q_ex_t - cum_s} + u k_t G[t,t]
//   dk_s = e^{cum_last - cum_s} (dS v_s) + sum_{t>s} G[t,s] r_t e^{q_ex_t - cum_s}
//          + r_s u G[s,s]
//   du  += sum_t r_t k_t G[t,t]
//   dlw_j = g_last + sum_{t>=j} g_cum_t + sum_{t>j} g_qex_t, where
//          g_last = rowsum(dS o S_end), g_qex_t = r_t (dr_t - u k_t G[t,t]),
//          g_cum_t = -k_t (dk_t - r_t u G[t,t])
//   dS <- e^{cum_last} dS + sum_t (r_t e^{q_ex_t}) dy_t^T
// with S0 the chunk's starting state and S_end the state after it. These are
// the per-token rules (dr_t = S_{t-1} dy_t + ..., dlw_t = w_t rowsum(dS_t o
// S_{t-1}), dS_{t-1} = w_t dS_t + r_t dy_t^T) summed over a chunk in closed
// form: every exponent is <= 0 as in the forward, and nothing divides by a
// decay (w_t reaches e^-8). The derivative by the log-decays goes through
// cum and q_ex, whose gradients the reverse cumsum over the chunk turns into
// dlw.
//
// Bound: operations. Each (b, h) reads r, k, v, lw, dy and the chunk states
// once and writes the gradients once: about 330 MB at the training shape
// (B*H = 320, T = 512, K = V = 64, C = 32, bf16 r/k/v/dy), 0.099 ms at
// 3.35 TB/s, against about 8.1 GFLOP of f32 work (0.121 ms at 67 TFLOP/s),
// 530 M of it exponentials (A and the two decayed sums, three per (t, s, k)).
//
// Design: one CTA per (b, h), holding the whole (K, V) state and its gradient,
// so the sums over V (dr, dk, dlw) and over K (dv) stay inside the CTA and
// need no per-tile partials. du sums over the batch as well: each CTA writes
// its (K,) partial, and a second kernel adds the partials of each head in
// batch order. No float atomics: the same bits on every run. Shared tiles as
// in the forward, rows padded by one word; two state buffers swap roles, the
// chunk's S0 becoming the previous chunk's S_end. expf, no fast-math flag.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kReduceThreads = 256;
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// shared floats: dS, Sa, Sb (K x V+1 each); r, k, cum, qex, rq, kl, drc, dkc
// (C x K+1 each); v, dy (C x V+1 each); A, G (C x C each); D, gdiag (C);
// elast, glast (K)
__host__ __device__ inline size_t bwd_smem_floats(int K, int V, int C) {
  return 3 * (size_t)K * (V + 1) + 8 * (size_t)C * (K + 1) + 2 * (size_t)C * (V + 1) +
         2 * (size_t)C * C + 2 * C + 2 * K;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) wkv_bwd_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ lw, const float* __restrict__ u,
    const float* __restrict__ states, const float* __restrict__ s_out,
    const T* __restrict__ dy, const float* __restrict__ ds_out, T* __restrict__ dr,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dlw,
    float* __restrict__ du_part, float* __restrict__ ds0, int T_len, int H, int K, int V,
    int C) {
  extern __shared__ float sm[];
  const int KP = K + 1, VP = V + 1;
  float* dS = sm;                        // K x VP
  float* S0 = dS + (size_t)K * VP;       // this chunk's starting state
  float* Se = S0 + (size_t)K * VP;       // the state after this chunk
  float* rs = Se + (size_t)K * VP;       // C x KP
  float* ks = rs + (size_t)C * KP;
  float* cum = ks + (size_t)C * KP;
  float* qex = cum + (size_t)C * KP;
  float* rq = qex + (size_t)C * KP;
  float* kl = rq + (size_t)C * KP;
  float* drc = kl + (size_t)C * KP;
  float* dkc = drc + (size_t)C * KP;
  float* vs = dkc + (size_t)C * KP;      // C x VP
  float* dys = vs + (size_t)C * VP;
  float* A = dys + (size_t)C * VP;       // C x C
  float* G = A + (size_t)C * C;
  float* D = G + (size_t)C * C;          // C
  float* gdiag = D + C;
  float* elast = gdiag + C;              // K
  float* glast = elast + K;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int nc = T_len / C;
  const float* uh = u + (size_t)h * K;
  float du_acc = 0.0f;  // threads tid < K: du's partial for k = tid

  for (int i = tid; i < K * V; i += kThreads) {
    const int o = (i / V) * VP + i % V;
    dS[o] = ds_out == nullptr ? 0.0f : ds_out[(size_t)bh * K * V + i];
    Se[o] = s_out[(size_t)bh * K * V + i];
  }

  for (int c = nc - 1; c >= 0; --c) {
    const float* src = states + ((size_t)bh * nc + c) * K * V;
    for (int i = tid; i < K * V; i += kThreads) S0[(i / V) * VP + i % V] = src[i];
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
      dys[t * VP + vv] = to_f(dy[g]);
    }
    __syncthreads();
    for (int kk = tid; kk < K; kk += kThreads) {
      float run = 0.0f;
      for (int t = 0; t < C; ++t) {
        const float l = cum[t * KP + kk];
        qex[t * KP + kk] = run;
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
      float a = 0.0f;
      if (s < t) {
        const float* rt = rs + t * KP;
        const float* qt = qex + t * KP;
        const float* ksr = ks + s * KP;
        const float* cs = cum + s * KP;
        for (int kk = 0; kk < K; ++kk) a = fmaf(rt[kk] * ksr[kk], expf(qt[kk] - cs[kk]), a);
      }
      A[t * C + s] = a;
      float g = 0.0f;
      for (int vv = 0; vv < V; ++vv) g = fmaf(dys[t * VP + vv], vs[s * VP + vv], g);
      G[t * C + s] = g;
    }
    for (int t = tid; t < C; t += kThreads) {
      float acc = 0.0f;
      for (int kk = 0; kk < K; ++kk) acc = fmaf(rs[t * KP + kk] * uh[kk], ks[t * KP + kk], acc);
      D[t] = acc;
    }
    for (int kk = tid; kk < K; kk += kThreads) {
      float acc = 0.0f;
      for (int vv = 0; vv < V; ++vv) acc = fmaf(dS[kk * VP + vv], Se[kk * VP + vv], acc);
      glast[kk] = acc;
    }
    __syncthreads();
    for (int t = tid; t < C; t += kThreads) gdiag[t] = G[t * C + t];
    // dv per (s, v)
    for (int i = tid; i < C * V; i += kThreads) {
      const int s = i / V, vv = i % V;
      float acc = 0.0f;
      for (int kk = 0; kk < K; ++kk) acc = fmaf(kl[s * KP + kk], dS[kk * VP + vv], acc);
      for (int t = s + 1; t < C; ++t) acc = fmaf(A[t * C + s], dys[t * VP + vv], acc);
      acc = fmaf(D[s], dys[s * VP + vv], acc);
      const size_t g = (((size_t)b * T_len + (size_t)c * C + s) * H + h) * V + vv;
      dv[g] = from_f<T>(acc);
    }
    // dr per (t, k) and dk per (s, k)
    for (int i = tid; i < C * K; i += kThreads) {
      const int t = i / K, kk = i % K;
      const float q = qex[t * KP + kk];
      float acc = 0.0f;
      for (int vv = 0; vv < V; ++vv) acc = fmaf(dys[t * VP + vv], S0[kk * VP + vv], acc);
      acc *= expf(q);
      for (int s = 0; s < t; ++s)
        acc = fmaf(G[t * C + s] * ks[s * KP + kk], expf(q - cum[s * KP + kk]), acc);
      acc = fmaf(uh[kk] * ks[t * KP + kk], G[t * C + t], acc);
      drc[t * KP + kk] = acc;
    }
    for (int i = tid; i < C * K; i += kThreads) {
      const int s = i / K, kk = i % K;
      const float cs = cum[s * KP + kk];
      float acc = 0.0f;
      for (int vv = 0; vv < V; ++vv) acc = fmaf(vs[s * VP + vv], dS[kk * VP + vv], acc);
      acc *= expf(cum[(C - 1) * KP + kk] - cs);
      for (int t = s + 1; t < C; ++t)
        acc = fmaf(G[t * C + s] * rs[t * KP + kk], expf(qex[t * KP + kk] - cs), acc);
      acc = fmaf(rs[s * KP + kk] * uh[kk], G[s * C + s], acc);
      dkc[s * KP + kk] = acc;
    }
    __syncthreads();
    // write dr and dk; dlw by a reverse scan per k column; du's partial
    for (int i = tid; i < C * K; i += kThreads) {
      const int t = i / K, kk = i % K;
      const size_t g = (((size_t)b * T_len + (size_t)c * C + t) * H + h) * K + kk;
      dr[g] = from_f<T>(drc[t * KP + kk]);
      dk[g] = from_f<T>(dkc[t * KP + kk]);
    }
    for (int kk = tid; kk < K; kk += kThreads) {
      const float uk = uh[kk];
      float run = glast[kk];
      float gq_next = 0.0f;  // g_qex of token j + 1
      float du_chunk = 0.0f;  // the chunk's share of du, added whole: shorter sums
      for (int j = C - 1; j >= 0; --j) {
        const float rj = rs[j * KP + kk], kj = ks[j * KP + kk], gj = gdiag[j];
        run += gq_next - kj * (dkc[j * KP + kk] - rj * uk * gj);
        const size_t g = (((size_t)b * T_len + (size_t)c * C + j) * H + h) * K + kk;
        dlw[g] = run;
        gq_next = rj * (drc[j * KP + kk] - uk * kj * gj);
        du_chunk = fmaf(rj * kj, gj, du_chunk);
      }
      du_acc += du_chunk;
    }
    // the gradient of the chunk's starting state, in place
    for (int i = tid; i < K * V; i += kThreads) {
      const int kk = i / V, vv = i % V;
      float acc = elast[kk] * dS[kk * VP + vv];
      for (int t = 0; t < C; ++t) acc = fmaf(rq[t * KP + kk], dys[t * VP + vv], acc);
      dS[kk * VP + vv] = acc;
    }
    __syncthreads();
    float* tmp = Se;  // this chunk's S0 is the previous chunk's S_end
    Se = S0;
    S0 = tmp;
  }
  for (int i = tid; i < K * V; i += kThreads)
    ds0[(size_t)bh * K * V + i] = dS[(i / V) * VP + i % V];
  if (tid < K) du_part[(size_t)bh * K + tid] = du_acc;
}

// du (H, K) = sum over b, in batch order, of du_part (B*H, K)
__global__ void __launch_bounds__(kReduceThreads) wkv_du_reduce_kernel(
    const float* __restrict__ du_part, float* __restrict__ du, int B, int H, int K) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= H * K) return;
  float acc = 0.0f;
  for (int b = 0; b < B; ++b) acc += du_part[(size_t)b * H * K + i];
  du[i] = acc;
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* lw, const void* u,
           const void* states, const void* s_out, const void* dy, const void* ds_out,
           void* dr, void* dk, void* dv, void* dlw, void* du_part, void* du, void* ds0,
           int B, int T_len, int H, int K, int V, int C, cudaStream_t s) {
  const size_t bytes = bwd_smem_floats(K, V, C) * sizeof(float);
  if (bytes > (size_t)kMaxSmem || K > kThreads) return (int)cudaErrorInvalidValue;
  // raised once per size, at the first call (outside any CUDA graph capture)
  static size_t attr_bytes = 0;
  cudaError_t err;
  if (bytes > attr_bytes) {
    err = cudaFuncSetAttribute(wkv_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    attr_bytes = bytes;
  }
  wkv_bwd_kernel<T><<<B * H, kThreads, bytes, s>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)lw, (const float*)u,
      (const float*)states, (const float*)s_out, (const T*)dy, (const float*)ds_out,
      (T*)dr, (T*)dk, (T*)dv, (float*)dlw, (float*)du_part, (float*)ds0, T_len, H, K, V, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv_du_reduce_kernel<<<(H * K + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0,
                         s>>>((const float*)du_part, (float*)du, B, H, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The gradients of wkv_fwd on `stream`; T_len % C == 0, B * H >= 1, K <= 512.
// ds_out may be null (a zero gradient of the final state). du_part is
// scratch of B * H * K floats. bf16 != 0: r, k, v, dy, dr, dk and dv are
// bf16, else f32. Returns cudaGetLastError() after the two launches (0 when
// both were accepted), or cudaErrorInvalidValue when one chunk's tiles
// exceed shared memory.
int wkv_bwd(const void* r, const void* k, const void* v, const void* lw, const void* u,
            const void* states, const void* s_out, const void* dy, const void* ds_out,
            void* dr, void* dk, void* dv, void* dlw, void* du_part, void* du, void* ds0,
            int B, int T_len, int H, int K, int V, int C, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(r, k, v, lw, u, states, s_out, dy, ds_out, dr, dk, dv,
                                 dlw, du_part, du, ds0, B, T_len, H, K, V, C, s);
  return launch<float>(r, k, v, lw, u, states, s_out, dy, ds_out, dr, dk, dv, dlw, du_part,
                       du, ds0, B, T_len, H, K, V, C, s);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
