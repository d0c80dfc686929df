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
// Math, per (b, h) and chunk, with dS the gradient of the state after the
// chunk (ds_out for the last one), cum, q_ex, A[t,s] (s < t) and D_t =
// sum_k r_t u k_t as in the forward, and G[t,s] = dy_t . v_s:
//   dv_s = (k_s e^{cum_last - cum_s}) dS + sum_{t>s} A[t,s] dy_t + D_s dy_s
//   dr_t = e^{q_ex_t} (S0 dy_t) + sum_{s<t} G[t,s] k_s e^{q_ex_t - cum_s} + u k_t G[t,t]
//   dk_s = e^{cum_last - cum_s} (dS v_s) + sum_{t>s} G[t,s] r_t e^{q_ex_t - cum_s}
//          + r_s u G[s,s]
//   du  += sum_t r_t k_t G[t,t]
//   dlw_j = g_last + sum_{t>=j} g_cum_t + sum_{t>j} g_qex_t, where
//          g_last = rowsum(dS o S_end), g_qex_t = r_t (dr_t - u k_t G[t,t]),
//          g_cum_t = -k_t (dk_t - r_t u G[t,t])
//   and the gradient of the state before the chunk is
//   e^{cum_last} dS + sum_t (r_t e^{q_ex_t}) dy_t^T,
// with S0 the chunk's starting state and S_end the state after it. These are
// the per-token rules (dr_t = S_{t-1} dy_t + ..., dlw_t = w_t rowsum(dS_t o
// S_{t-1}), dS_{t-1} = w_t dS_t + r_t dy_t^T) summed over a chunk in closed
// form: every exponent is <= 0 as in the forward, and nothing divides by a
// decay (w_t reaches e^-8). The derivative by the log-decays goes through
// cum and q_ex, whose gradients the reverse cumsum over the chunk turns into
// dlw.
//
// Bound: operations. At the training shape (B*H = 320, T = 512, K = V = 64,
// C = 32, bf16 r/k/v/dy, no state cotangent) the function reads r, k, v, lw,
// u, s0 and dy once and writes the six gradients once: 241 MB (0.072 ms at
// 3.35 TB/s), or 325 MB (0.097 ms) counting the 84 MB of chunk states B6
// writes for it, against 7.78 GFLOP of f32 work (0.116 ms at 67 TFLOP/s),
// 530 M of it exponentials (A and the two decayed sums, three per (t, s, k)).
// This design moves 679 MB (0.203 ms): the state-gradient pass reads r, lw
// and dy (dy once per 32 rows of K) and writes the state gradients (84 MB)
// and ds0; the gradient pass reads r, k, v, lw, dy, the chunk states, the
// state gradients and each chunk's state after it (84 MB each) and writes
// the gradients and du's partials.
//
// Design: three kernels on the caller's stream, one launch of wkv_bwd. Only
// the state gradient dS has to be carried from chunk to chunk; B6 already
// wrote every chunk's starting state, so once each chunk's dS is known its
// other gradients need nothing from any other chunk, and a walk of the
// chunks by one CTA per (b, h) (320 CTAs, 2.4 waves at one an SM) is left
// to the small serial part alone.
//
// 1. State-gradient pass, wkv_bwd_dstate_kernel, the only serial part. Grid
//    (B*H, K/32, V/64), 128 threads, as wkv.cu's state pass: each CTA owns a
//    32 x 64 block of one (b, h)'s dS in registers, 8 x 2 a thread, a warp 8
//    rows by 64 columns, so the 8 factors it reads per token are one
//    broadcast. Starting from ds_out (or zero) it walks the chunks backwards;
//    at each it first writes its block of the gradient of the state after
//    the chunk to `dstates` (B*H, T/C, K, V) f32, then updates dS <-
//    e^{cum_last} dS + sum_t (r_t e^{q_ex_t}) dy_t^T in token order. The
//    next two chunks' r, lw, dy tiles are in flight (cp.async, two stages).
//    At the end it writes ds0.
// 2. Gradient pass, wkv_bwd_grad_kernel, with no serial dependence. Grid
//    (B*H, T/C), 128 threads (5,120 CTAs at the training shape, three an
//    SM, 73 KB of shared memory): each CTA loads one chunk's r, k, lw, dy, v,
//    its starting state S0 = states[bh, c] and, once S0 is used, its state
//    gradient dS = dstates[bh, c] into the same tile (the K x V tiles are
//    never resident together). S_end, for g_last, is read from the next
//    chunk's state (s_out for the last chunk), so every sum keeps the order
//    it had; the scan threads ask for their row of it under dr's sums.
//    dr, dk and dv run on 8 x 2 register tiles a thread, a warp 8 rows by 64
//    columns (columns lane and lane + 32). A warp's 8 rows are two blocks of
//    4 from either end of the chunk (block p and block C/4 - 1 - p), so
//    every warp has the same share of the triangles (s < t), and each block
//    takes the pairs below it without a predicate:
//    - both operands x-contiguous (dy S0^T, v dS^T, G = dy v^T): the 8 rows
//      of the first are read as 16-byte broadcasts, the second's rows 16
//      bytes a lane, rows padded to an odd number of 16-byte words so the
//      8 lanes of a quarter-warp hit distinct banks; 4 steps of the sum a
//      load, 64 multiply-adds per 10 loads;
//    - the others (kl dS, A dy, and the decayed sums of dr and dk) read the
//      row operand as broadcasts and the column operand one word a lane;
//    - A as wkv.cu's output pass builds it: 2 x 1 (t, s) tiles, no masked
//      lanes, the one pair outside the triangle given exponent 0 and dropped;
//      stored with t as the row, so dv's sum over t reads it by rows.
//    dr and dk stay in registers until the reverse scan, which runs one
//    thread per column of K in token order, as before, and writes dlw and the
//    chunk's share of du to a partial (B*H, T/C, K).
// 3. du, wkv_bwd_du_reduce_kernel: du[h, k] sums over b in batch order, each
//    b's term the chunk partials summed from the last chunk down, the order
//    of the one-kernel design.
// Every sum runs in the order of the per-(b, h) walk (dS over tokens, each
// gradient's terms, the reverse scan, du over chunks then the batch), so the
// results do not depend on the grid. No float atomics: the same bits on
// every run. No tensor cores, so no TF32. expf, not __expf, and no
// fast-math flag.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;  // the most a block may use on sm_90
constexpr int kBK = 32, kBV = 64;  // the dS block of one state-gradient CTA
constexpr int kStateThreads = 32 * kBK / 8;  // a warp for each 8 rows
constexpr int kGradThreads = 128;  // the training shape's gradient pass
constexpr int kMaxGradThreads = 512;  // the general instantiation's limit
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// four consecutive elements as f32; p is aligned to four elements
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// inclusive cumsum in place down column `col` of `rows` rows (row stride ld),
// in row order; eight loads in flight ahead of the chain of adds. Returns the
// column's total.
__device__ __forceinline__ float column_cumsum(float* x, int ld, int rows, int col) {
  float run = 0.0f;
  for (int t0 = 0; t0 < rows; t0 += 8) {
    float l[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) l[j] = t0 + j < rows ? x[(t0 + j) * ld + col] : 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (t0 + j < rows) {
        run += l[j];
        x[(t0 + j) * ld + col] = run;
      }
    }
  }
  return run;
}

// ------------------------------------------------------ state-gradient pass

template <typename T>
__host__ __device__ inline size_t dstate_stage_bytes(int C) {
  return (size_t)C * (kBK * sizeof(T) + kBV * sizeof(T) + kBK * sizeof(float));
}

// two stages of raw tiles (r, dy of T, lw f32), then rq, dyf (f32) and elast
template <typename T>
__host__ __device__ inline size_t dstate_smem_bytes(int C) {
  return 2 * dstate_stage_bytes<T>(C) + ((size_t)C * (kBK + kBV) + kBK) * sizeof(float);
}

// vec: r, dy, lw and dstates 16-byte aligned, K and V multiples of a 16-byte
// chunk: cp.async tiles and 8-byte stores of the state gradients; else plain
// loads and stores.
template <typename T, int KT, int VT, int CT>
__global__ void __launch_bounds__(kStateThreads, 5) wkv_bwd_dstate_kernel(
    const T* __restrict__ r, const T* __restrict__ dy, const float* __restrict__ lw,
    const float* __restrict__ ds_out, float* __restrict__ ds0, float* __restrict__ dstates,
    int T_len, int H, int K_, int V_, int C_, int vec) {
  const int K = KT ? KT : K_, V = VT ? VT : V_, C = CT ? CT : C_;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t stage = dstate_stage_bytes<T>(C);
  const size_t tile_r = (size_t)C * kBK * sizeof(T), tile_y = (size_t)C * kBV * sizeof(T);
  float* rq = reinterpret_cast<float*>(smem + 2 * stage);  // C x kBK: r e^{q_ex}
  float* yf = rq + C * kBK;                                // C x kBV: dy in f32
  float* elast = yf + C * kBV;                             // kBK: e^{cum_last}

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kBK, v0 = blockIdx.z * kBV;
  const int nk = min(kBK, K - k0), nv = min(kBV, V - v0);
  const int tid = threadIdx.x;
  const int nc = T_len / C;
  // this thread's 8 x 2 tile of the block: rows kr..kr+7 (one warp's rows,
  // so their rq loads are broadcasts), columns vc, vc + 1
  const int kr = 8 * (tid >> 5), vc = 2 * (tid & 31);

  float dS[8][2];
  const float* dsb = ds_out == nullptr ? nullptr : ds_out + (size_t)bh * K * V;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      dS[i][j] = dsb != nullptr && kr + i < nk && vc + j < nv
                     ? dsb[(size_t)(k0 + kr + i) * V + v0 + vc + j]
                     : 0.0f;

  auto tiles = [&](int st) { return smem + st * stage; };
  auto load_chunk = [&](int c, int st) {
    T* rt = reinterpret_cast<T*>(tiles(st));
    T* yt = reinterpret_cast<T*>(tiles(st) + tile_r);
    float* lt = reinterpret_cast<float*>(tiles(st) + tile_r + tile_y);
    const size_t row0 = (size_t)b * T_len + (size_t)c * C;
    if (vec) {
      constexpr int E = 16 / sizeof(T);  // elements of r or dy in a 16-byte chunk
      constexpr int cr = kBK / E, cy = kBV / E, cl = kBK / 4, per_row = cr + cy + cl;
      for (int i = tid; i < C * per_row; i += kStateThreads) {
        const int t = i / per_row, j = i - t * per_row;
        const size_t tok = (row0 + t) * H + h;
        if (j < cr) {
          const int col = j * E;
          if (col < nk) cp_async16(rt + t * kBK + col, r + tok * K + k0 + col);
        } else if (j < cr + cy) {
          const int col = (j - cr) * E;
          if (col < nv) cp_async16(yt + t * kBV + col, dy + tok * V + v0 + col);
        } else {
          const int col = (j - cr - cy) * 4;
          if (col < nk) cp_async16(lt + t * kBK + col, lw + tok * K + k0 + col);
        }
      }
    } else {
      for (int i = tid; i < C * kBK; i += kStateThreads) {
        const int t = i / kBK, col = i % kBK;
        const size_t g = ((row0 + t) * H + h) * K + k0 + col;
        if (col < nk) {
          rt[i] = r[g];
          lt[i] = lw[g];
        }
      }
      for (int i = tid; i < C * kBV; i += kStateThreads) {
        const int t = i / kBV, col = i % kBV;
        if (col < nv) yt[i] = dy[((row0 + t) * H + h) * V + v0 + col];
      }
    }
  };

  // chunks walk backwards: step i takes chunk nc - 1 - i from stage i & 1
  if (vec) {
    load_chunk(nc - 1, 0);
    cp_async_commit();
    if (nc > 1) load_chunk(nc - 2, 1);
    cp_async_commit();
  }
  float* ds_bh = dstates + (size_t)bh * nc * K * V;
  for (int i_step = 0; i_step < nc; ++i_step) {
    const int c = nc - 1 - i_step, st = i_step & 1;
    // the gradient of the state after chunk c
    float* dst = ds_bh + (size_t)c * K * V;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (kr + i >= nk) continue;
      float* row = dst + (size_t)(k0 + kr + i) * V + v0 + vc;
      if (vec && vc < nv) {
        *reinterpret_cast<float2*>(row) = make_float2(dS[i][0], dS[i][1]);
      } else {
        if (vc < nv) row[0] = dS[i][0];
        if (vc + 1 < nv) row[1] = dS[i][1];
      }
    }
    if (vec) cp_async_wait<1>();  // chunk c's group has landed (the next may fly)
    else load_chunk(c, st);
    __syncthreads();
    const T* rt = reinterpret_cast<const T*>(tiles(st));
    const T* yt = reinterpret_cast<const T*>(tiles(st) + tile_r);
    float* cum = reinterpret_cast<float*>(tiles(st) + tile_r + tile_y);
    if (tid < kBK) elast[tid] = tid < nk ? expf(column_cumsum(cum, kBK, C, tid)) : 0.0f;
    __syncthreads();
    // q_ex_t is the sum before token t: cum_{t-1}, 0 for the first token
    for (int i = tid; i < C * kBK; i += kStateThreads) {
      const int j = i % kBK;
      rq[i] = j < nk ? to_f(rt[i]) * expf(i >= kBK ? cum[i - kBK] : 0.0f) : 0.0f;
    }
    for (int i = 4 * tid; i < C * kBV; i += 4 * kStateThreads) {
      const int col = i % kBV;
      float4 w = load4(yt + i);  // a row's padding past nv is zeroed here
      if (col + 3 >= nv) {
        w.x = col < nv ? w.x : 0.0f;
        w.y = col + 1 < nv ? w.y : 0.0f;
        w.z = col + 2 < nv ? w.z : 0.0f;
        w.w = 0.0f;
      }
      *reinterpret_cast<float4*>(yf + i) = w;
    }
    __syncthreads();
    // this stage is free: the chunk two steps on lands in it while dS updates
    if (vec) {
      if (c >= 2) load_chunk(c - 2, st);
      cp_async_commit();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float e = elast[kr + i];
      dS[i][0] *= e;
      dS[i][1] *= e;
    }
#pragma unroll
    for (int t = 0; t < C; ++t) {
      const float4 a0 = *reinterpret_cast<const float4*>(rq + t * kBK + kr);
      const float4 a1 = *reinterpret_cast<const float4*>(rq + t * kBK + kr + 4);
      const float2 w = *reinterpret_cast<const float2*>(yf + t * kBV + vc);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        dS[i][0] = fmaf(a[i], w.x, dS[i][0]);
        dS[i][1] = fmaf(a[i], w.y, dS[i][1]);
      }
    }
  }
  float* out = ds0 + (size_t)bh * K * V;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (kr + i < nk && vc + j < nv) out[(size_t)(k0 + kr + i) * V + v0 + vc + j] = dS[i][j];
}

// ------------------------------------------------------------ gradient pass

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int round8(int x) { return (x + 7) & ~7; }
// a row stride of at least n floats, 16-byte aligned, and an odd number of
// 16-byte words, so 8 consecutive rows read 16 bytes a lane hit distinct banks
__host__ __device__ inline int odd_words(int n) {
  const int s = round4(n);
  return (s / 4) % 2 ? s : s + 4;
}

// offsets in floats of the gradient pass's shared tiles, each C rows unless
// said: r, k, cum (row t the inclusive cumsum to t, so q_ex_t is row t - 1)
// of stride ks; dy, v of stride vs; X, round4(K) rows of stride vs (S0, then
// dS); kl, then A in its place once dv's first term is done; G (stride cs);
// D. At the reverse scan dr and dk take cum's place and the tiles after it.
struct GradLayout {
  int ks, vs, cs, r, k, cum, dy, v, x, kla, g, d, total;
};
__host__ __device__ inline GradLayout grad_layout(int K, int V, int C) {
  GradLayout l;
  l.ks = odd_words(K);
  l.vs = odd_words(V);
  l.cs = odd_words(round8(C));  // A's and G's rows are read 8 columns at a time
  l.r = 0;
  l.k = l.r + C * l.ks;
  l.cum = l.k + C * l.ks;
  l.dy = l.cum + C * l.ks;
  l.v = l.dy + C * l.vs;
  l.x = l.v + C * l.vs;
  l.kla = l.x + round4(K) * l.vs;
  l.g = l.kla + (l.ks > l.cs ? C * l.ks : C * l.cs);
  l.d = l.g + C * l.cs;
  l.total = l.d + round8(C);
  return l;
}

// threads a CTA of the gradient pass: a warp for each 8 rows x 64 columns of
// dr, dk and dv, and a thread for each column of K at the reverse scan
__host__ __device__ inline int grad_threads(int K, int V, int C) {
  const int rows = (C + 7) / 8;
  const int need[3] = {rows * ((K + 63) / 64), rows * ((V + 63) / 64), (K + 31) / 32};
  int w = 4;
  for (int n : need) w = n > w ? n : w;
  return 32 * w;
}

template <int CT>
struct GradBounds {  // the training shape's instantiation holds 3 CTAs an SM
  static constexpr int threads = CT ? kGradThreads : kMaxGradThreads;
  static constexpr int blocks = CT ? 3 : 1;
};

// acc[i][j] += sum over x < n4 of P[row i][x] Q[col j][x]: P's 8 rows are
// broadcasts (p[i] their starts), Q's two rows one a lane, 4 steps a load, in
// order of x
__device__ __forceinline__ void rows_dot_rows(float (&acc)[8][2], const float* const* p,
                                              const float* q0, const float* q1, int n4) {
#pragma unroll 2
  for (int x = 0; x < n4; x += 4) {
    const float4 w0 = lds4(q0 + x), w1 = lds4(q1 + x);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 a = lds4(p[i] + x);
      acc[i][0] = fmaf(a.x, w0.x, acc[i][0]);
      acc[i][1] = fmaf(a.x, w1.x, acc[i][1]);
      acc[i][0] = fmaf(a.y, w0.y, acc[i][0]);
      acc[i][1] = fmaf(a.y, w1.y, acc[i][1]);
      acc[i][0] = fmaf(a.z, w0.z, acc[i][0]);
      acc[i][1] = fmaf(a.z, w1.z, acc[i][1]);
      acc[i][0] = fmaf(a.w, w0.w, acc[i][0]);
      acc[i][1] = fmaf(a.w, w1.w, acc[i][1]);
    }
  }
}

// vec: K % 4 == 0, V % 4 == 0 and r, k, v, lw, dy, states, dstates, s_out
// 16-byte aligned: four elements a load and cp.async for the K x V tiles;
// else one element a load.
template <typename T, int KT, int VT, int CT>
__global__ void __launch_bounds__(GradBounds<CT>::threads, GradBounds<CT>::blocks)
    wkv_bwd_grad_kernel(const T* __restrict__ r, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ lw,
                        const float* __restrict__ u, const float* __restrict__ states,
                        const float* __restrict__ s_out, const float* __restrict__ dstates,
                        const T* __restrict__ dy, T* __restrict__ dr, T* __restrict__ dk,
                        T* __restrict__ dv, float* __restrict__ dlw,
                        float* __restrict__ du_part, int T_len, int H, int K_, int V_, int C_,
                        int vec) {
  const int K = KT ? KT : K_, V = VT ? VT : V_, C = CT ? CT : C_;
  const GradLayout L = grad_layout(K, V, C);
  const int ks = L.ks, vs = L.vs, cs = L.cs;
  const int K4 = round4(K), V4 = round4(V);
  extern __shared__ __align__(16) float sm[];
  float* rs = sm + L.r;
  float* kt = sm + L.k;
  float* cum = sm + L.cum;
  float* ys = sm + L.dy;
  float* vt = sm + L.v;
  float* X = sm + L.x;
  float* KL = sm + L.kla;
  float* As = KL;
  float* G = sm + L.g;
  float* D = sm + L.d;

  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const int nc = T_len / C;
  const size_t tok0 = (size_t)b * T_len + (size_t)c * C;
  const size_t kv = (size_t)K * V;
  const float* S0g = states + ((size_t)bh * nc + c) * kv;
  const float* dSg = dstates + ((size_t)bh * nc + c) * kv;
  const float* Seg = c + 1 < nc ? S0g + kv : s_out + (size_t)bh * kv;
  const float* uh = u + (size_t)h * K;

  // a K x V tile from global into X (round4(K) rows of stride vs, padding zero)
  auto load_state = [&](const float* src) {
    if (vec) {
      for (int i = tid; i < (int)(kv >> 2); i += nthreads) {
        const int e = i << 2, kk = e / V, vv = e - kk * V;
        cp_async16(X + kk * vs + vv, src + e);
      }
      cp_async_commit();
    } else {
      for (int i = tid; i < K4 * V4; i += nthreads) {
        const int kk = i / V4, vv = i - kk * V4;
        X[kk * vs + vv] = kk < K && vv < V ? src[(size_t)kk * V + vv] : 0.0f;
      }
    }
  };

  // the chunk's tiles: token t of the chunk is row t; columns up to round4
  // are zero past K or V
  if (vec) {
    for (int i = tid; i < (C * K) >> 2; i += nthreads) {
      const int e = i << 2, t = e / K, kk = e - t * K;
      const size_t g = ((tok0 + t) * H + h) * K + kk;
      *reinterpret_cast<float4*>(rs + t * ks + kk) = load4(r + g);
      *reinterpret_cast<float4*>(kt + t * ks + kk) = load4(k + g);
      *reinterpret_cast<float4*>(cum + t * ks + kk) = load4(lw + g);
    }
    for (int i = tid; i < (C * V) >> 2; i += nthreads) {
      const int e = i << 2, t = e / V, vv = e - t * V;
      const size_t g = ((tok0 + t) * H + h) * V + vv;
      *reinterpret_cast<float4*>(ys + t * vs + vv) = load4(dy + g);
      *reinterpret_cast<float4*>(vt + t * vs + vv) = load4(v + g);
    }
  } else {
    for (int i = tid; i < C * K4; i += nthreads) {
      const int t = i / K4, kk = i - t * K4;
      const size_t g = ((tok0 + t) * H + h) * K + kk;
      const bool in = kk < K;
      rs[t * ks + kk] = in ? to_f(r[g]) : 0.0f;
      kt[t * ks + kk] = in ? to_f(k[g]) : 0.0f;
      cum[t * ks + kk] = in ? lw[g] : 0.0f;
    }
    for (int i = tid; i < C * V4; i += nthreads) {
      const int t = i / V4, vv = i - t * V4;
      const size_t g = ((tok0 + t) * H + h) * V + vv;
      ys[t * vs + vv] = vv < V ? to_f(dy[g]) : 0.0f;
      vt[t * vs + vv] = vv < V ? to_f(v[g]) : 0.0f;
    }
    load_state(S0g);
  }
  __syncthreads();
  // S0, read only by dr's first term, comes by cp.async under the cumsum and G
  if (vec) load_state(S0g);
  for (int kk = tid; kk < K; kk += nthreads) column_cumsum(cum, ks, C, kk);
  __syncthreads();

  // G = dy v^T, all (t, s): a warp takes 8 rows t and 32 columns s, one a lane
  {
    const int ncs = (C + 31) / 32;
    for (int task = warp; task < ((C + 7) / 8) * ncs; task += nwarps) {
      const int t0 = 8 * (task / ncs), s = 32 * (task % ncs) + lane;
      const float* p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) p[i] = ys + min(t0 + i, C - 1) * vs;
      const float* q = vt + min(s, C - 1) * vs;
      float acc[8] = {};
#pragma unroll 2
      for (int x = 0; x < V4; x += 4) {
        const float4 w = lds4(q + x);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 a = lds4(p[i] + x);
          acc[i] = fmaf(a.x, w.x, acc[i]);
          acc[i] = fmaf(a.y, w.y, acc[i]);
          acc[i] = fmaf(a.z, w.z, acc[i]);
          acc[i] = fmaf(a.w, w.w, acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (t0 + i < C && s < C) G[(t0 + i) * cs + s] = acc[i];
    }
  }
  // kl = k e^{cum_last - cum}
  for (int i = tid; i < C * K4; i += nthreads) {
    const int t = i / K4, kk = i - t * K4;
    KL[t * ks + kk] = kt[t * ks + kk] * expf(cum[(C - 1) * ks + kk] - cum[t * ks + kk]);
  }
  // D: row t on lane t / nwarps of warp t % nwarps
  for (int t = lane * nwarps + warp; t < C; t += nthreads) {
    float acc = 0.0f;
    for (int kk = 0; kk < K; ++kk) acc = fmaf(rs[t * ks + kk] * uh[kk], kt[t * ks + kk], acc);
    D[t] = acc;
  }
  if (vec) cp_async_wait<0>();
  __syncthreads();

  // dr, dk and dv on 8 x 2 tiles: a warp's 8 rows are two blocks of 4, block
  // p and its mirror ng4 - 1 - p, so every warp's share of the triangles (s <
  // t) is the same; its columns are col0 + lane and col0 + lane + 32
  const int ng4 = (C + 3) / 4;
  auto tile_rows = [&](int p, int (&row)[8], bool (&keep)[8], int (&base)[2]) {
    base[0] = 4 * p;
    base[1] = 4 * (ng4 - 1 - p);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      row[i] = base[i / 4] + (i & 3);
      keep[i] = row[i] < C && (i < 4 || base[1] != base[0]);
      row[i] = min(row[i], C - 1);  // rows not kept read a valid row, store nothing
    }
  };
  const int ncg = (K + 63) / 64;
  const bool owns = warp < ((C + 7) / 8) * ncg;
  int trow[8], tbase[2];
  bool tkeep[8];
  tile_rows(warp / ncg, trow, tkeep, tbase);
  const bool two = tbase[1] != tbase[0];
  const int col0 = 64 * (warp % ncg) + lane;
  const int kc[2] = {min(col0, K - 1), min(col0 + 32, K - 1)};
  float acc_dr[8][2] = {}, acc_dk[8][2] = {};
  const float* prow[8];

  // dr's first term: e^{q_ex_t} (S0 dy_t)
  if (owns) {
#pragma unroll
    for (int i = 0; i < 8; ++i) prow[i] = ys + trow[i] * vs;
    rows_dot_rows(acc_dr, prow, X + kc[0] * vs, X + kc[1] * vs, V4);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = trow[i];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        acc_dr[i][j] *= expf(t > 0 ? cum[(t - 1) * ks + kc[j]] : 0.0f);
    }
  }
  __syncthreads();
  load_state(dSg);  // S0 is done with: dS lands in its place under dr's sums
  // the scan threads' row of S_end, for g_last, from device memory: at the
  // training shape asked for here, in flight under dr's sums
  constexpr int kPre = VT ? VT / 4 : 1;
  float4 se_pre[kPre];
  const bool pre = VT && vec && tid < K;
  if (pre) {
#pragma unroll
    for (int i = 0; i < kPre; ++i)
      se_pre[i] = *reinterpret_cast<const float4*>(Seg + (size_t)tid * V + 4 * i);
  }
  if (owns) {
    // sum_{s<t} G[t,s] k_s e^{q_ex_t - cum_s}, in order of s: a block's 4
    // rows all take s below the block, then the rows above s
    float q[8][2];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = max(trow[i], 1);
#pragma unroll
      for (int j = 0; j < 2; ++j) q[i][j] = cum[(t - 1) * ks + kc[j]];
    }
    // rows ii >= first of block gi take the term of s
    auto dr_terms = [&](int gi, int s, int first) {
      const float k0 = kt[s * ks + kc[0]], k1 = kt[s * ks + kc[1]];
      const float c0 = cum[s * ks + kc[0]], c1 = cum[s * ks + kc[1]];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = 4 * gi + ii;
        if (ii >= first) {
          const float g = G[trow[i] * cs + s];
          acc_dr[i][0] = fmaf(g * k0, expf(q[i][0] - c0), acc_dr[i][0]);
          acc_dr[i][1] = fmaf(g * k1, expf(q[i][1] - c1), acc_dr[i][1]);
        }
      }
    };
#pragma unroll
    for (int gi = 0; gi < 2; ++gi) {
      if (gi == 1 && !two) continue;
      const int t0 = tbase[gi];
      for (int s = 0; s < t0; ++s) dr_terms(gi, s, 0);
      for (int s = t0; s < min(t0 + 3, C - 1); ++s) dr_terms(gi, s, s - t0 + 1);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = trow[i];
      const float g = G[t * cs + t];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        acc_dr[i][j] = fmaf(uh[kc[j]] * kt[t * ks + kc[j]], g, acc_dr[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (!tkeep[i]) continue;
      T* dst = dr + ((tok0 + trow[i]) * H + h) * K;
      if (col0 < K) store1(dst + col0, acc_dr[i][0]);
      if (col0 + 32 < K) store1(dst + col0 + 32, acc_dr[i][1]);
    }
  }
  if (vec) cp_async_wait<0>();
  __syncthreads();

  // the scan threads' g_last = rowsum(dS o S_end)
  float glast = 0.0f;
  if (pre) {
    const float* xs = X + tid * vs;
#pragma unroll
    for (int i = 0; i < kPre; ++i) {
      glast = fmaf(xs[4 * i], se_pre[i].x, glast);
      glast = fmaf(xs[4 * i + 1], se_pre[i].y, glast);
      glast = fmaf(xs[4 * i + 2], se_pre[i].z, glast);
      glast = fmaf(xs[4 * i + 3], se_pre[i].w, glast);
    }
  } else if (tid < K) {
    const float* xs = X + tid * vs;
    const float* se = Seg + (size_t)tid * V;
    if (vec) {
#pragma unroll 4
      for (int vv = 0; vv < V; vv += 4) {
        const float4 e = *reinterpret_cast<const float4*>(se + vv);
        glast = fmaf(xs[vv], e.x, glast);
        glast = fmaf(xs[vv + 1], e.y, glast);
        glast = fmaf(xs[vv + 2], e.z, glast);
        glast = fmaf(xs[vv + 3], e.w, glast);
      }
    } else {
      for (int vv = 0; vv < V; ++vv) glast = fmaf(xs[vv], se[vv], glast);
    }
  }

  // dv: rows s as dr's, columns vcol0 + lane, +32
  {
    const int nvg = (V + 63) / 64;
    const bool owns_v = warp < ((C + 7) / 8) * nvg;
    int srow[8], sbase[2];
    bool skeep[8];
    tile_rows(warp / nvg, srow, skeep, sbase);
    const bool stwo = sbase[1] != sbase[0];
    const int vcol0 = 64 * (warp % nvg) + lane;
    const int vcl[2] = {min(vcol0, V - 1), min(vcol0 + 32, V - 1)};
    float acc[8][2] = {};
    if (owns_v) {
      // sum_k kl[s][k] dS[k][v]
      const float* p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) p[i] = KL + srow[i] * ks;
#pragma unroll 2
      for (int x = 0; x < K4; x += 4) {
        float a[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 q4 = lds4(p[i] + x);
          a[i][0] = q4.x, a[i][1] = q4.y, a[i][2] = q4.z, a[i][3] = q4.w;
        }
#pragma unroll
        for (int xx = 0; xx < 4; ++xx) {
          const float w0 = X[(x + xx) * vs + vcl[0]], w1 = X[(x + xx) * vs + vcl[1]];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][0] = fmaf(a[i][xx], w0, acc[i][0]);
            acc[i][1] = fmaf(a[i][xx], w1, acc[i][1]);
          }
        }
      }
    }
    __syncthreads();
    // A in kl's place: the 2 x 1 tile (rows t0 = 2P and t1 = 2P + 1, column
    // s <= 2P) of tile number P^2 + s; for odd C the last row's pairs follow,
    // one a tile (t1 = t0, its copy dropped)
    const int np = C / 2;
    const int n_tiles = np * np + ((C & 1) ? C - 1 : 0);
    for (int i = tid; i < n_tiles; i += nthreads) {
      int a0r, a1r, s;
      if (i < np * np) {
        int p = (int)sqrtf((float)i);  // the row pair
        while (p * p > i) --p;
        while ((p + 1) * (p + 1) <= i) ++p;
        s = i - p * p;
        a0r = 2 * p;
        a1r = a0r + 1;
      } else {
        a0r = a1r = C - 1;
        s = i - np * np;
      }
      const bool keep0 = s < a0r, keep1 = a1r != a0r;
      const float* r0 = rs + a0r * ks;
      const float* r1 = rs + a1r * ks;
      // q_ex_t is cum row t - 1; the dropped pair (t0, t0) reads cum_s for
      // it: its exponent is 0
      const float* q0 = cum + (keep0 ? a0r - 1 : s) * ks;
      const float* q1 = cum + (a1r - 1) * ks;
      const float* kp = kt + s * ks;
      const float* cp = cum + s * ks;
      float x0 = 0.0f, x1 = 0.0f;
#pragma unroll 2
      for (int kk = 0; kk < K4; kk += 4) {
        const float4 kv4 = lds4(kp + kk), cv4 = lds4(cp + kk);
        const float4 ra = lds4(r0 + kk), rb = lds4(r1 + kk);
        const float4 qa = lds4(q0 + kk), qb = lds4(q1 + kk);
        x0 = fmaf(ra.x * kv4.x, expf(qa.x - cv4.x), x0);
        x1 = fmaf(rb.x * kv4.x, expf(qb.x - cv4.x), x1);
        x0 = fmaf(ra.y * kv4.y, expf(qa.y - cv4.y), x0);
        x1 = fmaf(rb.y * kv4.y, expf(qb.y - cv4.y), x1);
        x0 = fmaf(ra.z * kv4.z, expf(qa.z - cv4.z), x0);
        x1 = fmaf(rb.z * kv4.z, expf(qb.z - cv4.z), x1);
        x0 = fmaf(ra.w * kv4.w, expf(qa.w - cv4.w), x0);
        x1 = fmaf(rb.w * kv4.w, expf(qb.w - cv4.w), x1);
      }
      if (keep0) As[a0r * cs + s] = x0;
      if (keep1) As[a1r * cs + s] = x1;
    }
    __syncthreads();
    if (owns_v) {
      // sum_{t>s} A[t][s] dy_t in order of t: a block's 4 rows take the t
      // inside it, then all t above the block; then D_s dy_s
      // rows ii < end of block gi take the term of t
      auto dv_terms = [&](int gi, int t, int end) {
        const float4 a4 = lds4(As + t * cs + sbase[gi]);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float w0 = ys[t * vs + vcl[0]], w1 = ys[t * vs + vcl[1]];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int i = 4 * gi + ii;
          if (ii < end) {
            acc[i][0] = fmaf(a[ii], w0, acc[i][0]);
            acc[i][1] = fmaf(a[ii], w1, acc[i][1]);
          }
        }
      };
#pragma unroll
      for (int gi = 0; gi < 2; ++gi) {
        if (gi == 1 && !stwo) continue;
        const int s0 = sbase[gi];
        for (int t = s0 + 1; t < min(s0 + 4, C); ++t) dv_terms(gi, t, t - s0);
        for (int t = s0 + 4; t < C; ++t) dv_terms(gi, t, 4);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int s = srow[i];
        const float d = D[s];
        acc[i][0] = fmaf(d, ys[s * vs + vcl[0]], acc[i][0]);
        acc[i][1] = fmaf(d, ys[s * vs + vcl[1]], acc[i][1]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (!skeep[i]) continue;
        T* dst = dv + ((tok0 + srow[i]) * H + h) * V;
        if (vcol0 < V) store1(dst + vcol0, acc[i][0]);
        if (vcol0 + 32 < V) store1(dst + vcol0 + 32, acc[i][1]);
      }
    }
  }

  // dk on dr's tiles (rows s)
  if (owns) {
    // e^{cum_last - cum_s} (dS v_s)
#pragma unroll
    for (int i = 0; i < 8; ++i) prow[i] = vt + trow[i] * vs;
    rows_dot_rows(acc_dk, prow, X + kc[0] * vs, X + kc[1] * vs, V4);
    float cs_[8][2];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        cs_[i][j] = cum[trow[i] * ks + kc[j]];
        acc_dk[i][j] *= expf(cum[(C - 1) * ks + kc[j]] - cs_[i][j]);
      }
    }
    // sum_{t>s} G[t,s] r_t e^{q_ex_t - cum_s}, in order of t: a block's 4
    // rows take the t inside it, then all t above the block
    // rows ii < end of block gi take the term of t
    auto dk_terms = [&](int gi, int t, int end) {
      const float4 g4 = lds4(G + t * cs + tbase[gi]);
      const float g[4] = {g4.x, g4.y, g4.z, g4.w};
      const float r0 = rs[t * ks + kc[0]], r1 = rs[t * ks + kc[1]];
      const float q0 = cum[(t - 1) * ks + kc[0]], q1 = cum[(t - 1) * ks + kc[1]];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = 4 * gi + ii;
        if (ii < end) {
          acc_dk[i][0] = fmaf(g[ii] * r0, expf(q0 - cs_[i][0]), acc_dk[i][0]);
          acc_dk[i][1] = fmaf(g[ii] * r1, expf(q1 - cs_[i][1]), acc_dk[i][1]);
        }
      }
    };
#pragma unroll
    for (int gi = 0; gi < 2; ++gi) {
      if (gi == 1 && !two) continue;
      const int s0 = tbase[gi];
      for (int t = s0 + 1; t < min(s0 + 4, C); ++t) dk_terms(gi, t, t - s0);
      for (int t = s0 + 4; t < C; ++t) dk_terms(gi, t, 4);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = trow[i];
      const float g = G[s * cs + s];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        acc_dk[i][j] = fmaf(rs[s * ks + kc[j]] * uh[kc[j]], g, acc_dk[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (!tkeep[i]) continue;
      T* dst = dk + ((tok0 + trow[i]) * H + h) * K;
      if (col0 < K) store1(dst + col0, acc_dk[i][0]);
      if (col0 + 32 < K) store1(dst + col0 + 32, acc_dk[i][1]);
    }
  }
  __syncthreads();
  // dr and dk in f32 over cum and the tiles after it, for the scan
  float* drc = sm + L.cum;
  float* dkc = drc + C * ks;
  if (owns) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (!tkeep[i]) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = col0 + 32 * j;
        if (col < K) {
          drc[trow[i] * ks + col] = acc_dr[i][j];
          dkc[trow[i] * ks + col] = acc_dk[i][j];
        }
      }
    }
  }
  __syncthreads();
  // dlw by a reverse scan down column tid, and the chunk's share of du
  if (tid < K) {
    const int kk = tid;
    const float uk = uh[kk];
    float run = glast;
    float gq_next = 0.0f;  // g_qex of token j + 1
    float du_chunk = 0.0f;
    for (int j = C - 1; j >= 0; --j) {
      const float rj = rs[j * ks + kk], kj = kt[j * ks + kk], gj = G[j * cs + j];
      run += gq_next - kj * (dkc[j * ks + kk] - rj * uk * gj);
      dlw[((tok0 + j) * H + h) * K + kk] = run;
      gq_next = rj * (drc[j * ks + kk] - uk * kj * gj);
      du_chunk = fmaf(rj * kj, gj, du_chunk);
    }
    du_part[((size_t)bh * nc + c) * K + kk] = du_chunk;
  }
}

// du (H, K) = sum over b, in batch order, of each (b, h)'s chunk partials
// (B*H, T/C, K) summed from the last chunk down
__global__ void __launch_bounds__(kReduceThreads) wkv_bwd_du_reduce_kernel(
    const float* __restrict__ du_part, float* __restrict__ du, int B, int H, int nc, int K) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= H * K) return;
  const int h = i / K, kk = i - h * K;
  float acc = 0.0f;
  for (int b = 0; b < B; ++b) {
    const float* part = du_part + ((size_t)b * H + h) * nc * K + kk;
    float sum = 0.0f;
    int c = nc - 1;
    for (; c >= 7; c -= 8) {  // eight loads in flight ahead of the adds
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = part[(size_t)(c - j) * K];
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += x[j];
    }
    for (; c >= 0; --c) sum += part[(size_t)c * K];
    acc += sum;
  }
  du[i] = acc;
}

// ------------------------------------------------------------------- launch

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// raise a kernel's dynamic shared memory limit once per size, at the first
// call (outside any CUDA graph capture)
template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes, size_t& raised) {
  if (bytes <= raised) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) raised = bytes;
  return err;
}

template <typename T, int KT, int VT, int CT>
struct Bwd {
  static size_t dstate_raised, grad_raised;

  static cudaError_t prepare(int K, int V, int C, size_t* db, size_t* gb, int* threads) {
    *db = dstate_smem_bytes<T>(C);
    *gb = (size_t)grad_layout(K, V, C).total * sizeof(float);
    *threads = CT ? kGradThreads : grad_threads(K, V, C);
    if (*db > (size_t)kMaxSmem || *gb > (size_t)kMaxSmem || *threads > kMaxGradThreads)
      return cudaErrorInvalidValue;
    cudaError_t err = allow_smem(wkv_bwd_dstate_kernel<T, KT, VT, CT>, *db, dstate_raised);
    if (err != cudaSuccess) return err;
    return allow_smem(wkv_bwd_grad_kernel<T, KT, VT, CT>, *gb, grad_raised);
  }

  static int launch(const void* r, const void* k, const void* v, const void* lw,
                    const void* u, const void* states, const void* s_out, const void* dy,
                    const void* ds_out, void* dr, void* dk, void* dv, void* dlw,
                    void* dstates, void* du_part, void* du, void* ds0, int B, int T_len,
                    int H, int K, int V, int C, cudaStream_t s) {
    size_t db, gb;
    int threads;
    cudaError_t err = prepare(K, V, C, &db, &gb, &threads);
    if (err != cudaSuccess) return (int)err;
    constexpr int E = 16 / sizeof(T);
    const int state_vec = K % E == 0 && V % E == 0 && K % 4 == 0 && aligned16(r) &&
                          aligned16(dy) && aligned16(lw) && aligned16(dstates);
    const int grad_vec = K % 4 == 0 && V % 4 == 0 && aligned16(r) && aligned16(k) &&
                         aligned16(v) && aligned16(lw) && aligned16(dy) &&
                         aligned16(states) && aligned16(dstates) && aligned16(s_out);
    const int nc = T_len / C;
    const dim3 sgrid(B * H, (K + kBK - 1) / kBK, (V + kBV - 1) / kBV);
    wkv_bwd_dstate_kernel<T, KT, VT, CT><<<sgrid, kStateThreads, db, s>>>(
        (const T*)r, (const T*)dy, (const float*)lw, (const float*)ds_out, (float*)ds0,
        (float*)dstates, T_len, H, K, V, C, state_vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    wkv_bwd_grad_kernel<T, KT, VT, CT><<<dim3(B * H, nc), threads, gb, s>>>(
        (const T*)r, (const T*)k, (const T*)v, (const float*)lw, (const float*)u,
        (const float*)states, (const float*)s_out, (const float*)dstates, (const T*)dy,
        (T*)dr, (T*)dk, (T*)dv, (float*)dlw, (float*)du_part, T_len, H, K, V, C, grad_vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    wkv_bwd_du_reduce_kernel<<<(H * K + kReduceThreads - 1) / kReduceThreads, kReduceThreads,
                               0, s>>>((const float*)du_part, (float*)du, B, H, nc, K);
    return (int)cudaGetLastError();
  }

  // registers a thread, CTAs an SM and shared bytes a CTA of the three kernels
  static int info(int K, int V, int C, int* out) {
    size_t db, gb;
    int threads;
    cudaError_t err = prepare(K, V, C, &db, &gb, &threads);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes fs, fg, fr;
    int ns = 0, ng = 0, nr = 0;
    if ((err = cudaFuncGetAttributes(&fs, wkv_bwd_dstate_kernel<T, KT, VT, CT>)) ||
        (err = cudaFuncGetAttributes(&fg, wkv_bwd_grad_kernel<T, KT, VT, CT>)) ||
        (err = cudaFuncGetAttributes(&fr, wkv_bwd_du_reduce_kernel)) ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &ns, wkv_bwd_dstate_kernel<T, KT, VT, CT>, kStateThreads, db)) ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &ng, wkv_bwd_grad_kernel<T, KT, VT, CT>, threads, gb)) ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nr, wkv_bwd_du_reduce_kernel,
                                                             kReduceThreads, 0)))
      return (int)err;
    out[0] = fs.numRegs, out[1] = fg.numRegs, out[2] = fr.numRegs;
    out[3] = ns, out[4] = ng, out[5] = nr;
    out[6] = (int)db, out[7] = (int)gb, out[8] = 0;
    out[9] = kStateThreads, out[10] = threads, out[11] = kReduceThreads;
    return 0;
  }
};
template <typename T, int KT, int VT, int CT>
size_t Bwd<T, KT, VT, CT>::dstate_raised = 0;
template <typename T, int KT, int VT, int CT>
size_t Bwd<T, KT, VT, CT>::grad_raised = 0;

// the training shape's instantiation (K = V = 64, C = 32: loops of known
// length, 128 threads a gradient CTA), else the general one
template <typename T>
int dispatch_launch(const void* r, const void* k, const void* v, const void* lw,
                    const void* u, const void* states, const void* s_out, const void* dy,
                    const void* ds_out, void* dr, void* dk, void* dv, void* dlw,
                    void* dstates, void* du_part, void* du, void* ds0, int B, int T_len,
                    int H, int K, int V, int C, cudaStream_t s) {
  if (K == 64 && V == 64 && C == 32)
    return Bwd<T, 64, 64, 32>::launch(r, k, v, lw, u, states, s_out, dy, ds_out, dr, dk, dv,
                                      dlw, dstates, du_part, du, ds0, B, T_len, H, K, V, C,
                                      s);
  return Bwd<T, 0, 0, 0>::launch(r, k, v, lw, u, states, s_out, dy, ds_out, dr, dk, dv, dlw,
                                 dstates, du_part, du, ds0, B, T_len, H, K, V, C, s);
}

template <typename T>
int dispatch_info(int K, int V, int C, int* out) {
  if (K == 64 && V == 64 && C == 32) return Bwd<T, 64, 64, 32>::info(K, V, C, out);
  return Bwd<T, 0, 0, 0>::info(K, V, C, out);
}

}  // namespace

extern "C" {

// The gradients of wkv_fwd on `stream`: the state-gradient pass, the
// gradient pass and du's sum; T_len % C == 0, B * H >= 1. ds_out may be null
// (a zero gradient of the final state). dstates is scratch of B * H * T_len
// / C * K * V floats (the gradient of the state after each chunk, left
// there), du_part of B * H * T_len / C * K floats. bf16 != 0: r, k, v, dy,
// dr, dk and dv are bf16, else f32. Returns cudaGetLastError() after the
// three launches (0 when all were accepted), or cudaErrorInvalidValue when
// one chunk's tiles exceed shared memory.
int wkv_bwd(const void* r, const void* k, const void* v, const void* lw, const void* u,
            const void* states, const void* s_out, const void* dy, const void* ds_out,
            void* dr, void* dk, void* dv, void* dlw, void* dstates, void* du_part, void* du,
            void* ds0, int B, int T_len, int H, int K, int V, int C, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return dispatch_launch<__nv_bfloat16>(r, k, v, lw, u, states, s_out, dy, ds_out, dr, dk,
                                          dv, dlw, dstates, du_part, du, ds0, B, T_len, H, K,
                                          V, C, s);
  return dispatch_launch<float>(r, k, v, lw, u, states, s_out, dy, ds_out, dr, dk, dv, dlw,
                                dstates, du_part, du, ds0, B, T_len, H, K, V, C, s);
}

// out[12]: registers a thread, CTAs an SM, shared bytes a CTA and threads a
// CTA of the state-gradient pass, the gradient pass and du's sum (in that
// order within each group of three), for these sizes.
int wkv_bwd_info(int K, int V, int C, int bf16, int* out) {
  return bf16 ? dispatch_info<__nv_bfloat16>(K, V, C, out) : dispatch_info<float>(K, V, C, out);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
