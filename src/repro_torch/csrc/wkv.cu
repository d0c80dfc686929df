// RWKV6 chunkwise WKV recurrence for Hopper (sm_90a), forward (B6).
//
// Replaces the TPU kernel repro/kernels/wkv/wkv.py::_wkv_kernel (launched by
// wkv_pallas through pl.pallas_call). Same contract as its plain version
// repro_torch/kernels/wkv/ref.py::wkv_chunked_ref:
//   r, k (B, T, H, K), v (B, T, H, V), in f32 or bf16 (one type for all three);
//   lw (B, T, H, K) f32 log-decays (<= 0); u (H, K) f32; s0 (B, H, K, V) f32
//   -> y (B, T, H, V) in r's type, s_out (B, H, K, V) f32, and each chunk's
//      starting state in states (B*H, T/C, K, V) f32 (states[:, 0] is s0 bit
//      for bit), which the backward kernel (wkv_bwd.cu) reads,
// all arithmetic in f32. Per (b, h) and chunk of C tokens, with cum the
// inclusive cumsum of lw over the chunk and q_ex = cum - lw:
//   y_t = (r_t e^{q_ex_t}) S + sum_{s<t} A[t,s] v_s + (sum_k r_t u k_t) v_t,
//   A[t,s] = sum_k r_t k_s e^{q_ex_t - cum_s},
//   S' = e^{cum_last} S + sum_s (k_s e^{cum_last - cum_s}) v_s^T.
// Every exponent is a difference of a decreasing cumsum taken the right way
// round, so it is <= 0: no overflow, no rescaling, no division by a decay.
// Pairs s >= t are never computed (the TPU kernel computes and then masks
// them). expf, not __expf, and no fast-math flag; no atomics, so the same
// bits on every run; no tensor cores, so no TF32.
//
// Bound: at the training shape (B*H = 320, T = 512, K = V = 64, C = 32, bf16
// r/k/v) the function reads r, k, v, lw once and writes y once, 136 MB
// (0.041 ms at 3.35 TB/s), against 3.59 GFLOP of f32 work (0.054 ms at
// 67 TFLOP/s), 184 M of it exponentials: operations bound it. This design
// moves more, about 383 MB (0.114 ms): the state pass reads k, v, lw (84 MB)
// and writes the chunk states (84 MB); the output pass reads r, k, v, lw
// (105 MB) and the chunk states (84 MB) and writes y (21 MB).
//
// Design: two kernels on the caller's stream, one launch of wkv_fwd. The
// one-kernel design they replace gave each (b, h) one CTA that walked its 16
// chunks in order (320 CTAs, 1.2 waves on 132 SMs), with five barriers a
// chunk, a cumsum on 64 of 256 threads, half the lanes of the A tile masked,
// and every product reading both operands from shared memory, one scalar a
// multiply-add.
//
// 1. State pass, wkv_fwd_state_kernel, the only serial part. Grid (B*H,
//    K/32, V/64), 128 threads: each CTA owns a 32 x 64 block of one (b, h)'s
//    state in registers and walks the chunks in order (640 CTAs at the
//    training shape, one wave at five CTAs an SM). Per chunk it writes its
//    block of the chunk's starting state to `states`, takes the cumsum of
//    its 32 k columns, forms k e^{cum_last - cum} (each CTA for its own 64
//    columns of V: once at V = 64, recomputed per V block above that) and
//    updates S = e^{cum_last} S + sum_s (k_s e^{...})^T v_s in token order.
//    A thread owns an 8 x 2 tile of S, a warp 8 rows by 64 columns, so the
//    8 factors it reads per token are one broadcast and each 2-column load
//    of v feeds 16 multiply-adds. The next chunk's k, v, lw tiles are in
//    flight (cp.async, two stages) while the current one updates, since the
//    chain of dependent chunks waits on loads.
// 2. Output pass, wkv_fwd_output_kernel, with no serial dependence. Grid
//    (B*H, T/C), 256 threads (5,120 CTAs at the training shape, four an SM):
//    each CTA loads one chunk's r, k, v, lw into shared memory and computes
//    y for the chunk. Its starting state from `states`, read only by the
//    last phase, comes by cp.async once the other tiles are in, under the
//    cumsum and A.
//    - A: a thread owns a 2 x 1 tile (rows 2p and 2p+1, one s <= 2p) and
//      reuses k_s and cum_s for both rows; the tiles of row pair p are s =
//      0..2p, (C/2)^2 of them, 256 at C = 32, one a thread, and no warp
//      carries masked lanes. The one pair outside the triangle, (2p, 2p), is
//      computed with its exponent set to 0 and dropped.
//    - y: a thread owns an 8 x 2 tile of (t, v), a warp 8 rows by 64
//      columns; A and r e^{q_ex} are kept transposed, so the 8 values a
//      warp reads per k or s are one broadcast and each 2-column load of S
//      or v feeds 16 multiply-adds.
//    - D (sum_k r_t u k_t) runs on a few lanes of every warp.
//    Rows read down a column are padded to an odd number of words, rows read
//    along start 16-byte aligned, so the product loops' loads are free of
//    bank conflicts.
//    54 KB of shared memory at the training shape.
// The cumsums run per column in token order and each sum runs in the same
// order as in the one-kernel design this one replaces, so y, s_out and the
// chunk states are bit for bit what that design gave.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;  // the most a block may use on sm_90
constexpr int kBK = 32, kBV = 64;  // the state block of one state-pass CTA
constexpr int kStateThreads = 32 * kBK / 8;  // a warp for each 8 rows
constexpr int kOutThreads = 256;

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

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}
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

// ---------------------------------------------------------------- state pass

template <typename T>
__host__ __device__ inline size_t state_stage_bytes(int C) {
  return (size_t)C * (kBK * sizeof(T) + kBV * sizeof(T) + kBK * sizeof(float));
}

// two stages of raw tiles (k, v of T, lw f32), then kl, vf (f32) and elast
template <typename T>
__host__ __device__ inline size_t state_smem_bytes(int C) {
  return 2 * state_stage_bytes<T>(C) + ((size_t)C * (kBK + kBV) + kBK) * sizeof(float);
}

// vec: k, v, lw and states 16-byte aligned, K and V multiples of a 16-byte
// chunk: cp.async tiles and 8-byte stores of the states; else plain loads
// and stores.
template <typename T, int KT, int VT, int CT>
__global__ void __launch_bounds__(kStateThreads, 5) wkv_fwd_state_kernel(
    const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ lw,
    const float* __restrict__ s0, float* __restrict__ s_out, float* __restrict__ states,
    int T_len, int H, int K_, int V_, int C_, int vec) {
  const int K = KT ? KT : K_, V = VT ? VT : V_, C = CT ? CT : C_;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t stage = state_stage_bytes<T>(C);
  const size_t tile_k = (size_t)C * kBK * sizeof(T), tile_v = (size_t)C * kBV * sizeof(T);
  float* kl = reinterpret_cast<float*>(smem + 2 * stage);  // C x kBK: k e^{cum_last - cum}
  float* vf = kl + C * kBK;                                // C x kBV: v in f32
  float* elast = vf + C * kBV;                             // kBK: e^{cum_last}

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kBK, v0 = blockIdx.z * kBV;
  const int nk = min(kBK, K - k0), nv = min(kBV, V - v0);
  const int tid = threadIdx.x;
  const int nc = T_len / C;
  // this thread's 8 x 2 tile of the block: rows kr..kr+7 (one warp's rows,
  // so their kl loads are broadcasts), columns vc, vc + 1
  const int kr = 8 * (tid >> 5), vc = 2 * (tid & 31);

  float S[8][2];
  const float* s0b = s0 + (size_t)bh * K * V;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      S[i][j] = kr + i < nk && vc + j < nv ? s0b[(size_t)(k0 + kr + i) * V + v0 + vc + j] : 0.0f;

  auto tiles = [&](int st) { return smem + st * stage; };
  auto load_chunk = [&](int c, int st) {
    T* kt = reinterpret_cast<T*>(tiles(st));
    T* vt = reinterpret_cast<T*>(tiles(st) + tile_k);
    float* lt = reinterpret_cast<float*>(tiles(st) + tile_k + tile_v);
    const size_t row0 = (size_t)b * T_len + (size_t)c * C;
    if (vec) {
      constexpr int E = 16 / sizeof(T);  // elements of k or v in a 16-byte chunk
      constexpr int ck = kBK / E, cv = kBV / E, cl = kBK / 4, per_row = ck + cv + cl;
      for (int i = tid; i < C * per_row; i += kStateThreads) {
        const int t = i / per_row, j = i - t * per_row;
        const size_t tok = (row0 + t) * H + h;
        if (j < ck) {
          const int col = j * E;
          if (col < nk) cp_async16(kt + t * kBK + col, k + tok * K + k0 + col);
        } else if (j < ck + cv) {
          const int col = (j - ck) * E;
          if (col < nv) cp_async16(vt + t * kBV + col, v + tok * V + v0 + col);
        } else {
          const int col = (j - ck - cv) * 4;
          if (col < nk) cp_async16(lt + t * kBK + col, lw + tok * K + k0 + col);
        }
      }
    } else {
      for (int i = tid; i < C * kBK; i += kStateThreads) {
        const int t = i / kBK, col = i % kBK;
        const size_t g = ((row0 + t) * H + h) * K + k0 + col;
        if (col < nk) {
          kt[i] = k[g];
          lt[i] = lw[g];
        }
      }
      for (int i = tid; i < C * kBV; i += kStateThreads) {
        const int t = i / kBV, col = i % kBV;
        if (col < nv) vt[i] = v[((row0 + t) * H + h) * V + v0 + col];
      }
    }
  };

  if (vec) {
    load_chunk(0, 0);
    cp_async_commit();
    if (nc > 1) load_chunk(1, 1);
    cp_async_commit();
  }
  float* st_bh = states + (size_t)bh * nc * K * V;
  for (int c = 0; c < nc; ++c) {
    const int st = c & 1;
    // the chunk's starting state
    float* dst = st_bh + (size_t)c * K * V;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (kr + i >= nk) continue;
      float* row = dst + (size_t)(k0 + kr + i) * V + v0 + vc;
      if (vec && vc < nv) {
        *reinterpret_cast<float2*>(row) = make_float2(S[i][0], S[i][1]);
      } else {
        if (vc < nv) row[0] = S[i][0];
        if (vc + 1 < nv) row[1] = S[i][1];
      }
    }
    if (vec) cp_async_wait<1>();  // chunk c's group has landed (c + 1's may fly)
    else load_chunk(c, st);
    __syncthreads();
    const T* kt = reinterpret_cast<const T*>(tiles(st));
    const T* vt = reinterpret_cast<const T*>(tiles(st) + tile_k);
    float* cum = reinterpret_cast<float*>(tiles(st) + tile_k + tile_v);
    if (tid < kBK) elast[tid] = tid < nk ? expf(column_cumsum(cum, kBK, C, tid)) : 0.0f;
    __syncthreads();
    for (int i = tid; i < C * kBK; i += kStateThreads) {
      const int j = i % kBK;
      kl[i] = j < nk ? to_f(kt[i]) * expf(cum[(C - 1) * kBK + j] - cum[i]) : 0.0f;
    }
    for (int i = 4 * tid; i < C * kBV; i += 4 * kStateThreads) {
      const int col = i % kBV;
      float4 w = load4(vt + i);  // a row's padding past nv is zeroed here
      if (col + 3 >= nv) {
        w.x = col < nv ? w.x : 0.0f;
        w.y = col + 1 < nv ? w.y : 0.0f;
        w.z = col + 2 < nv ? w.z : 0.0f;
        w.w = 0.0f;
      }
      *reinterpret_cast<float4*>(vf + i) = w;
    }
    __syncthreads();
    // this stage is free: the chunk after next lands in it while S updates
    if (vec) {
      if (c + 2 < nc) load_chunk(c + 2, st);
      cp_async_commit();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float e = elast[kr + i];
      S[i][0] *= e;
      S[i][1] *= e;
    }
#pragma unroll
    for (int s = 0; s < C; ++s) {
      const float4 a0 = *reinterpret_cast<const float4*>(kl + s * kBK + kr);
      const float4 a1 = *reinterpret_cast<const float4*>(kl + s * kBK + kr + 4);
      const float2 w = *reinterpret_cast<const float2*>(vf + s * kBV + vc);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        S[i][0] = fmaf(a[i], w.x, S[i][0]);
        S[i][1] = fmaf(a[i], w.y, S[i][1]);
      }
    }
  }
  float* out = s_out + (size_t)bh * K * V;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (kr + i < nk && vc + j < nv) out[(size_t)(k0 + kr + i) * V + v0 + vc + j] = S[i][j];
}

// --------------------------------------------------------------- output pass

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int round8(int x) { return (x + 7) & ~7; }

// offsets in floats of the output pass's shared tiles: S (K x VP), v
// (C x VP), r (C x KP), k (C x KP), then (r e^{q_ex})^T in k's place once k
// is done (K x CP), cx ((C+1) x KP), A^T (C x CP), D (CP); KP = K + 1, VP = V
// and CP = C rounded up to multiples of 4 and 8. Each tile starts 16-byte
// aligned.
struct OutLayout {
  int vs, rs, ks, cx, at, d, u, total;
};
__host__ __device__ inline OutLayout out_layout(int K, int V, int C) {
  const int KP = K + 1, VP = round4(V), CP = round8(C);
  OutLayout l;
  l.vs = K * VP;
  l.rs = l.vs + C * VP;
  l.ks = l.rs + round4(C * KP);
  l.cx = l.ks + round4(C * KP > K * CP ? C * KP : K * CP);
  l.at = l.cx + round4((C + 1) * KP);
  l.d = l.at + C * CP;
  l.u = l.d + CP;
  l.total = l.u + round4(K);
  return l;
}

// vec: K % 4 == 0, V % 4 == 0 and r, k, v, lw, states, y 16-byte aligned:
// four elements a load and a store; else one.
template <typename T, int KT, int VT, int CT>
__global__ void __launch_bounds__(kOutThreads, 4) wkv_fwd_output_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ lw, const float* __restrict__ u,
    const float* __restrict__ states, T* __restrict__ y, int T_len, int H, int K_, int V_,
    int C_, int vec) {
  const int K = KT ? KT : K_, V = VT ? VT : V_, C = CT ? CT : C_;
  const int KP = K + 1, VP = round4(V), CP = round8(C);
  extern __shared__ __align__(16) float sm[];
  const OutLayout lay = out_layout(K, V, C);
  float* Ss = sm;             // K x VP: the chunk's starting state
  float* vs = sm + lay.vs;    // C x VP
  float* rs = sm + lay.rs;    // C x KP
  float* ks = sm + lay.ks;    // C x KP: k
  float* rqT = ks;            // K x CP: (r e^{q_ex})^T, once k is done
  float* cx = sm + lay.cx;    // (C+1) x KP: row t is q_ex_t, row s+1 is cum_s
  float* AT = sm + lay.at;    // C x CP: A^T, s < t
  float* D = sm + lay.d;      // CP: sum_k r_t u k_t
  float* us = sm + lay.u;     // K: u of this head

  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int nc = T_len / C;
  const float* Sg = states + ((size_t)bh * nc + c) * K * V;
  const size_t tok0 = (size_t)b * T_len + (size_t)c * C;

  // the chunk's tiles: token t of the chunk is row t
  if (vec) {
    for (int i = tid; i < (C * K) >> 2; i += kOutThreads) {
      const int e = i << 2, t = e / K, kk = e - t * K;
      const size_t g = ((tok0 + t) * H + h) * K + kk;
      const float4 a = load4(r + g), q = load4(k + g), l = load4(lw + g);
      float* rr = rs + t * KP + kk;
      float* kq = ks + t * KP + kk;
      float* lc = cx + (t + 1) * KP + kk;
      rr[0] = a.x, rr[1] = a.y, rr[2] = a.z, rr[3] = a.w;
      kq[0] = q.x, kq[1] = q.y, kq[2] = q.z, kq[3] = q.w;
      lc[0] = l.x, lc[1] = l.y, lc[2] = l.z, lc[3] = l.w;
    }
    for (int i = tid; i < (C * V) >> 2; i += kOutThreads) {
      const int e = i << 2, t = e / V, vv = e - t * V;
      *reinterpret_cast<float4*>(vs + t * VP + vv) = load4(v + ((tok0 + t) * H + h) * V + vv);
    }
  } else {
    for (int i = tid; i < K * V; i += kOutThreads) Ss[(i / V) * VP + i % V] = Sg[i];
    for (int i = tid; i < C * K; i += kOutThreads) {
      const int t = i / K, kk = i % K;
      const size_t g = ((tok0 + t) * H + h) * K + kk;
      rs[t * KP + kk] = to_f(r[g]);
      ks[t * KP + kk] = to_f(k[g]);
      cx[(t + 1) * KP + kk] = lw[g];
    }
    for (int i = tid; i < C * V; i += kOutThreads) {
      const int t = i / V, vv = i % V;
      vs[t * VP + vv] = to_f(v[((tok0 + t) * H + h) * V + vv]);
    }
  }
  for (int kk = tid; kk < K; kk += kOutThreads) {
    cx[kk] = 0.0f;
    us[kk] = u[(size_t)h * K + kk];
  }
  __syncthreads();
  if (vec) {
    // S (VP == V, so it lands as it lies) is read only by the last phase:
    // asked for once the other tiles are in, its copy runs on under the
    // cumsum, A and r e^{q_ex}
    for (int i = tid; i < (K * V) >> 2; i += kOutThreads)
      cp_async16(Ss + 4 * i, Sg + 4 * i);
    cp_async_commit();
  }
  // inclusive cumsum down each k column, in token order: row t + 1 of cx
  // holds cum_t, so row t holds the sum before t, q_ex_t
  for (int kk = tid; kk < K; kk += kOutThreads) column_cumsum(cx + KP, KP, C, kk);
  __syncthreads();

  // A: the 2 x 1 tile (rows t0 = 2T and t1 = 2T + 1, column s <= 2T) of
  // tile number T^2 + s; for odd C the last row's pairs follow, one a tile
  // (t1 = t0, its copy dropped)
  const int np = C / 2;
  const int n_tiles = np * np + ((C & 1) ? C - 1 : 0);
  for (int i = tid; i < n_tiles; i += kOutThreads) {
    int t0, t1, s;
    if (i < np * np) {
      int p = (int)sqrtf((float)i);  // the row pair
      while (p * p > i) --p;
      while ((p + 1) * (p + 1) <= i) ++p;
      s = i - p * p;
      t0 = 2 * p;
      t1 = t0 + 1;
    } else {
      t0 = t1 = C - 1;
      s = i - np * np;
    }
    const bool keep0 = s < t0, keep1 = t1 != t0;
    const float* r0 = rs + t0 * KP;
    const float* r1 = rs + t1 * KP;
    // the dropped pair (t0, t0) reads cum_s for q_ex: its exponent is 0
    const float* q0 = cx + (keep0 ? t0 : s + 1) * KP;
    const float* q1 = cx + t1 * KP;
    const float* kp = ks + s * KP;
    const float* cs = cx + (s + 1) * KP;
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 8
    for (int kk = 0; kk < K; ++kk) {
      const float kv = kp[kk], cv = cs[kk];
      a0 = fmaf(r0[kk] * kv, expf(q0[kk] - cv), a0);
      a1 = fmaf(r1[kk] * kv, expf(q1[kk] - cv), a1);
    }
    if (keep0) AT[s * CP + t0] = a0;
    if (keep1) AT[s * CP + t1] = a1;
  }
  // D: row t on lane t / 8 of warp t % 8, so each warp takes a few rows
  for (int t = (tid & 31) * 8 + (tid >> 5); t < C; t += kOutThreads) {
    float acc = 0.0f;
#pragma unroll 8
    for (int kk = 0; kk < K; ++kk) acc = fmaf(rs[t * KP + kk] * us[kk], ks[t * KP + kk], acc);
    D[t] = acc;
  }
  __syncthreads();
  for (int i = tid; i < C * K; i += kOutThreads) {
    const int kk = i / C, t = i - kk * C;
    rqT[kk * CP + t] = rs[t * KP + kk] * expf(cx[t * KP + kk]);
  }
  if (vec) cp_async_wait<0>();  // S, needed from here on, landed during the phases above
  __syncthreads();

  // y: a warp takes 8 rows (t0..t0+7) and 64 columns, a lane 2 of them, so
  // the loads of r e^{q_ex} and A^T are broadcasts and each 2-column load of
  // S or v feeds 16 multiply-adds
  const int warp = tid >> 5, lane = tid & 31;
  const int ncg = (V + 63) / 64;
  for (int task = warp; task < ((C + 7) / 8) * ncg; task += kOutThreads / 32) {
    const int t0 = 8 * (task / ncg), v0 = 64 * (task % ncg) + 2 * lane;
    const int vl = min(v0, VP - 2);  // lanes past VP read a valid column, store nothing
    float acc[8][2] = {};
#pragma unroll 4
    for (int kk = 0; kk < K; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(rqT + kk * CP + t0);
      const float4 a1 = *reinterpret_cast<const float4*>(rqT + kk * CP + t0 + 4);
      const float2 w = *reinterpret_cast<const float2*>(Ss + kk * VP + vl);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][0] = fmaf(a[i], w.x, acc[i][0]);
        acc[i][1] = fmaf(a[i], w.y, acc[i][1]);
      }
    }
    // s < t, in order: all 8 rows below t0, then the triangle t0 <= s < t
#pragma unroll 2
    for (int s = 0; s < t0; ++s) {
      const float4 a0 = *reinterpret_cast<const float4*>(AT + s * CP + t0);
      const float4 a1 = *reinterpret_cast<const float4*>(AT + s * CP + t0 + 4);
      const float2 w = *reinterpret_cast<const float2*>(vs + s * VP + vl);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][0] = fmaf(a[i], w.x, acc[i][0]);
        acc[i][1] = fmaf(a[i], w.y, acc[i][1]);
      }
    }
    for (int s = t0; s < min(t0 + 7, C - 1); ++s) {
      const float4 a0 = *reinterpret_cast<const float4*>(AT + s * CP + t0);
      const float4 a1 = *reinterpret_cast<const float4*>(AT + s * CP + t0 + 4);
      const float2 w = *reinterpret_cast<const float2*>(vs + s * VP + vl);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (s < t0 + i) {
          acc[i][0] = fmaf(a[i], w.x, acc[i][0]);
          acc[i][1] = fmaf(a[i], w.y, acc[i][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = min(t0 + i, C - 1);
      const float d = D[t];
      const float2 w = *reinterpret_cast<const float2*>(vs + t * VP + vl);
      acc[i][0] = fmaf(d, w.x, acc[i][0]);
      acc[i][1] = fmaf(d, w.y, acc[i][1]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (t0 + i >= C) break;
      T* dst = y + ((tok0 + t0 + i) * H + h) * V + v0;
      if (vec && v0 < V) {
        store2(dst, acc[i][0], acc[i][1]);
      } else {
        if (v0 < V) store1(dst, acc[i][0]);
        if (v0 + 1 < V) store1(dst + 1, acc[i][1]);
      }
    }
  }
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
struct Fwd {
  static size_t state_raised, out_raised;

  static cudaError_t prepare(int K, int V, int C, size_t* sb, size_t* ob) {
    *sb = state_smem_bytes<T>(C);
    *ob = (size_t)out_layout(K, V, C).total * sizeof(float);
    if (*sb > (size_t)kMaxSmem || *ob > (size_t)kMaxSmem) return cudaErrorInvalidValue;
    cudaError_t err = allow_smem(wkv_fwd_state_kernel<T, KT, VT, CT>, *sb, state_raised);
    if (err != cudaSuccess) return err;
    return allow_smem(wkv_fwd_output_kernel<T, KT, VT, CT>, *ob, out_raised);
  }

  static int launch(const void* r, const void* k, const void* v, const void* lw,
                    const void* u, const void* s0, void* y, void* s_out, void* states, int B,
                    int T_len, int H, int K, int V, int C, cudaStream_t s) {
    size_t sb, ob;
    cudaError_t err = prepare(K, V, C, &sb, &ob);
    if (err != cudaSuccess) return (int)err;
    constexpr int E = 16 / sizeof(T);
    const int state_vec = K % E == 0 && V % E == 0 && K % 4 == 0 && aligned16(k) &&
                          aligned16(v) && aligned16(lw) && aligned16(states);
    const int out_vec = K % 4 == 0 && V % 4 == 0 && aligned16(r) && aligned16(k) &&
                        aligned16(v) && aligned16(lw) && aligned16(states) && aligned16(y);
    const dim3 sgrid(B * H, (K + kBK - 1) / kBK, (V + kBV - 1) / kBV);
    wkv_fwd_state_kernel<T, KT, VT, CT><<<sgrid, kStateThreads, sb, s>>>(
        (const T*)k, (const T*)v, (const float*)lw, (const float*)s0, (float*)s_out,
        (float*)states, T_len, H, K, V, C, state_vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    wkv_fwd_output_kernel<T, KT, VT, CT><<<dim3(B * H, T_len / C), kOutThreads, ob, s>>>(
        (const T*)r, (const T*)k, (const T*)v, (const float*)lw, (const float*)u,
        (const float*)states, (T*)y, T_len, H, K, V, C, out_vec);
    return (int)cudaGetLastError();
  }

  // registers a thread, CTAs an SM and shared bytes a CTA of both kernels
  static int info(int K, int V, int C, int* out) {
    size_t sb, ob;
    cudaError_t err = prepare(K, V, C, &sb, &ob);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes fs, fo;
    int ns = 0, no = 0;
    if ((err = cudaFuncGetAttributes(&fs, wkv_fwd_state_kernel<T, KT, VT, CT>)) ||
        (err = cudaFuncGetAttributes(&fo, wkv_fwd_output_kernel<T, KT, VT, CT>)) ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &ns, wkv_fwd_state_kernel<T, KT, VT, CT>, kStateThreads, sb)) ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &no, wkv_fwd_output_kernel<T, KT, VT, CT>, kOutThreads, ob)))
      return (int)err;
    out[0] = fs.numRegs, out[1] = fo.numRegs, out[2] = ns, out[3] = no;
    out[4] = (int)sb, out[5] = (int)ob;
    return 0;
  }
};
template <typename T, int KT, int VT, int CT>
size_t Fwd<T, KT, VT, CT>::state_raised = 0;
template <typename T, int KT, int VT, int CT>
size_t Fwd<T, KT, VT, CT>::out_raised = 0;

// the training shape's instantiation (K = V = 64, C = 32: loops of known
// length), else the general one
template <typename T>
int dispatch_launch(const void* r, const void* k, const void* v, const void* lw,
                    const void* u, const void* s0, void* y, void* s_out, void* states, int B,
                    int T_len, int H, int K, int V, int C, cudaStream_t s) {
  if (K == 64 && V == 64 && C == 32)
    return Fwd<T, 64, 64, 32>::launch(r, k, v, lw, u, s0, y, s_out, states, B, T_len, H, K,
                                      V, C, s);
  return Fwd<T, 0, 0, 0>::launch(r, k, v, lw, u, s0, y, s_out, states, B, T_len, H, K, V, C,
                                 s);
}

template <typename T>
int dispatch_info(int K, int V, int C, int* out) {
  if (K == 64 && V == 64 && C == 32) return Fwd<T, 64, 64, 32>::info(K, V, C, out);
  return Fwd<T, 0, 0, 0>::info(K, V, C, out);
}

}  // namespace

extern "C" {

// y, s_out and the chunk states from r, k, v, lw, u, s0 on `stream`: the
// state pass, then the output pass, which reads `states` (so it is never
// null); T_len % C == 0, B * H >= 1. bf16 != 0: r, k, v and y are bf16, else
// f32. Returns cudaGetLastError() after the launches (0 when both were
// accepted), or cudaErrorInvalidValue when `states` is null or one chunk's
// tiles exceed shared memory.
int wkv_fwd(const void* r, const void* k, const void* v, const void* lw, const void* u,
            const void* s0, void* y, void* s_out, void* states, int B, int T_len, int H,
            int K, int V, int C, int bf16, void* stream) {
  if (states == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return dispatch_launch<__nv_bfloat16>(r, k, v, lw, u, s0, y, s_out, states, B, T_len, H,
                                          K, V, C, s);
  return dispatch_launch<float>(r, k, v, lw, u, s0, y, s_out, states, B, T_len, H, K, V, C,
                                s);
}

// out[6]: registers a thread of the state pass and of the output pass, CTAs
// an SM of each, and shared bytes a CTA of each, for these sizes.
int wkv_fwd_info(int K, int V, int C, int bf16, int* out) {
  return bf16 ? dispatch_info<__nv_bfloat16>(K, V, C, out) : dispatch_info<float>(K, V, C, out);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
