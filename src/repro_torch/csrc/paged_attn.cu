// Paged decode attention for Hopper (sm_90a): each decode token attends over
// the K/V rows its block-table row maps, with G query heads per kv head.
//
// Replaces the TPU kernel repro/kernels/paged_attn/kernel.py::_paged_attn_kernel
// (launched by paged_attn_pallas through pl.pallas_call). Same contract as its
// gather oracle repro/kernels/paged_attn/ref.py::paged_attn_ref:
//   q (T, KVH, G, Dk), k_pool (NB, bs, KVH, Dk), v_pool (NB, bs, KVH, Dv),
//   table (T, nb_slot) int32 physical block ids, pos (T,) int32
//   -> out (T, KVH, G, Dv) f32,
// with q and the pools in f32 or bf16, upcast to f32, all arithmetic in f32.
// Token t reads logical rows 0..last, where
//   last = min(pos, max_rows - 1)                     (full region)
//   last = pos >= ring_width ? ring_width - 1 : pos   (SWA ring)
// and never past the table (nb_slot * bs - 1). Logical row n lives in
// physical block table[t][n / bs] at offset n % bs. Blocks past `last` are
// never read and rows past it inside a block are masked, so entries that the
// caller clamped to block 0 (unmapped) and stale rows of recycled blocks
// never reach the sum.
//
// Bound: bytes. Per (token, kv head) the kernel reads the token's valid K/V
// rows once, 2 * (last + 1) * D values, and does about 2 * G operations per
// value read: far below the card's rate per byte. So the least time is the
// valid rows of every token, plus q and the output, over 3.35 TB/s.
//
// Design: one CTA per (token, kv head, tile of the G heads).
// The TPU kernel's sequential grid axis over the table row becomes a loop
// inside the CTA over the token's logical rows, which may span blocks of any
// size: each row finds its own block. The online softmax (running max,
// denominator, accumulator) lives in the one CTA, so no reduction crosses
// blocks: no atomics, and the same bits on every run. Nothing is padded to
// 128 lanes. expf, not __expf, and no fast-math flag. Two bodies, chosen by
// the head dims:
//
//  * Dk, Dv <= 256 (every GQA model here): paged_attn_warp_kernel. Each of
//    the 8 warps walks its own groups of 4 rows; a lane holds every 32nd
//    element of q, of the rows it loads and of the accumulator in registers
//    (tiles of 4 or 8 heads), so a row is read once, with coalesced loads,
//    straight into registers, with no shared-memory staging and no barrier
//    in the loop. The loads of a warp's next group are issued before the
//    arithmetic of its current one, unconditionally and unconverted, so no
//    load waits on another: a CTA is bound by its token's row walk, and
//    serialised load latency (a load, then its use) made that walk 3-6x
//    slower on the H100. Each (row, head) score is a lane-strided fmaf chain
//    and a fixed xor-shuffle tree; the 8 warps' softmax states merge at the
//    end in warp order.
//  * larger head dims (the MLA absorbed shapes, Dk 288 or 576):
//    paged_attn_tiled_kernel. Tiles of up to 32 rows of K and V are staged
//    in shared memory as f32 (rows padded by one word so the score loop's
//    row-strided reads miss no bank), each (head, row) score is one thread's
//    fmaf chain over Dk, heads are tiled by 16, and the rows per tile halve
//    until the tile fits the 227 KB of shared memory a block may use.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // threads of the tiled body
constexpr int kWarps = 8;  // warps of the register body
constexpr int kRowsPerWarpStep = 4;
constexpr int kMaxHeadsPerCta = 16;
constexpr int kMaxRows = 32;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use
constexpr float kNeg = -1e9f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// floats of shared memory for a tile of `gt` heads and `rows` rows
int smem_floats(int gt, int rows, int dk, int dv) {
  return gt * (dk + 1) + rows * (dk + 1) + rows * (dv + 1) + gt * dv + gt * rows + 3 * gt;
}

// the last logical row token `t` reads (see the contract above)
__device__ __forceinline__ int last_row(int p, int ring_width, int max_rows, int nb_slot,
                                        int bs) {
  const int last = ring_width ? (p >= ring_width ? ring_width - 1 : p) : min(p, max_rows - 1);
  return min(last, nb_slot * bs - 1);
}

__device__ __forceinline__ float load_q(const void* q, int q_bf16, size_t i) {
  return q_bf16 ? __bfloat162float(((const __nv_bfloat16*)q)[i]) : ((const float*)q)[i];
}

// rows [n0, n0 + kRowsPerWarpStep) of head h into a warp's registers, as
// stored (converted where they are used, so that no load waits on another):
// lane `lane` takes every 32nd element. The loads are unconditional, from
// clamped addresses: rows past `last` re-read row `last`, and elements past
// the head dim the last element; the caller gives them no weight.
template <typename KVT, int PL>
__device__ __forceinline__ void load_rows(const KVT* __restrict__ kpool,
                                          const KVT* __restrict__ vpool,
                                          const int* __restrict__ trow, int n0, int last,
                                          int bs, size_t krow, size_t vrow, int h, int dk,
                                          int dv, int lane,
                                          KVT (&kr)[kRowsPerWarpStep][PL],
                                          KVT (&vr)[kRowsPerWarpStep][PL]) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarpStep; ++r) {
    const int n = min(n0 + r, last);
    const size_t row = (size_t)trow[n / bs] * bs + n % bs;
    const KVT* kp = kpool + row * krow + (size_t)h * dk;
    const KVT* vp = vpool + row * vrow + (size_t)h * dv;
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      kr[r][i] = kp[min(i * 32 + lane, dk - 1)];
      vr[r][i] = vp[min(i * 32 + lane, dv - 1)];
    }
  }
}

// GT heads per CTA, PL elements of each head dim per lane (Dk, Dv <= 32 * PL)
template <typename KVT, int GT, int PL>
__global__ void __launch_bounds__(kWarps * 32) paged_attn_warp_kernel(
    const void* __restrict__ q, int q_bf16, const KVT* __restrict__ kpool,
    const KVT* __restrict__ vpool, const int* __restrict__ table,
    const int* __restrict__ pos, float* __restrict__ out, int kvh, int g, int dk,
    int dv, int bs, int nb_slot, int ring_width, int max_rows, float scale) {
  __shared__ float sm_m[kWarps][GT], sm_l[kWarps][GT];
  __shared__ float sm_acc[kWarps][GT][PL * 32];
  const int t = blockIdx.x, h = blockIdx.y, g0 = blockIdx.z * GT;
  const int ng = min(GT, g - g0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int last = last_row(pos[t], ring_width, max_rows, nb_slot, bs);

  float qv[GT][PL], acc[GT][PL], m[GT], l[GT];
  const size_t qbase = ((size_t)t * kvh + h) * g * dk + (size_t)g0 * dk;
#pragma unroll
  for (int gi = 0; gi < GT; ++gi) {
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      const int d = i * 32 + lane;
      qv[gi][i] = (gi < ng && d < dk) ? load_q(q, q_bf16, qbase + (size_t)gi * dk + d) : 0.0f;
      acc[gi][i] = 0.0f;
    }
    m[gi] = kNeg;
    l[gi] = 0.0f;
  }
  const int* trow = table + (size_t)t * nb_slot;
  const size_t krow = (size_t)kvh * dk, vrow = (size_t)kvh * dv;

  // warp w reads rows [n0, n0 + 4) for n0 = 4 w, 4 w + 4 W, ...: the loop
  // is uniform across the warp, so every lane takes part in the shuffles.
  // The next group's loads are issued before this group's arithmetic, so
  // the memory latency hides behind it.
  constexpr int kStride = kWarps * kRowsPerWarpStep;
  KVT kr[kRowsPerWarpStep][PL], vr[kRowsPerWarpStep][PL];
  load_rows<KVT, PL>(kpool, vpool, trow, warp * kRowsPerWarpStep, last, bs, krow, vrow, h,
                     dk, dv, lane, kr, vr);
  for (int n0 = warp * kRowsPerWarpStep; n0 <= last; n0 += kStride) {
    KVT kn[kRowsPerWarpStep][PL], vn[kRowsPerWarpStep][PL];
    load_rows<KVT, PL>(kpool, vpool, trow, n0 + kStride, last, bs, krow, vrow, h, dk, dv,
                       lane, kn, vn);
    // q is 0 past Dk, so a clamped K element adds nothing; a row past `last`
    // gets probability 0 and a clamped V element lands past Dv, which is
    // never written out
    float kf[kRowsPerWarpStep][PL], vf[kRowsPerWarpStep][PL];
#pragma unroll
    for (int r = 0; r < kRowsPerWarpStep; ++r) {
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        kf[r][i] = to_f32(kr[r][i]);
        vf[r][i] = to_f32(vr[r][i]);
      }
    }
#pragma unroll
    for (int gi = 0; gi < GT; ++gi) {
      float s[kRowsPerWarpStep];
      float m_new = m[gi];
#pragma unroll
      for (int r = 0; r < kRowsPerWarpStep; ++r) {
        float part = 0.0f;
#pragma unroll
        for (int i = 0; i < PL; ++i) part = fmaf(qv[gi][i], kf[r][i], part);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        s[r] = n0 + r <= last ? part * scale : kNeg;
        m_new = fmaxf(m_new, s[r]);
      }
      const float alpha = expf(m[gi] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int r = 0; r < kRowsPerWarpStep; ++r) {
        s[r] = n0 + r <= last ? expf(s[r] - m_new) : 0.0f;
        sum += s[r];
      }
      l[gi] = l[gi] * alpha + sum;
      m[gi] = m_new;
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        float a = 0.0f;
#pragma unroll
        for (int r = 0; r < kRowsPerWarpStep; ++r) a = fmaf(s[r], vf[r][i], a);
        acc[gi][i] = acc[gi][i] * alpha + a;
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarpStep; ++r) {
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        kr[r][i] = kn[r][i];
        vr[r][i] = vn[r][i];
      }
    }
  }

  // merge the warps' states in warp order: out = sum_w acc_w e^(m_w - M) /
  // sum_w l_w e^(m_w - M), M the largest m_w (a warp that read no row holds
  // m = -1e9 and weighs 0)
#pragma unroll
  for (int gi = 0; gi < GT; ++gi) {
    if (lane == 0) {
      sm_m[warp][gi] = m[gi];
      sm_l[warp][gi] = l[gi];
    }
#pragma unroll
    for (int i = 0; i < PL; ++i) sm_acc[warp][gi][i * 32 + lane] = acc[gi][i];
  }
  __syncthreads();
  float* o = out + ((size_t)t * kvh + h) * g * dv + (size_t)g0 * dv;
  for (int e = threadIdx.x; e < ng * dv; e += kWarps * 32) {
    const int gi = e / dv, d = e - gi * dv;
    float big = sm_m[0][gi];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) big = fmaxf(big, sm_m[w][gi]);
    float num = 0.0f, den = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wgt = expf(sm_m[w][gi] - big);
      num = fmaf(sm_acc[w][gi][d], wgt, num);
      den = fmaf(sm_l[w][gi], wgt, den);
    }
    o[e] = num / den;
  }
}

template <typename QT, typename KVT>
__global__ void __launch_bounds__(kThreads) paged_attn_tiled_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ kpool,
    const KVT* __restrict__ vpool, const int* __restrict__ table,
    const int* __restrict__ pos, float* __restrict__ out, int kvh, int g, int dk,
    int dv, int bs, int nb_slot, int ring_width, int max_rows, float scale,
    int gt, int rows) {
  extern __shared__ float smem[];
  const int t = blockIdx.x, h = blockIdx.y, g0 = blockIdx.z * gt;
  const int ng = min(gt, g - g0);
  const int qs = dk + 1, ks = dk + 1, vs = dv + 1;
  float* sq = smem;               // [gt][dk + 1] queries of this tile
  float* sk = sq + gt * qs;       // [rows][dk + 1] keys of this row tile
  float* sv = sk + rows * ks;     // [rows][dv + 1] values of this row tile
  float* sacc = sv + rows * vs;   // [gt][dv] running accumulator
  float* sp = sacc + gt * dv;     // [gt][rows] scores, then probabilities
  float* sm = sp + gt * rows;     // [gt] running max
  float* sl = sm + gt;            // [gt] running denominator
  float* salpha = sl + gt;        // [gt] rescale of the accumulator
  const int tid = threadIdx.x;

  const int last = last_row(pos[t], ring_width, max_rows, nb_slot, bs);

  const QT* qt = q + ((size_t)t * kvh + h) * g * dk + (size_t)g0 * dk;
  for (int e = tid; e < ng * dk; e += kThreads) sq[(e / dk) * qs + e % dk] = to_f32(qt[e]);
  for (int e = tid; e < ng * dv; e += kThreads) sacc[e] = 0.0f;
  if (tid < ng) {
    sm[tid] = kNeg;
    sl[tid] = 0.0f;
  }
  const int* trow = table + (size_t)t * nb_slot;
  const size_t krow = (size_t)kvh * dk, vrow = (size_t)kvh * dv;

  for (int n0 = 0; n0 <= last; n0 += rows) {
    const int nr = min(rows, last + 1 - n0);  // rows of this tile that are read
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < nr * dk; e += kThreads) {
      const int r = e / dk, d = e - r * dk, n = n0 + r;
      const size_t row = (size_t)trow[n / bs] * bs + n % bs;
      sk[r * ks + d] = to_f32(kpool[row * krow + (size_t)h * dk + d]);
    }
    for (int e = tid; e < nr * dv; e += kThreads) {
      const int r = e / dv, d = e - r * dv, n = n0 + r;
      const size_t row = (size_t)trow[n / bs] * bs + n % bs;
      sv[r * vs + d] = to_f32(vpool[row * vrow + (size_t)h * dv + d]);
    }
    __syncthreads();
    for (int e = tid; e < ng * rows; e += kThreads) {
      const int gi = e / rows, r = e - gi * rows;
      float s = kNeg;
      if (r < nr) {
        const float* a = sq + gi * qs;
        const float* b = sk + r * ks;
        float acc = 0.0f;
        for (int d = 0; d < dk; ++d) acc = fmaf(a[d], b[d], acc);
        s = acc * scale;
      }
      sp[e] = s;
    }
    __syncthreads();
    if (tid < ng) {
      float* srow = sp + tid * rows;
      const float m_prev = sm[tid];
      float m_new = m_prev;
      for (int r = 0; r < nr; ++r) m_new = fmaxf(m_new, srow[r]);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.0f;
      for (int r = 0; r < nr; ++r) {
        const float e = expf(srow[r] - m_new);
        srow[r] = e;
        sum += e;
      }
      sl[tid] = sl[tid] * alpha + sum;
      sm[tid] = m_new;
      salpha[tid] = alpha;
    }
    __syncthreads();
    for (int e = tid; e < ng * dv; e += kThreads) {
      const int gi = e / dv, d = e - gi * dv;
      const float* prow = sp + gi * rows;
      float acc = 0.0f;
      for (int r = 0; r < nr; ++r) acc = fmaf(prow[r], sv[r * vs + d], acc);
      sacc[e] = sacc[e] * salpha[gi] + acc;
    }
  }
  __syncthreads();
  float* o = out + ((size_t)t * kvh + h) * g * dv + (size_t)g0 * dv;
  for (int e = tid; e < ng * dv; e += kThreads) o[e] = sacc[e] / sl[e / dv];
}

template <typename KVT, int GT, int PL>
int launch_warp(const void* q, int q_bf16, const void* k, const void* v, const void* table,
                const void* pos, void* out, int t, int kvh, int g, int dk, int dv, int bs,
                int nb_slot, int ring_width, int max_rows, float scale, cudaStream_t stream) {
  const dim3 grid(t, kvh, (g + GT - 1) / GT);
  paged_attn_warp_kernel<KVT, GT, PL><<<grid, kWarps * 32, 0, stream>>>(
      q, q_bf16, (const KVT*)k, (const KVT*)v, (const int*)table, (const int*)pos,
      (float*)out, kvh, g, dk, dv, bs, nb_slot, ring_width, max_rows, scale);
  return (int)cudaGetLastError();
}

// the register body for head dims of up to 256: 4 heads per CTA for G <= 4,
// else 8; PL the smallest of 1, 2, 4, 8 that covers Dk and Dv; at most 32
// registers of q per lane (so not 8 heads at 8 per lane)
template <typename KVT>
int launch_warp_for(const void* q, int q_bf16, const void* k, const void* v,
                    const void* table, const void* pos, void* out, int t, int kvh, int g,
                    int dk, int dv, int bs, int nb_slot, int ring_width, int max_rows,
                    float scale, cudaStream_t stream, bool* done) {
  const int need = ((dk > dv ? dk : dv) + 31) / 32;
  const int pl = need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : need <= 8 ? 8 : 0;
  const int gt = g <= 4 ? 4 : 8;
  *done = pl != 0 && gt * pl <= 32;
  if (!*done) return 0;
#define PAGED_ATTN_WARP(GT, PL)                                                           \
  if (gt == GT && pl == PL)                                                               \
    return launch_warp<KVT, GT, PL>(q, q_bf16, k, v, table, pos, out, t, kvh, g, dk, dv, \
                                    bs, nb_slot, ring_width, max_rows, scale, stream);
  PAGED_ATTN_WARP(4, 1) PAGED_ATTN_WARP(4, 2) PAGED_ATTN_WARP(4, 4) PAGED_ATTN_WARP(4, 8)
  PAGED_ATTN_WARP(8, 1) PAGED_ATTN_WARP(8, 2) PAGED_ATTN_WARP(8, 4)
#undef PAGED_ATTN_WARP
  return (int)cudaErrorInvalidValue;
}

template <typename QT, typename KVT>
int launch_tiled(const void* q, const void* k, const void* v, const void* table,
                 const void* pos, void* out, int t, int kvh, int g, int dk, int dv,
                 int bs, int nb_slot, int ring_width, int max_rows, float scale,
                 cudaStream_t stream) {
  const int gt = g < kMaxHeadsPerCta ? g : kMaxHeadsPerCta;
  int rows = kMaxRows;
  while (rows > 1 && smem_floats(gt, rows, dk, dv) * (int)sizeof(float) > kMaxSmem) rows /= 2;
  const int bytes = smem_floats(gt, rows, dk, dv) * (int)sizeof(float);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(paged_attn_tiled_kernel<QT, KVT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(t, kvh, (g + gt - 1) / gt);
  paged_attn_tiled_kernel<QT, KVT><<<grid, kThreads, bytes, stream>>>(
      (const QT*)q, (const KVT*)k, (const KVT*)v, (const int*)table, (const int*)pos,
      (float*)out, kvh, g, dk, dv, bs, nb_slot, ring_width, max_rows, scale, gt, rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (t, kvh, g, dv) f32 = paged attention of q over the pools through
// `table`, on `stream`, with t, kvh, g, dk, dv, bs, nb_slot, max_rows >= 1.
// q_bf16 / kv_bf16 say whether q / the pools hold bf16 (else f32). Returns
// cudaGetLastError() after the launch (0 when it was accepted), or
// cudaErrorInvalidValue when one row of the head dims cannot fit in shared
// memory.
int paged_attn(const void* q, const void* k, const void* v, const void* table,
               const void* pos, void* out, int t, int kvh, int g, int dk, int dv,
               int bs, int nb_slot, int ring_width, int max_rows, float scale,
               int q_bf16, int kv_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  bool done = false;
  const int err = kv_bf16
      ? launch_warp_for<__nv_bfloat16>(q, q_bf16, k, v, table, pos, out, t, kvh, g, dk, dv,
                                       bs, nb_slot, ring_width, max_rows, scale, s, &done)
      : launch_warp_for<float>(q, q_bf16, k, v, table, pos, out, t, kvh, g, dk, dv, bs,
                               nb_slot, ring_width, max_rows, scale, s, &done);
  if (done) return err;
  if (q_bf16 && kv_bf16)
    return launch_tiled<__nv_bfloat16, __nv_bfloat16>(q, k, v, table, pos, out, t, kvh, g,
                                                      dk, dv, bs, nb_slot, ring_width,
                                                      max_rows, scale, s);
  if (q_bf16)
    return launch_tiled<__nv_bfloat16, float>(q, k, v, table, pos, out, t, kvh, g, dk, dv,
                                              bs, nb_slot, ring_width, max_rows, scale, s);
  if (kv_bf16)
    return launch_tiled<float, __nv_bfloat16>(q, k, v, table, pos, out, t, kvh, g, dk, dv,
                                              bs, nb_slot, ring_width, max_rows, scale, s);
  return launch_tiled<float, float>(q, k, v, table, pos, out, t, kvh, g, dk, dv, bs,
                                    nb_slot, ring_width, max_rows, scale, s);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
