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
// physical block table[t][n / bs] at offset n % bs. Rows past a token's
// `last` get weight 0 and blocks past the last row of its run are never
// read, so entries that the caller clamped to block 0 (unmapped) and stale
// rows of recycled blocks never reach the sum.
//
// Runs. The caller may pass runs (R, 2) int32: (first row, row count), the
// rows 0..T-1 in order, once each, where the rows of one run share one table
// row (one slot's tokens in a serving step). Each row keeps its own pos and
// so its own limit. Without runs every row is its own run.
//
// Bound: bytes. A run reads its context's valid K/V rows, 2 * (last + 1) * D
// values per kv head, and does about 2 * n * G operations per value read (n
// tokens of the run): at n * G <= 64, below the card's f32 rate per byte. So
// the least time is every distinct K/V row once, plus q and the output,
// over 3.35 TB/s.
//
// Design, for Dk, Dv <= 256 (every GQA model here): paged_attn_split_kernel.
//  * The per-token re-read. The TPU kernel, and this port's first kernel,
//    walked a token's context once per token, so a slot that prefills 16
//    tokens in a step read its context 16 times. Here one CTA serves all the
//    query rows of a run (n tokens x G heads, 64 at a time): each K/V tile is
//    loaded once into shared memory and every query row reads it there,
//    under its own token's limit.
//  * The one-wave grid. One CTA per (token, kv head) made 128 CTAs at a
//    decode step of 16 slots, each walking up to 1,088 rows: one wave, the
//    SMs idle while the longest contexts finish. Here the context is cut into
//    splits of kSplitRows rows and the grid is (run x split, kv head); CTAs
//    past their run's last row exit at once, so the host sizes the grid from
//    the table width without reading the device.
//  * Loads. The CTA gathers its split's rows through the block table with
//    cp.async, 16 bytes a thread, into a ring of three stages of kTile rows
//    (two where three do not fit): at each tile's one barrier the stage of
//    the last tile is refilled, so two tiles' loads are in flight while a
//    tile is computed from shared memory as it arrived. Nothing else is
//    staged, so a launch whose runs are all single rows (the host knows: no
//    runs, or as many as rows) holds four CTAs per SM, a launch with
//    tensor-core scores three.
//  * Compute. A run of at most kNarrowRows query rows (a decode token, a
//    padding row) gives each warp one row: lanes score the tile's 32 rows
//    and accumulate 4 columns each, in f32 FMAs. A longer run takes 64 rows
//    at a time. With bf16 q and pools each warp owns 16 of them and half of
//    Dv, all on the tensor cores (mma.sync m16n8k16, f32 sums): the scores
//    (products of bf16 values are exact in f32), then P.V from the score
//    fragments with P in three bf16 parts (hi, mid, lo: P to 2^-25 of
//    itself, never rounded to bf16), with no exchange between warps. Else
//    the scores and P.V are f32 FMAs, P through shared memory. No TF32.
//    The online-softmax state (running max and denominator) of a row is
//    reduced over each tile in a fixed xor-shuffle tree.
//  * Merge. A token whose context spans more than one split writes each
//    split's (max, denominator, accumulator) into scratch the wrapper
//    allocates; paged_attn_merge_kernel combines them in split order,
//    out = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M). A token within
//    one split is written by its split-0 CTA directly. No atomics: the same
//    bits on every run. expf, not __expf, and no fast-math flag.
//
// The absorbed-MLA call (paged_latent_attn): one kv head whose K row is
// the latent [c ; kr] (Dk = Dc + Dr) and whose V row is c (Dv = Dc), from the
// cache's two pools c (NB, bs, Dc) and kr (NB, bs, Dr) as they are, bf16.
// At minicpm3-4b's G 40, Dc 256, Dr 32: paged_attn_latent_kernel, which runs
// the split body's passes in their latent mode (kLatent):
//  * The K tile is gathered from the two pools (each row's Dc / 8 copies of c
//    and Dr / 8 of kr, 16 bytes each) into one stage of rows Dk + 8 wide,
//    and V is read as the first Dv columns of that same stage: no V tile,
//    no [c ; kr] copy of the pool before the call, each context row's 576
//    bytes read once a pass.
//  * The run's query rows (tokens x G heads) take passes of kQRows on the
//    tensor cores as the kMma pass does (scores over Dk / 16 k-steps, P.V
//    from the score fragments in three bf16 parts, V through ldmatrix.trans
//    on the c columns), 8 warps: 4 row groups of 16 x 2 halves of Dv; a row
//    group with no live row in the pass (a decode token's 40 rows leave the
//    fourth idle) skips the tile's arithmetic. The pass's queries arrive by
//    cp.async with its first tile.
//  * Work: one item is one pass of one run against one context split.
//    Persistent CTAs (as many as the card holds) take the items in turn, so
//    a 16-token prefill run's 10 passes and its splits spread over the card
//    rather than queueing in one CTA, whose passes would set the call's
//    time at a mixed step.
//  * The context split is the host's choice (split_rows: 32, 64 or 128), made
//    from the table's width and the number of runs without reading the
//    device, so that a decode step of a few slots still has an item for
//    most CTAs; the merge takes 128 / (Dv / 4) heads a CTA.
// Dc up to 512 (deepseek-v3's latent: Dc 512, Dr 64, G 128) takes the same
// body with each warp's half of Dv 256 columns wide. Bound: at G 40 a run of
// n tokens does 2 * n * 40 * (Dk + 3 Dv) tensor-core operations (P.V in three
// parts) per 576-byte row it reads, about 147 n a byte against the card's 295
// bf16 operations a byte: bytes at decode (n = 1), operations for longer
// runs. So the least time is the larger of the latent's own bytes (each
// distinct row's c and kr once) at 3.35 TB/s and those operations at 989
// TFLOP/s.
//
// Generic calls with head dims past 256 and separate K and V pools, or rows
// that are not whole 16-byte copies: paged_attn_tiled_kernel, per
// token, runs ignored (on no model's path). Tiles of up to 32 rows of K and V
// are staged in shared memory as f32 (rows padded by one word so the score
// loop's row-strided reads miss no bank), each (head, row) score is one
// thread's fmaf chain over Dk, heads are tiled by 16, and the rows per tile
// halve until the tile fits the 227 KB of shared memory a block may use.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kSplitRows = 128;  // context rows per CTA of the split body
constexpr int kTile = 32;        // K/V rows per shared-memory tile
constexpr int kQRows = 64;       // query rows per pass of the split body
constexpr int kNarrowRows = 8;   // query rows of a run that takes the narrow pass
constexpr int kSplitThreads = 256;
static_assert(kSplitRows % kTile == 0, "a split is whole tiles");
static_assert(kTile == 32, "the narrow pass scores a tile's rows on a warp's lanes");
static_assert(kNarrowRows == kSplitThreads / 32, "the narrow pass gives each warp a row");
// the split body's passes, and its launches: every run narrow (kNarrow), or
// runs of either kind with the wide pass on the tensor cores (kMma) or in
// f32 FMAs (kFma); kLatent: the absorbed-MLA call, K from the two latent
// pools and V its first Dv columns, every pass on the tensor cores
constexpr int kNarrow = 0, kMma = 1, kFma = 2, kLatent = 3;
// the body a call ran, as the C entries report it
constexpr int kBodySplit = 0, kBodyLatent = 1, kBodyTiled = 2;

constexpr int kThreads = 128;  // threads of the tiled body
constexpr int kMaxHeadsPerCta = 16;
constexpr int kMaxRows = 32;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use
constexpr int kStaticSmem = 64;   // bytes of the split body's static shared memory, at most
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

// ---------------------------------------------------------------------------
// the split body

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices from shared memory, rows addressed by lanes 8i..8i+7
__device__ __forceinline__ void ldsm_x4(unsigned& r0, unsigned& r1, unsigned& r2, unsigned& r3,
                                        const void* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(unsigned& r0, unsigned& r1, unsigned& r2,
                                          unsigned& r3, const void* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a));
}

// p = hi + mid + lo in bf16, each part the rounded remainder of the last, so
// that the three hold p to about 2^-25 of itself: the P.V products of the
// parts with bf16 V are exact in f32, and P is not rounded to bf16.
// part[k] packs the parts of two values a (low half) and b.
__device__ __forceinline__ void split3(float a, float b, unsigned (&part)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const __nv_bfloat16 ha = __float2bfloat16_rn(a), hb = __float2bfloat16_rn(b);
    part[k] = (unsigned)__bfloat16_as_ushort(ha) | ((unsigned)__bfloat16_as_ushort(hb) << 16);
    a -= __bfloat162float(ha);
    b -= __bfloat162float(hb);
  }
}

// d += a (16x16 bf16, row-major) * b (16x8 bf16, column-major), f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// f32 row stride (words) of a shared tile whose rows hold d values (d % 4 ==
// 0): a multiple of 4 (float4 reads) with an odd quotient, so the 8 rows a
// warp reads at one column fall in 8 distinct groups of 4 banks
__host__ __device__ constexpr int f32_stride(int d) { return d + ((d / 4) % 2 == 0 ? 4 : 8); }

// row stride (values) of the ring of raw tiles: the f32 tile itself for f32
// pools; bf16 rows padded by 16 bytes
template <typename KVT>
__host__ __device__ constexpr int raw_stride(int d) {
  return std::is_same<KVT, float>::value ? f32_stride(d) : d + 8;
}

// whether the wide layout scores on the tensor cores: q and the pools in
// bf16, Dk whole k-steps of 16, Dv two halves of whole pairs of 8 columns
template <typename KVT>
__host__ __device__ bool mma_scores(int q_bf16, int dk, int dv) {
  return std::is_same<KVT, __nv_bfloat16>::value && q_bf16 && dk % 16 == 0 && dv % 32 == 0;
}

// byte offsets of the split body's dynamic shared memory, 16-byte aligned
struct SplitSmem {
  int rowidx, lastq, alpha, m, l, q, p, ring, stages, bytes;
};

// narrow_only: the layout of a launch whose runs are all single rows of at
// most kNarrowRows query rows (queries of one warp each, no P); mma: the
// wide layout's scores on the tensor cores (bf16 queries, no P); latent: the
// mma layout whose stages hold the K tile alone (V is its first Dv columns).
// The ring has three stages where they fit, else two.
template <typename KVT>
__host__ __device__ SplitSmem split_smem(int dk, int dv, bool narrow_only, bool mma,
                                         bool latent = false) {
  const int rows = narrow_only ? kNarrowRows : kQRows;  // query rows of a pass
  SplitSmem s;
  int off = 0;
  s.rowidx = off;  // [kSplitRows] physical row of each context row of the split
  off += kSplitRows * 4;
  s.lastq = off;  // [rows] each query row's last row, -1 if none in the split
  off += rows * 4;
  s.alpha = off;  // [rows] the tile's rescale of each query row's accumulator
  off += rows * 4;
  s.m = off;  // [rows] running max, after the last tile
  off += rows * 4;
  s.l = off;  // [rows] running denominator, after the last tile
  off += rows * 4;
  s.q = off;  // the pass's queries: [rows][f32_stride(dk)] f32, or [kQRows][dk + 8] bf16
  const int q_f32 = rows * f32_stride(dk) * 4, q_bf16 = kQRows * (dk + 8) * 2;
  off += narrow_only || !mma ? q_f32 : max(q_bf16, kNarrowRows * f32_stride(dk) * 4);
  s.p = off;  // [kTile][kQRows + 4] the tile's probabilities (wide, f32 scores)
  if (!narrow_only && !mma) off += kTile * (kQRows + 4) * 4;
  s.ring = off;  // [stages][K tile, V tile] as stored in the pools (latent: K tile)
  const int stage =
      kTile * (raw_stride<KVT>(dk) + (latent ? 0 : raw_stride<KVT>(dv))) * (int)sizeof(KVT);
  s.stages = off + 3 * stage + kStaticSmem <= kMaxSmem ? 3 : 2;
  off += s.stages * stage;
  s.bytes = off;
  return s;
}

// 4 consecutive values of a tile row as f32
__device__ __forceinline__ float4 ld4(const float* p) { return *(const float4*)p; }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 raw = *(const uint2*)p;
  const __nv_bfloat162* b2 = (const __nv_bfloat162*)&raw;
  const float2 a = __bfloat1622float2(b2[0]), b = __bfloat1622float2(b2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// The work of one CTA of the split body: the run's rows against the split's
// context rows (split_rows of them from split * split_rows on), for one kv
// head. In the latent mode kpool is the c pool (rows of Dv) and vpool the kr
// pool (rows of Dk - Dv).
template <typename KVT>
struct SplitCta {
  const void* q;
  int q_bf16;
  const KVT* kpool;
  const KVT* vpool;
  const int* pos;
  float* out;
  float* part;
  int t_rows, kvh, g, dk, dv, bs, nb_slot, ring_width, max_rows, nsplit;
  float scale;
  int first, cnt, split, h, n_begin, nrows, ntiles, split_rows;
  unsigned char* smem;
  SplitSmem lay;
};

// tile `tile` of the split into ring stage `st`, one commit group (empty
// past the last tile); rows past the split are zero-filled, not read. LAT:
// each K row is its c row (Dv values) then its kr row, and no V tile.
template <typename KVT, bool LAT>
__device__ __forceinline__ void fetch_tile(const SplitCta<KVT>& c, int tile, int st) {
  constexpr int kVec = 16 / (int)sizeof(KVT);  // values per 16-byte copy
  if constexpr (LAT) {
    if (tile < c.ntiles) {
      const int rk = raw_stride<KVT>(c.dk), dr = c.dk - c.dv;
      const int cc = c.dv / kVec, per = c.dk / kVec;  // copies per c row and per K row
      const int* rowidx = (const int*)(c.smem + c.lay.rowidx);
      KVT* kst = (KVT*)(c.smem + c.lay.ring) + (size_t)st * kTile * rk;
      for (int e = threadIdx.x; e < kTile * per; e += kSplitThreads) {
        const int r = e / per, i = e - r * per, lr = tile * kTile + r;
        const bool ok = lr < c.nrows;
        const size_t prow = ok ? (size_t)rowidx[lr] : 0;
        const KVT* src = i < cc ? c.kpool + prow * c.dv + i * kVec
                                : c.vpool + prow * dr + (i - cc) * kVec;
        cp_async16(kst + r * rk + i * kVec, src, ok ? 16 : 0);
      }
    }
  } else if (tile < c.ntiles) {
    const int rk = raw_stride<KVT>(c.dk), rv = raw_stride<KVT>(c.dv);
    const int ck = c.dk / kVec, cv = c.dv / kVec;  // copies per K and V row
    const int* rowidx = (const int*)(c.smem + c.lay.rowidx);
    KVT* kst = (KVT*)(c.smem + c.lay.ring) + (size_t)st * kTile * (rk + rv);
    KVT* vst = kst + kTile * rk;
    for (int e = threadIdx.x; e < kTile * (ck + cv); e += kSplitThreads) {
      const bool isk = e < kTile * ck;
      const int e2 = isk ? e : e - kTile * ck, per = isk ? ck : cv;
      const int r = e2 / per, i = e2 - r * per, lr = tile * kTile + r;
      const bool ok = lr < c.nrows;
      const size_t prow = ok ? (size_t)rowidx[lr] * c.kvh + c.h : 0;
      const KVT* src = isk ? c.kpool + prow * c.dk + i * kVec : c.vpool + prow * c.dv + i * kVec;
      KVT* dst = isk ? kst + r * rk + i * kVec : vst + r * rv + i * kVec;
      cp_async16(dst, src, ok ? 16 : 0);
    }
  }
  cp_async_commit();
}

// A thread's columns col0 + step * jj (W each, jj < COLS, below col_end) of
// query row f of the run after its last tile: the output, divided by the
// denominator, when all the token's rows (up to lq) lie in split 0; else this
// split's partial state for the merge, its max and denominator written by
// the head lane.
template <typename KVT, int COLS, int W>
__device__ __forceinline__ void store_row(const SplitCta<KVT>& c, int f, int lq,
                                          const float* a, int step, int col0, int col_end,
                                          float mm, float ll, bool head_lane) {
  const size_t rows = (size_t)c.t_rows * c.kvh * c.g;
  const int ti = c.first + f / c.g, gi = f - (f / c.g) * c.g;
  const size_t row = ((size_t)ti * c.kvh + c.h) * c.g + gi;
  const bool direct = lq < c.split_rows;
  float* dst = direct ? c.out + row * c.dv : c.part + ((size_t)c.split * rows + row) * c.dv;
#pragma unroll
  for (int jj = 0; jj < COLS; ++jj) {
    const int col = col0 + step * jj;
    if (col < col_end) {
      float o[W];
#pragma unroll
      for (int w = 0; w < W; ++w) o[w] = direct ? a[jj * W + w] / ll : a[jj * W + w];
      if constexpr (W == 4)
        *(float4*)(dst + col) = make_float4(o[0], o[1], o[2], o[3]);
      else
        *(float2*)(dst + col) = make_float2(o[0], o[1]);
    }
  }
  if (!direct && head_lane) {
    float* pm = c.part + (size_t)c.nsplit * rows * c.dv;
    pm[(size_t)c.split * rows + row] = mm;
    pm[(size_t)c.nsplit * rows + (size_t)c.split * rows + row] = ll;
  }
}

// One pass of the split body over query rows [c0, c0 + rows of the pass) of
// the run. Tiles stream through the ring: at each tile's barrier the stage
// the last tile used is refilled, so the next stages' loads are in flight
// while this tile is computed from shared memory as it arrived (bf16 values
// converted where they are read). PASS:
//  * kNarrow (at most kNarrowRows query rows: a decode token's G heads, a
//    padding row): warp w holds query row w; its lanes score the tile's 32
//    K rows, the softmax state is the warp's, and each lane accumulates 4
//    columns of Dv per 128, P taken from the scoring lane by a shuffle.
//  * kMma (up to kQRows rows of bf16 q and pools, a prefill
//    run): warp w takes rows 16 (w % 4) .. + 15 and half w / 4 of Dv. Its
//    scores against the tile's 32 K rows are mma.sync m16n8k16 (bf16
//    products exact in f32, f32 sums; the two warps of a row group compute
//    the same scores), a row's softmax state is shared by the 4 lanes of a
//    quad, and P.V is mma.sync from the score fragments with P in three
//    bf16 parts (hi, mid, lo: P to 2^-25 of itself, not rounded to bf16)
//    against V as it arrived. Nothing crosses warps.
//  * kFma (up to kQRows rows, f32 q or pools): thread (tq, tr) scores rows 2 tq,
//    2 tq + 1 against K rows tr + 8 j, the 8 lanes of one tq sharing its
//    rows' state; P goes through shared memory, and thread (pq, pd)
//    accumulates rows 4 pq .. + 3 x columns 4 pd + 64 jj.
//  * kLatent: kMma's arithmetic on the latent tile, V its first Dv columns;
//    a row group with no live row in the pass skips each tile's arithmetic.
template <typename KVT, int VJ, int PASS>
__device__ __forceinline__ void split_pass(const SplitCta<KVT>& c, int c0) {
  constexpr bool NARROW = PASS == kNarrow, LAT = PASS == kLatent;
  constexpr bool use_mma = PASS == kMma || LAT;
  constexpr int kRows = NARROW ? kNarrowRows : kQRows;
  constexpr int kVn = (VJ + 1) / 2;  // 128-column groups of Dv (narrow)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* lastq = (int*)(c.smem + c.lay.lastq);
  float* alpha_s = (float*)(c.smem + c.lay.alpha);
  float* m_s = (float*)(c.smem + c.lay.m);
  float* l_s = (float*)(c.smem + c.lay.l);
  float* qsm = (float*)(c.smem + c.lay.q);
  float* psm = (float*)(c.smem + c.lay.p);
  const KVT* ring = (const KVT*)(c.smem + c.lay.ring);
  const int stages = c.lay.stages;
  const int qs = f32_stride(c.dk), ps = kQRows + 4, qbs = c.dk + 8;
  const int rk = raw_stride<KVT>(c.dk), rv = LAT ? rk : raw_stride<KVT>(c.dv);
  const int stage = kTile * (LAT ? rk : rk + rv);  // values of a ring stage
  const int qrows = c.cnt * c.g;

  __syncthreads();  // rowidx is written; the previous pass is done
  if constexpr (LAT) {
    // the pass's queries are consecutive rows of q (one kv head): 16-byte
    // copies that join the first tile's commit group, zero past the run
    constexpr int kVec = 16 / (int)sizeof(KVT);
    const int per = c.dk / kVec;
    const KVT* qg = (const KVT*)c.q + ((size_t)c.first * c.g + c0) * c.dk;
    for (int e = tid; e < kQRows * per; e += kSplitThreads) {
      const int r = e / per, i = e - r * per;
      const bool ok = c0 + r < qrows;
      cp_async16((KVT*)qsm + r * qbs + i * kVec, ok ? qg + (size_t)r * c.dk + i * kVec : qg,
                 ok ? 16 : 0);
    }
  }
  for (int s = 0; s < stages - 1; ++s) fetch_tile<KVT, LAT>(c, s, s);
  // the pass's queries, 4 values a load, 4 loads in flight a thread, while
  // the first tiles arrive; rows past the run stay as they are (a query row
  // without rows in the split is never scored into a result)
  const int qn = LAT ? 0 : min(kRows, qrows - c0), dq = c.dk / 4;
  for (int e0 = tid; e0 < qn * dq; e0 += 4 * kSplitThreads) {
    float4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * kSplitThreads;
      if (e < qn * dq) {
        const int qi = e / dq, d = (e - qi * dq) * 4, f = c0 + qi, i = f / c.g;
        const size_t at =
            (((size_t)(c.first + i) * c.kvh + c.h) * c.g + (f - i * c.g)) * c.dk + d;
        if constexpr (use_mma) {  // the 4 bf16 values as they are
          const uint2 raw = *(const uint2*)((const __nv_bfloat16*)c.q + at);
          x[u] = make_float4(__uint_as_float(raw.x), __uint_as_float(raw.y), 0.0f, 0.0f);
        } else {
          x[u] = c.q_bf16 ? ld4((const __nv_bfloat16*)c.q + at) : ld4((const float*)c.q + at);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * kSplitThreads;
      if (e < qn * dq) {
        const int qi = e / dq;
        const int d = (e - qi * dq) * 4;
        if constexpr (use_mma)
          *(uint2*)((__nv_bfloat16*)qsm + qi * qbs + d) =
              make_uint2(__float_as_uint(x[u].x), __float_as_uint(x[u].y));
        else
          *(float4*)(qsm + qi * qs + d) = x[u];
      }
    }
  }
  if (tid < kRows) {
    const int f = c0 + tid;
    int lq = -1;
    if (f < qrows) {
      lq = last_row(c.pos[c.first + f / c.g], c.ring_width, c.max_rows, c.nb_slot, c.bs);
      if (lq < c.n_begin) lq = -1;  // the token reads no row of this split
    }
    lastq[tid] = lq;
  }
  // (the tile loop's first barrier publishes the queries and limits)

  // the narrow layout's state: query row `warp`
  float mw = kNeg, lw = 0.0f, accw[4 * kVn];
  // the wide layouts' state: two query rows' max and denominator, and the
  // accumulator (f32 FMAs: acc[row i][column]; mma: acc[element][tile])
  const int tr = lane & 7, tq = warp * 4 + (lane >> 3), q0 = 2 * tq;
  const unsigned gmask = 0xffu << (lane & 24);
  const int pd = lane & 15, p0 = 4 * (warp * 2 + (lane >> 4));
  const int mt = warp & 3, half = c.dv / 2, col0 = (warp >> 2) * half;  // mma
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};
  float acc[NARROW ? 1 : 4][4 * VJ];
  if constexpr (NARROW) {
#pragma unroll
    for (int i = 0; i < 4 * kVn; ++i) accw[i] = 0.0f;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4 * VJ; ++j) acc[i][j] = 0.0f;
  }

  for (int it = 0; it < c.ntiles; ++it) {
    if (stages == 3)
      cp_async_wait<1>();  // every group but the newest: tile `it` has landed
    else
      cp_async_wait<0>();
    __syncthreads();  // ... for every thread; the last tile's readers are done
    fetch_tile<KVT, LAT>(c, it + stages - 1, (it + stages - 1) % stages);  // the last tile's stage
    const KVT* kt = ring + (size_t)(it % stages) * stage;
    const KVT* vt = LAT ? kt : kt + kTile * rk;
    const int n0 = c.n_begin + it * kTile;
    const int rn = min(kTile, c.nrows - it * kTile);

    if constexpr (NARROW) {
      const int lqw = lastq[warp];
      if (lqw >= 0) {
        // lane r scores K row r in four interleaved chains, summed in a
        // fixed order
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll 4
        for (int d = 0; d < c.dk; d += 4) {
          const float4 a = *(const float4*)(qsm + warp * qs + d);
          const float4 b = ld4(kt + lane * rk + d);
          s0 = fmaf(a.x, b.x, s0);
          s1 = fmaf(a.y, b.y, s1);
          s2 = fmaf(a.z, b.z, s2);
          s3 = fmaf(a.w, b.w, s3);
        }
        const float s = ((s0 + s1) + (s2 + s3)) * c.scale;
        const bool ok = n0 + lane <= lqw;
        float mx = ok ? s : kNeg;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(mw, mx);
        const float alpha = expf(mw - m_new);
        const float p = ok ? expf(s - m_new) : 0.0f;
        float sum = p;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        lw = lw * alpha + sum;
        mw = m_new;
#pragma unroll
        for (int i = 0; i < 4 * kVn; ++i) accw[i] *= alpha;
        for (int r = 0; r < rn; ++r) {
          const float pr = __shfl_sync(0xffffffffu, p, r);
#pragma unroll
          for (int jj = 0; jj < kVn; ++jj) {
            const int col = lane * 4 + 128 * jj;
            if (col < c.dv) {
              const float4 v4 = ld4(vt + r * rv + col);
              accw[jj * 4 + 0] = fmaf(pr, v4.x, accw[jj * 4 + 0]);
              accw[jj * 4 + 1] = fmaf(pr, v4.y, accw[jj * 4 + 1]);
              accw[jj * 4 + 2] = fmaf(pr, v4.z, accw[jj * 4 + 2]);
              accw[jj * 4 + 3] = fmaf(pr, v4.w, accw[jj * 4 + 3]);
            }
          }
        }
      }
    } else if constexpr (use_mma) {
      if constexpr (std::is_same<KVT, __nv_bfloat16>::value) {
        // (latent) a row group with no live row in the pass skips the tile
        if (LAT && !__any_sync(0xffffffffu, lastq[16 * mt + (lane & 15)] >= 0)) continue;
        // score n, element e: K row 8 n + 2 (lane % 4) + e % 2 of query row
        // 16 mt + lane / 4 + 8 (e / 2)
        const __nv_bfloat16* qb = (const __nv_bfloat16*)qsm;
        float sc[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
        for (int k0 = 0; k0 < c.dk; k0 += 16) {
          unsigned a0, a1, a2, a3;
          ldsm_x4(a0, a1, a2, a3,
                  qb + (16 * mt + (lane & 7) + 8 * ((lane >> 3) & 1)) * qbs + k0 + 8 * (lane >> 4));
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            unsigned b0, b1, b2, b3;
            ldsm_x4(b0, b1, b2, b3,
                    kt + (16 * jp + (lane & 7) + 8 * (lane >> 4)) * rk + k0 +
                        8 * ((lane >> 3) & 1));
            mma_bf16(sc[2 * jp], a0, a1, a2, a3, b0, b1);
            mma_bf16(sc[2 * jp + 1], a0, a1, a2, a3, b2, b3);
          }
        }
        // the online softmax over the tile, max and sum in a fixed xor tree
        // over the 4 lanes of a quad; sc becomes P
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int lq = lastq[16 * mt + (lane >> 2) + 8 * i];
          float mx = kNeg;
          bool ok[8];
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              ok[2 * n + e] = n0 + 8 * n + 2 * (lane & 3) + e <= lq;
              sc[n][2 * i + e] *= c.scale;
              if (ok[2 * n + e]) mx = fmaxf(mx, sc[n][2 * i + e]);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[i], mx);
          const float alpha = expf(m[i] - m_new);
          float sum = 0.0f;
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float pv = ok[2 * n + e] ? expf(sc[n][2 * i + e] - m_new) : 0.0f;
              sc[n][2 * i + e] = pv;
              sum += pv;
            }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          l[i] = l[i] * alpha + sum;
          m[i] = m_new;
#pragma unroll
          for (int j = 0; j < 4 * VJ; ++j) {  // query row i: elements 2 i, 2 i + 1
            acc[2 * i][j] *= alpha;
            acc[2 * i + 1][j] *= alpha;
          }
        }
        // P.V: P (16 x 32) from the score fragments as the A operand, in
        // three bf16 parts; V (32 x 8 per column tile) transposed by ldmatrix
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          unsigned pa0[3], pa1[3], pa2[3], pa3[3];
          split3(sc[2 * kk][0], sc[2 * kk][1], pa0);
          split3(sc[2 * kk][2], sc[2 * kk][3], pa1);
          split3(sc[2 * kk + 1][0], sc[2 * kk + 1][1], pa2);
          split3(sc[2 * kk + 1][2], sc[2 * kk + 1][3], pa3);
#pragma unroll
          for (int jp = 0; jp < 2 * VJ; ++jp) {
            if (16 * jp < half) {
              unsigned b0, b1, b2, b3;
              ldsm_x4_t(b0, b1, b2, b3,
                        vt + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * rv + col0 +
                            16 * jp + 8 * (lane >> 4));
#pragma unroll
              for (int k = 0; k < 3; ++k) {
                float d0[4] = {acc[0][2 * jp], acc[1][2 * jp], acc[2][2 * jp], acc[3][2 * jp]};
                float d1[4] = {acc[0][2 * jp + 1], acc[1][2 * jp + 1], acc[2][2 * jp + 1],
                               acc[3][2 * jp + 1]};
                mma_bf16(d0, pa0[k], pa1[k], pa2[k], pa3[k], b0, b1);
                mma_bf16(d1, pa0[k], pa1[k], pa2[k], pa3[k], b2, b3);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  acc[e][2 * jp] = d0[e];
                  acc[e][2 * jp + 1] = d1[e];
                }
              }
            }
          }
        }
      }
    } else {
      const int lq0 = lastq[q0], lq1 = lastq[q0 + 1];
      if (lq0 >= 0 || lq1 >= 0) {  // uniform over the 8 lanes of tq
        float s[2][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) s[0][j] = s[1][j] = 0.0f;
#pragma unroll 4
        for (int d = 0; d < c.dk; d += 4) {
          const float4 a0 = *(const float4*)(qsm + q0 * qs + d);
          const float4 a1 = *(const float4*)(qsm + (q0 + 1) * qs + d);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 b = ld4(kt + (tr + 8 * j) * rk + d);
            s[0][j] = fmaf(a0.x, b.x, s[0][j]);
            s[0][j] = fmaf(a0.y, b.y, s[0][j]);
            s[0][j] = fmaf(a0.z, b.z, s[0][j]);
            s[0][j] = fmaf(a0.w, b.w, s[0][j]);
            s[1][j] = fmaf(a1.x, b.x, s[1][j]);
            s[1][j] = fmaf(a1.y, b.y, s[1][j]);
            s[1][j] = fmaf(a1.z, b.z, s[1][j]);
            s[1][j] = fmaf(a1.w, b.w, s[1][j]);
          }
        }
        // the online softmax over the tile: max and sum in a fixed xor tree
        // over the 8 lanes of tq, so all 8 hold the same bits
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int lq = i ? lq1 : lq0;
          float mx = kNeg;
          bool ok[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            ok[j] = n0 + tr + 8 * j <= lq;
            s[i][j] *= c.scale;
            if (ok[j]) mx = fmaxf(mx, s[i][j]);
          }
#pragma unroll
          for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(gmask, mx, off));
          const float m_new = fmaxf(m[i], mx);
          const float alpha = expf(m[i] - m_new);
          float sum = 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
            psm[(tr + 8 * j) * ps + q0 + i] = p;
            sum += p;
          }
#pragma unroll
          for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(gmask, sum, off);
          l[i] = l[i] * alpha + sum;
          m[i] = m_new;
          if (tr == 0) alpha_s[q0 + i] = alpha;
        }
      }
      __syncthreads();
      bool pv_rows = false;
#pragma unroll
      for (int i = 0; i < 4; ++i) pv_rows |= lastq[p0 + i] >= 0;
      if (pv_rows) {
        float al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) al[i] = alpha_s[p0 + i];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4 * VJ; ++j) acc[i][j] *= al[i];
        for (int r = 0; r < rn; ++r) {
          const float4 p4 = *(const float4*)(psm + r * ps + p0);
          const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int jj = 0; jj < VJ; ++jj) {
            const int col = pd * 4 + 64 * jj;
            if (col < c.dv) {
              const float4 v4 = ld4(vt + r * rv + col);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                acc[i][jj * 4 + 0] = fmaf(pr[i], v4.x, acc[i][jj * 4 + 0]);
                acc[i][jj * 4 + 1] = fmaf(pr[i], v4.y, acc[i][jj * 4 + 1]);
                acc[i][jj * 4 + 2] = fmaf(pr[i], v4.z, acc[i][jj * 4 + 2]);
                acc[i][jj * 4 + 3] = fmaf(pr[i], v4.w, acc[i][jj * 4 + 3]);
              }
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // results: a token whose rows all lie in split 0 is done here; any other
  // leaves this split's state (accumulator, max, denominator) to the merge
  if constexpr (NARROW) {
    const int lqw = lastq[warp];
    if (lqw >= 0)
      store_row<KVT, kVn, 4>(c, c0 + warp, lqw, accw, 128, lane * 4, c.dv, mw, lw, lane == 0);
  } else if constexpr (use_mma) {
    // query rows 16 mt + lane / 4 (+ 8), columns col0 + 8 j + 2 (lane % 4)
    // (+ 1) of the warp's half of Dv
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = 16 * mt + (lane >> 2) + 8 * i, lq = lastq[qi];
      if (lq < 0) continue;
      float v[8 * VJ];
#pragma unroll
      for (int j = 0; j < 4 * VJ; ++j) {
        v[2 * j] = acc[2 * i][j];
        v[2 * j + 1] = acc[2 * i + 1][j];
      }
      store_row<KVT, 4 * VJ, 2>(c, c0 + qi, lq, v, 8, col0 + 2 * (lane & 3),
                                col0 + half, m[i], l[i], warp < 4 && (lane & 3) == 0);
    }
  } else {
    if ((lastq[q0] >= 0 || lastq[q0 + 1] >= 0) && tr == 0) {
      m_s[q0] = m[0];
      l_s[q0] = l[0];
      m_s[q0 + 1] = m[1];
      l_s[q0 + 1] = l[1];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (lastq[p0 + i] >= 0)
        store_row<KVT, VJ, 4>(c, c0 + p0 + i, lastq[p0 + i], acc[i], 64, pd * 4,
                              c.dv, m_s[p0 + i], l_s[p0 + i], pd == 0);
  }
}

// One CTA per (run x split, kv head): every query row of the run (its tokens
// x G heads) against the context rows [split * kSplitRows, + kSplitRows) of
// the run's table row, in passes of kNarrowRows query rows (a run of at most
// that many) or kQRows. VJ: 64-column groups of Dv (Dv <= 64 * VJ).
// MODE: kNarrow (every run one row of at most kNarrowRows query rows), kMma
// or kFma (the wide pass's kind).
// `part` holds the partial states of tokens that span more than one split:
// accumulators [nsplit][T * KVH * G][Dv], then maxima and denominators
// [nsplit][T * KVH * G].
template <typename KVT, int VJ, int MODE>
__global__ void __launch_bounds__(kSplitThreads,
                                  MODE == kNarrow ? 4 : VJ > 2 ? 1 : MODE == kMma ? 3 : 2)
    paged_attn_split_kernel(const void* __restrict__ q, int q_bf16,
                            const KVT* __restrict__ kpool, const KVT* __restrict__ vpool,
                            const int* __restrict__ table, const int* __restrict__ pos,
                            const int* __restrict__ runs, float* __restrict__ out,
                            float* __restrict__ part, int t_rows, int kvh, int g, int dk,
                            int dv, int bs, int nb_slot, int ring_width, int max_rows,
                            float scale, int nsplit) {
  extern __shared__ __align__(16) unsigned char smem_split[];
  __shared__ int warp_last[kSplitThreads / 32];
  SplitCta<KVT> c{q, q_bf16, kpool, vpool, pos, out, part, t_rows, kvh, g, dk, dv, bs,
                  nb_slot, ring_width, max_rows, nsplit, scale};
  c.smem = smem_split;
  c.lay = split_smem<KVT>(dk, dv, MODE == kNarrow, MODE == kMma);
  c.split_rows = kSplitRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int run = blockIdx.x / nsplit;
  c.split = blockIdx.x - run * nsplit;
  c.h = blockIdx.y;
  c.first = runs ? runs[2 * run] : run;
  c.cnt = runs ? runs[2 * run + 1] : 1;

  // the run's last row, the largest of its tokens'; the split's rows of the
  // table row are looked up beside it (up to the table's end), so that the
  // two loads overlap
  int mine = -1;
  for (int i = tid; i < c.cnt; i += kSplitThreads)
    mine = max(mine, last_row(pos[c.first + i], ring_width, max_rows, nb_slot, bs));
  const int* trow = table + (size_t)c.first * nb_slot;
  c.n_begin = c.split * kSplitRows;
  int* rowidx = (int*)(smem_split + c.lay.rowidx);
  for (int r = tid; r < kSplitRows; r += kSplitThreads) {
    const int n = min(c.n_begin + r, nb_slot * bs - 1);
    rowidx[r] = trow[n / bs] * bs + n % bs;
  }
  mine = __reduce_max_sync(0xffffffffu, mine);
  if (lane == 0) warp_last[warp] = mine;
  __syncthreads();
  int run_last = warp_last[0];
#pragma unroll
  for (int w = 1; w < kSplitThreads / 32; ++w) run_last = max(run_last, warp_last[w]);
  if (c.n_begin > run_last) return;  // the whole CTA: past the run's context
  c.nrows = min(kSplitRows, run_last + 1 - c.n_begin);
  c.ntiles = (c.nrows + kTile - 1) / kTile;

  const int qrows = c.cnt * g;
  if (MODE == kNarrow || qrows <= kNarrowRows) {
    split_pass<KVT, VJ, kNarrow>(c, 0);
  } else if constexpr (MODE != kNarrow) {
    for (int c0 = 0; c0 < qrows; c0 += kQRows) split_pass<KVT, VJ, MODE>(c, c0);
  }
}

// The latent mode: persistent CTAs (as many as the card holds at once) walk
// the call's items, an item being one pass of kQRows query rows of one run
// against one context split of it, in the order (run, split, pass): item i
// goes to CTA i % grid. So the passes of a long run (a 16-token prefill run
// is 10 at G 40) and its splits spread over the card instead of queueing in
// one CTA, and a decode step's few runs still put a split on every CTA.
// Every CTA first counts each run's items (its last row, so its live
// splits, times its passes) and their prefix sums in shared memory, past the
// split layout: [n_runs + 1] items before each run, [n_runs] last rows.
template <int VJ>
__global__ void __launch_bounds__(kSplitThreads, VJ > 4 ? 1 : 2)
    paged_attn_latent_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ cpool,
                             const __nv_bfloat16* __restrict__ krpool,
                             const int* __restrict__ table, const int* __restrict__ pos,
                             const int* __restrict__ runs, float* __restrict__ out,
                             float* __restrict__ part, int t_rows, int n_runs, int g, int dk,
                             int dv, int bs, int nb_slot, int max_rows, float scale,
                             int nsplit, int split_rows) {
  using KVT = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_split[];
  __shared__ int warp_sum[kSplitThreads / 32];
  SplitCta<KVT> c{q, 1, cpool, krpool, pos, out, part, t_rows, 1, g, dk, dv, bs,
                  nb_slot, 0, max_rows, nsplit, scale};
  c.smem = smem_split;
  c.lay = split_smem<KVT>(dk, dv, false, true, true);
  c.split_rows = split_rows;
  c.h = 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* before = (int*)(smem_split + c.lay.bytes);  // [n_runs + 1]
  int* run_last = before + n_runs + 1;             // [n_runs]

  // each run's items, and their prefix sums, kSplitThreads runs at a time
  int carry = 0;
  if (tid == 0) before[0] = 0;
  for (int r0 = 0; r0 < n_runs; r0 += kSplitThreads) {
    const int r = r0 + tid;
    int items = 0;
    if (r < n_runs) {
      const int first = runs ? runs[2 * r] : r, cnt = runs ? runs[2 * r + 1] : 1;
      int last = 0;
      for (int i = 0; i < cnt; ++i)
        last = max(last, last_row(pos[first + i], 0, max_rows, nb_slot, bs));
      run_last[r] = last;
      items = (last / split_rows + 1) * ((cnt * g + kQRows - 1) / kQRows);
    }
    int incl = items;  // inclusive scan over the warp, then over the warps
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int below = carry;
    for (int w = 0; w < warp; ++w) below += warp_sum[w];
    if (r < n_runs) before[r + 1] = below + incl;
    for (int w = 0; w < kSplitThreads / 32; ++w) carry += warp_sum[w];
    __syncthreads();
  }
  const int total = carry;

  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    int lo = 0, hi = n_runs - 1;  // the run: the last r with before[r] <= item
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (before[mid] <= item) lo = mid; else hi = mid - 1;
    }
    const int r = lo;
    c.first = runs ? runs[2 * r] : r;
    c.cnt = runs ? runs[2 * r + 1] : 1;
    const int passes = (c.cnt * g + kQRows - 1) / kQRows, local = item - before[r];
    c.split = local / passes;
    c.n_begin = c.split * split_rows;
    c.nrows = min(split_rows, run_last[r] + 1 - c.n_begin);
    c.ntiles = (c.nrows + kTile - 1) / kTile;
    __syncthreads();  // the last item's readers of rowidx are done
    const int* trow = table + (size_t)c.first * nb_slot;
    int* rowidx = (int*)(smem_split + c.lay.rowidx);
    for (int i = tid; i < c.nrows; i += kSplitThreads) {
      const int n = c.n_begin + i;
      rowidx[i] = trow[n / bs] * bs + n % bs;
    }
    split_pass<KVT, VJ, kLatent>(c, (local - c.split * passes) * kQRows);
  }
}

// One CTA per (token, kv head, gh heads) of a token that spans more than one
// split of split_rows rows: the splits' states merged in split order, 4
// columns a thread.
__global__ void __launch_bounds__(128) paged_attn_merge_kernel(
    const float* __restrict__ part, const int* __restrict__ pos, float* __restrict__ out,
    int t_rows, int kvh, int g, int dv, int bs, int nb_slot, int ring_width, int max_rows,
    int nsplit, int split_rows, int gh) {
  const int t = blockIdx.x, h = blockIdx.y, g0 = blockIdx.z * gh, ng = min(gh, g - g0);
  const int ns = last_row(pos[t], ring_width, max_rows, nb_slot, bs) / split_rows + 1;
  if (ns == 1) return;
  const size_t rows = (size_t)t_rows * kvh * g;
  const float* pm = part + (size_t)nsplit * rows * dv;
  const float* pl = pm + (size_t)nsplit * rows;
  const size_t row0 = ((size_t)t * kvh + h) * g + g0;
  const int dq = dv / 4;
  for (int e = threadIdx.x; e < ng * dq; e += 128) {
    const int gi = e / dq, d = (e - gi * dq) * 4;
    const size_t row = row0 + gi;
    float big = pm[row];
#pragma unroll 4
    for (int s = 1; s < ns; ++s) big = fmaxf(big, pm[(size_t)s * rows + row]);
    float4 num = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float den = 0.0f;
#pragma unroll 4
    for (int s = 0; s < ns; ++s) {
      const float w = expf(pm[(size_t)s * rows + row] - big);
      const float4 a = *(const float4*)(part + ((size_t)s * rows + row) * dv + d);
      num.x = fmaf(a.x, w, num.x);
      num.y = fmaf(a.y, w, num.y);
      num.z = fmaf(a.z, w, num.z);
      num.w = fmaf(a.w, w, num.w);
      den = fmaf(pl[(size_t)s * rows + row], w, den);
    }
    *(float4*)(out + row * dv + d) =
        make_float4(num.x / den, num.y / den, num.z / den, num.w / den);
  }
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

// the split body for head dims of up to 256 whose rows are whole 16-byte
// copies at 16-byte aligned pools, in the shared memory of one block
template <typename KVT>
bool split_takes(const void* k, const void* v, int dk, int dv) {
  return dk <= 256 && dv <= 256 && (dk * (int)sizeof(KVT)) % 16 == 0 &&
         (dv * (int)sizeof(KVT)) % 16 == 0 && (uintptr_t)k % 16 == 0 &&
         (uintptr_t)v % 16 == 0 &&
         split_smem<KVT>(dk, dv, false, false).bytes + kStaticSmem <= kMaxSmem;
}

template <typename KVT, int VJ, int MODE>
int launch_split(const void* q, int q_bf16, const void* k, const void* v, const void* table,
                 const void* pos, const void* runs, void* out, void* scratch, int t,
                 int n_runs, int nsplit, int kvh, int g, int dk, int dv, int bs, int nb_slot,
                 int ring_width, int max_rows, float scale, cudaStream_t stream,
                 int* kernels) {
  const int bytes = split_smem<KVT>(dk, dv, MODE == kNarrow, MODE == kMma).bytes;
  cudaError_t err = cudaFuncSetAttribute(paged_attn_split_kernel<KVT, VJ, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_runs * nsplit, kvh);
  paged_attn_split_kernel<KVT, VJ, MODE><<<grid, kSplitThreads, bytes, stream>>>(
      q, q_bf16, (const KVT*)k, (const KVT*)v, (const int*)table, (const int*)pos,
      (const int*)runs, (float*)out, (float*)scratch, t, kvh, g, dk, dv, bs, nb_slot,
      ring_width, max_rows, scale, nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  paged_attn_merge_kernel<<<dim3(t, kvh), 128, 0, stream>>>(
      (const float*)scratch, (const int*)pos, (float*)out, t, kvh, g, dv, bs, nb_slot,
      ring_width, max_rows, nsplit, kSplitRows, g);
  *kernels = 2;
  return (int)cudaGetLastError();
}

template <typename KVT, int VJ>
int launch_split_vj(const void* q, int q_bf16, const void* k, const void* v,
                    const void* table, const void* pos, const void* runs, void* out,
                    void* scratch, int t, int n_runs, int nsplit, int kvh, int g, int dk,
                    int dv, int bs, int nb_slot, int ring_width, int max_rows, float scale,
                    cudaStream_t stream, int* kernels) {
  // every run a single row of at most kNarrowRows query rows: the host
  // knows it without reading the runs (no runs, or as many as rows)
  const bool narrow_only = (runs == nullptr || n_runs == t) && g <= kNarrowRows;
#define PAGED_ATTN_SPLIT(MODE)                                                                \
  return launch_split<KVT, VJ, MODE>(q, q_bf16, k, v, table, pos, runs, out, scratch, t,      \
                                     n_runs, nsplit, kvh, g, dk, dv, bs, nb_slot, ring_width, \
                                     max_rows, scale, stream, kernels);
  if (narrow_only) PAGED_ATTN_SPLIT(kNarrow)
  if constexpr (std::is_same<KVT, __nv_bfloat16>::value)
    if (mma_scores<KVT>(q_bf16, dk, dv)) PAGED_ATTN_SPLIT(kMma)
  PAGED_ATTN_SPLIT(kFma)
#undef PAGED_ATTN_SPLIT
}

template <typename KVT>
int launch_split_for(const void* q, int q_bf16, const void* k, const void* v,
                     const void* table, const void* pos, const void* runs, void* out,
                     void* scratch, int t, int n_runs, int nsplit, int kvh, int g, int dk,
                     int dv, int bs, int nb_slot, int ring_width, int max_rows, float scale,
                     cudaStream_t stream, int* kernels) {
#define PAGED_ATTN_SPLIT(VJ)                                                                 \
  if (dv <= 64 * VJ)                                                                         \
    return launch_split_vj<KVT, VJ>(q, q_bf16, k, v, table, pos, runs, out, scratch, t,      \
                                    n_runs, nsplit, kvh, g, dk, dv, bs, nb_slot, ring_width, \
                                    max_rows, scale, stream, kernels);
  PAGED_ATTN_SPLIT(1) PAGED_ATTN_SPLIT(2) PAGED_ATTN_SPLIT(3) PAGED_ATTN_SPLIT(4)
#undef PAGED_ATTN_SPLIT
  return (int)cudaErrorInvalidValue;
}

// the latent mode: bf16, Dc whole pairs of 16-column tiles up to 512, Dr
// whole k-steps, 16-byte aligned pools, a split of whole tiles up to
// kSplitRows, in the shared memory of one block
bool latent_takes(const void* c, const void* kr, int dc, int dr, int split_rows) {
  return dc % 32 == 0 && dc <= 512 && dr % 16 == 0 && dr > 0 && split_rows % kTile == 0 &&
         split_rows >= kTile && split_rows <= kSplitRows && (uintptr_t)c % 16 == 0 &&
         (uintptr_t)kr % 16 == 0 &&
         split_smem<__nv_bfloat16>(dc + dr, dc, false, true, true).bytes + kStaticSmem <=
             kMaxSmem;
}

template <int VJ>
int launch_latent(const void* q, const void* c, const void* kr, const void* table,
                  const void* pos, const void* runs, void* out, void* scratch, int t,
                  int n_runs, int nsplit, int split_rows, int g, int dc, int dr, int bs,
                  int nb_slot, int max_rows, float scale, cudaStream_t stream, int* kernels,
                  int* ctas) {
  const int dk = dc + dr;
  const int bytes = split_smem<__nv_bfloat16>(dk, dc, false, true, true).bytes +
                    (2 * n_runs + 1) * (int)sizeof(int);
  if (bytes + kStaticSmem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(paged_attn_latent_kernel<VJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  // as many CTAs as the card holds at once, and no more than there can be
  // items: at most nsplit x (T G / kQRows + n_runs) passes
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, paged_attn_latent_kernel<VJ>,
                                                           kSplitThreads, bytes)) != cudaSuccess)
    return (int)err;
  const long most = (long)nsplit * ((long)t * g / kQRows + n_runs);
  *ctas = (int)max(1L, min((long)sms * max(per_sm, 1), most));
  paged_attn_latent_kernel<VJ><<<*ctas, kSplitThreads, bytes, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)c, (const __nv_bfloat16*)kr,
      (const int*)table, (const int*)pos, (const int*)runs, (float*)out, (float*)scratch, t,
      n_runs, g, dk, dc, bs, nb_slot, max_rows, scale, nsplit, split_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  // 128 threads of 4 columns: 128 / (Dv / 4) heads a CTA (at least one)
  const int gh = max(1, 128 / (dc / 4));
  paged_attn_merge_kernel<<<dim3(t, 1, (g + gh - 1) / gh), 128, 0, stream>>>(
      (const float*)scratch, (const int*)pos, (float*)out, t, 1, g, dc, bs, nb_slot, 0,
      max_rows, nsplit, split_rows, gh);
  *kernels = 2;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Context rows per CTA of the split body: the wrapper sizes the scratch of
// nsplit = ceil(rows a token may read / this) splits.
int paged_attn_split_rows() { return kSplitRows; }

// out (t, kvh, g, dv) f32 = paged attention of q over the pools through
// `table`, on `stream`, with t, kvh, g, dk, dv, bs, nb_slot, max_rows >= 1.
// q_bf16 / kv_bf16 say whether q / the pools hold bf16 (else f32). `runs`
// is null (every row its own run) or n_runs (first row, count) pairs, the
// precondition above; nsplit = ceil(min(nb_slot * bs, ring_width or
// max_rows) / kSplitRows), and `scratch` holds nsplit * t * kvh * g *
// (dv + 2) floats when nsplit > 1. *kernels receives the kernels launched.
// *body receives the body that ran (kBodySplit or kBodyTiled). Returns
// cudaGetLastError() after the launches (0 when they were accepted), or
// cudaErrorInvalidValue when one row of the head dims cannot fit in shared
// memory.
int paged_attn(const void* q, const void* k, const void* v, const void* table,
               const void* pos, const void* runs, void* out, void* scratch, int t, int n_runs,
               int nsplit, int kvh, int g, int dk, int dv, int bs, int nb_slot,
               int ring_width, int max_rows, float scale, int q_bf16, int kv_bf16,
               void* stream, int* kernels, int* body) {
  cudaStream_t s = (cudaStream_t)stream;
  *kernels = 1;
  *body = kBodySplit;
  if (nsplit < 1 || (nsplit > 1 && scratch == nullptr)) return (int)cudaErrorInvalidValue;
  if (kv_bf16 ? split_takes<__nv_bfloat16>(k, v, dk, dv) : split_takes<float>(k, v, dk, dv))
    return kv_bf16
        ? launch_split_for<__nv_bfloat16>(q, q_bf16, k, v, table, pos, runs, out, scratch, t,
                                          n_runs, nsplit, kvh, g, dk, dv, bs, nb_slot,
                                          ring_width, max_rows, scale, s, kernels)
        : launch_split_for<float>(q, q_bf16, k, v, table, pos, runs, out, scratch, t, n_runs,
                                  nsplit, kvh, g, dk, dv, bs, nb_slot, ring_width, max_rows,
                                  scale, s, kernels);
  *body = kBodyTiled;
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

// The absorbed-MLA call: out (t, g, dc) f32 = paged attention of q (t, g, dc
// + dr) bf16 over K rows [c ; kr] and V rows c, the pools c (NB, bs, dc) and
// kr (NB, bs, dr) bf16 as the cache holds them, through `table`, on
// `stream`, the split body's latent mode. `runs` as for paged_attn; nsplit =
// ceil(min(nb_slot * bs, max_rows) / split_rows), split_rows one of 32, 64,
// 128, and `scratch` holds nsplit * t * g * (dc + 2) floats when nsplit > 1.
// *kernels receives the kernels launched, *body kBodyLatent, *ctas the
// latent kernel's grid. Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a shape the latent mode does not take
// (latent_takes).
int paged_latent_attn(const void* q, const void* c, const void* kr, const void* table,
                      const void* pos, const void* runs, void* out, void* scratch, int t,
                      int n_runs, int nsplit, int split_rows, int g, int dc, int dr, int bs,
                      int nb_slot, int max_rows, float scale, void* stream, int* kernels,
                      int* body, int* ctas) {
  cudaStream_t s = (cudaStream_t)stream;
  *kernels = 1;
  *body = kBodyLatent;
  *ctas = 0;
  if (nsplit < 1 || (nsplit > 1 && scratch == nullptr) || !latent_takes(c, kr, dc, dr, split_rows))
    return (int)cudaErrorInvalidValue;
  if (dc <= 256)
    return launch_latent<4>(q, c, kr, table, pos, runs, out, scratch, t, n_runs, nsplit,
                            split_rows, g, dc, dr, bs, nb_slot, max_rows, scale, s, kernels,
                            ctas);
  return launch_latent<8>(q, c, kr, table, pos, runs, out, scratch, t, n_runs, nsplit,
                          split_rows, g, dc, dr, bs, nb_slot, max_rows, scale, s, kernels, ctas);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
