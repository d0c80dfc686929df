// GLM gradient and SGD over merge batches for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/engine/engine.py::_glm_kernel
// (launched by glm_grad_pallas through pl.pallas_call) and the scan over
// merge batches around it (repro/core/engine.py::_epoch_impl). One kernel
// body serves two entries:
//
//   glm_sgd_chunk  x (N, D), y (N,), mask (N,), w (D,) f32 -> w_out (D,),
//                  gnorms (ceil(N / coef),): for each merge batch b of `coef`
//                  rows in order, g = X_b^T (err(X_b w, y_b) * mask_b),
//                  gnorms[b] = |g|_2, then w <- a*w - b*g.
//   glm_grad       the one-batch case (coef = N): writes g, updates nothing.
//
// err is z - y (linear), sigmoid(z) - y (logistic) or (y*z < 1 ? -y : 0)
// (svm), as in repro/kernels/engine/ref.py::glm_error.
//
// Bound: bytes. X, y and mask are read once (N*(D+2)*4 bytes) and each element
// of X takes two multiply-adds, far below the card's f32 rate per byte. But at
// the TRAIN path's merge batch (256, 54) X is 55 KB and its bound 17 ns: the
// chain of batches is serial (batch b+1 needs the w that batch b wrote), so a
// launch per batch, and the host's launches around it, set the time. Hence one
// launch walks all of a chunk's batches in order on one CTA:
//
// - w and g stay in shared memory for the whole launch (D <= 8,192; wider
//   models keep them in a global scratch of 3*D floats and read X in place);
// - X streams through a two-stage ring in tiles of whole rows (at most 64 KB
//   and 1,024 rows, never across a batch; at D = 54 one tile is one batch,
//   one contiguous span). A producer warp keeps the next tile's rows of X, y
//   and mask in flight while 16 consumer warps compute: the TMA copies each
//   span's 16-byte-aligned body and cp.async the few words around it (rows
//   start anywhere on the 4-byte grid), each span landing at its source's
//   alignment (tma_ring.cuh); a full and an empty mbarrier a stage hand the
//   stages over;
// - D <= 256: each consumer warp takes a contiguous block of the tile's rows,
//   each row on a segment of L lanes (L the power of two that gives each lane
//   at most 8 of the row's features). A lane loads its features of 4 rows at
//   once into registers and sums z = x.w for them; a shuffle tree within the
//   segment gives every lane of it z; lane i evaluates e = err(z, y) * mask
//   for the i-th row of the warp's 4 x 32/L (one err a row) and shuffles
//   hand each segment its rows' e; each lane adds e * x to its features'
//   partial sums, still in registers: X is read from shared memory once. At
//   the batch's end the partials are summed over the warp's segments by
//   shuffles and over the warps in order;
// - D > 256: z a segment a row as above, then e through shared memory, then
//   g = X^T e a thread a feature, the rows in four chains (X read twice);
// - a tile's sums join the batch's with compensation, so a batch of many
//   tiles (glm_grad over a whole chunk) keeps its digits. The norm's squares
//   sum per thread, then per warp and over the warps by shuffles in a fixed
//   tree.
//
// The ragged last batch and the last tile are masked inside: rows at or past N
// are never read. No float atomics and no order that depends on timing, so a
// second call gives the same bits. The update is a*w - b*g with each product
// rounded (no contraction into an FMA), as the plain version computes it.
// Logistic uses 1/(1+expf(-z)), not __expf, and no fast-math flag is set.
#include <cuda_runtime.h>

#include <cstdint>

#include "tma_ring.cuh"

namespace {

constexpr int kThreads = 512;  // consumers; one more warp produces
constexpr int kWarps = kThreads / 32;
constexpr int kStageFloats = 16384;  // X per ring stage: 64 KB
constexpr int kMaxTileRows = 1024;
constexpr int kMaxSmemWidth = 8192;  // w and g in shared memory up to this D
constexpr int kZCache = 8;           // features per lane held in registers
constexpr int kZRows = 4;            // rows a lane segment takes at once
constexpr int kFastWidth = 32 * kZCache;  // X read once up to this D

enum Act { kLinear = 0, kLogistic = 1, kSvm = 2 };

__device__ __forceinline__ float glm_error(float z, float y, int act) {
  if (act == kLinear) return z - y;
  if (act == kLogistic) return __frcp_rn(1.0f + expf(-z)) - y;  // 1/(1+e^-z), rounded once
  return (y * z < 1.0f) ? -y : 0.0f;
}

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Float offsets into dynamic shared memory, all on the 16-byte grid; the four
// mbarriers (full and empty, a stage each) take the first 32 bytes. Ring stage
// s holds x at stage + s * stage_floats, y and mask ys and ms floats further.
struct Layout {
  int red, norm, e, w, g, c, stage, stage_floats, ys, ms, total;
};

struct Plan {
  long long n;
  int d, coef;
  int rows;             // rows per tile
  int tiles_per_batch;  // of a full batch
  int tiles;            // in the launch
  int lanes;            // z: lanes per row (a power of two)
  Layout l;
};

__host__ inline Plan make_plan(long long n, int d, int coef, bool staged) {
  Plan p;
  p.n = n;
  p.d = d;
  p.coef = coef;
  int rows = coef < kMaxTileRows ? coef : kMaxTileRows;
  if (staged && rows > kStageFloats / d) rows = kStageFloats / d;
  p.rows = rows;
  p.tiles_per_batch = (coef + rows - 1) / rows;
  const long long nb = (n + coef - 1) / coef;
  const long long last = n - (nb - 1) * coef;
  p.tiles = (int)((nb - 1) * p.tiles_per_batch + (last + rows - 1) / rows);
  int lanes = 1;
  while (lanes < 32 && lanes * kZCache < d) lanes *= 2;
  p.lanes = lanes;
  const bool fast = d <= kFastWidth;
  Layout& l = p.l;
  int o = 8;
  l.red = o; o += fast ? kWarps * round4(d) : 0;
  l.norm = o; o += kWarps;
  l.e = o; o += fast ? 0 : round4(rows);
  l.w = l.g = l.c = l.stage = l.stage_floats = l.ys = l.ms = 0;
  if (staged) {
    l.w = o; o += round4(d);
    if (!fast) {
      l.g = o; o += round4(d);
      l.c = o; o += round4(d);
    }
    l.ys = round4(rows * d) + 4;  // + up to 3 words of alignment each
    l.ms = l.ys + round4(rows) + 4;
    l.stage_floats = l.ms + round4(rows) + 4;
    l.stage = o; o += 2 * l.stage_floats;
  }
  l.total = o;
  return p;
}

// The consumer warps' barrier (the producer warp never joins it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// sum += v with Kahan's compensation in comp
__device__ __forceinline__ void kahan_add(float& sum, float& comp, float v) {
  const float y = v - comp;
  const float t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

// sum over rows r < rows of e[r] * xs[r * d + f], in four interleaved chains
// added in a fixed tree
__device__ __forceinline__ float column_sum(const float* xs, const float* e, int d, int f,
                                            int rows) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  int r = 0;
  for (; r + 3 < rows; r += 4) {
    s0 = fmaf(e[r], xs[(size_t)r * d + f], s0);
    s1 = fmaf(e[r + 1], xs[(size_t)(r + 1) * d + f], s1);
    s2 = fmaf(e[r + 2], xs[(size_t)(r + 2) * d + f], s2);
    s3 = fmaf(e[r + 3], xs[(size_t)(r + 3) * d + f], s3);
  }
  for (; r < rows; ++r) s0 = fmaf(e[r], xs[(size_t)r * d + f], s0);
  return (s0 + s1) + (s2 + s3);
}

struct Tile {
  long long row0;
  int rows, batch;
  bool first, last;  // of its batch
};

__device__ __forceinline__ Tile tile_of(const Plan& p, int j) {
  Tile t;
  t.batch = j / p.tiles_per_batch;
  const int k = j - t.batch * p.tiles_per_batch;
  const long long start = (long long)t.batch * p.coef;
  const long long end = start + p.coef < p.n ? start + p.coef : p.n;
  t.row0 = start + (long long)k * p.rows;
  t.rows = (int)(end - t.row0 < p.rows ? end - t.row0 : p.rows);
  t.first = k == 0;
  t.last = t.row0 + t.rows == end;
  return t;
}

// One thread issues tile t's rows of x, y and mask into ring stage s: the
// 16-byte bodies by the TMA, the few words around them by cp.async. The
// stage's full barrier (count 2) completes when both have landed.
__device__ __forceinline__ void issue_tile(const Plan& p, const Tile& t, int s, float* smem,
                                           uint64_t* bar, const float* __restrict__ x,
                                           const float* __restrict__ y,
                                           const float* __restrict__ mask) {
  float* base = smem + p.l.stage + s * p.l.stage_floats;
  const Span sx = span_of(base, x + t.row0 * p.d, t.rows * p.d);
  const Span sy = span_of(base + p.l.ys, y + t.row0, t.rows);
  const Span sm = span_of(base + p.l.ms, mask + t.row0, t.rows);
  mbar_arrive_expect_tx(bar, 16u * (sx.body + sy.body + sm.body));
  copy_span(sx, bar);
  copy_span(sy, bar);
  copy_span(sm, bar);
  cp_async_arrive(bar);
}

// kStaged: X through the ring, w (and for D > 256 g and its compensation) in
// shared memory, D <= kMaxSmemWidth; else X, y and mask read in place, and w,
// g and g's compensation in `work` (3*D floats). kFast: D <= kFastWidth, X
// read once into registers. g_out set: the one-batch gradient, written there,
// and no update.
template <bool kStaged, bool kFast>
__global__ void __launch_bounds__(kThreads + 32, 1) glm_sgd_kernel(
    const Plan p, const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ mask, const float* __restrict__ w_in, float* __restrict__ w_out,
    float* __restrict__ g_out, float* __restrict__ gnorms, float* __restrict__ work, int act,
    float a, float b) {
  extern __shared__ __align__(16) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + 2;
  float* red_s = smem + p.l.red;
  float* norm_s = smem + p.l.norm;
  float* e_s = smem + p.l.e;
  float* w = kStaged ? smem + p.l.w : work;
  float* g = kStaged ? smem + p.l.g : work + p.d;
  float* c = kStaged ? smem + p.l.c : work + 2 * p.d;
  const int d = p.d;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int f = tid; f < d; f += kThreads + 32) w[f] = w_in[f];
  if (kStaged && tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 2);
      mbar_init(&empty[s], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();  // the last barrier of all the block's threads

  if (warp == kWarps) {  // the producer
    if (kStaged && lane == 0) {
      for (int j = 0; j < p.tiles; ++j) {
        const int s = j & 1;
        if (j >= 2) mbar_wait(&empty[s], ((j - 2) >> 1) & 1);
        issue_tile(p, tile_of(p, j), s, smem, &full[s], x, y, mask);
      }
      // its last copies have landed before it leaves
      mbar_wait(&full[(p.tiles - 1) & 1], ((p.tiles - 1) >> 1) & 1);
    }
    return;
  }

  const int L = p.lanes;
  const int seg = lane / L;
  const int sub = lane & (L - 1);
  const int segs = 32 / L;
  float acc[kZCache], cmp[kZCache];  // kFast: this lane's features sub + k*L
#pragma unroll
  for (int k = 0; k < kZCache; ++k) acc[k] = cmp[k] = 0.0f;

  for (int j = 0; j < p.tiles; ++j) {
    const Tile t = tile_of(p, j);
    const float* xs;
    const float* ys;
    const float* ms;
    if (kStaged) {
      const int s = j & 1;
      mbar_wait(&full[s], (j >> 1) & 1);
      const float* base = smem + p.l.stage + s * p.l.stage_floats;
      xs = base + misalign(x + t.row0 * d);
      ys = base + p.l.ys + misalign(y + t.row0);
      ms = base + p.l.ms + misalign(mask + t.row0);
    } else {
      xs = x + t.row0 * d;
      ys = y + t.row0;
      ms = mask + t.row0;
    }
    // each warp a contiguous block of the tile's rows
    const int per_warp = (t.rows + kWarps - 1) / kWarps;
    const int rbeg = min(t.rows, warp * per_warp);
    const int rend = min(t.rows, rbeg + per_warp);

    if (kFast) {
      float wr[kZCache], ts[kZCache];
#pragma unroll
      for (int k = 0; k < kZCache; ++k) {
        const int f = sub + k * L;
        wr[k] = f < d ? w[f] : 0.0f;
        ts[k] = 0.0f;
      }
      // a segment takes kZRows consecutive rows: at the same q the segments
      // are kZRows rows apart (at D = 54 their banks do not collide)
      const bool shared_err = kZRows * segs <= 32;
      for (int r0 = rbeg; r0 < rend; r0 += kZRows * segs) {
        float xv[kZRows][kZCache], z[kZRows], e[kZRows];
#pragma unroll
        for (int q = 0; q < kZRows; ++q) {
          const int r = r0 + seg * kZRows + q;
          const float* xr = xs + (size_t)r * d;
          z[q] = 0.0f;
#pragma unroll
          for (int k = 0; k < kZCache; ++k) {
            const int f = sub + k * L;
            xv[q][k] = r < rend && f < d ? xr[f] : 0.0f;
            z[q] = fmaf(xv[q][k], wr[k], z[q]);
          }
        }
        for (int off = L >> 1; off > 0; off >>= 1) {
#pragma unroll
          for (int q = 0; q < kZRows; ++q) z[q] += __shfl_xor_sync(0xffffffffu, z[q], off);
        }
        if (shared_err) {
          // lane i evaluates err for row r0 + i once, then every segment
          // fetches its rows' e
          float zi = 0.0f;
#pragma unroll
          for (int q = 0; q < kZRows; ++q) {
            const float v = __shfl_sync(0xffffffffu, z[q], (lane / kZRows) * L);
            if (lane % kZRows == q) zi = v;
          }
          const int r = r0 + lane;
          const float ei = r < rend ? glm_error(zi, ys[r], act) * ms[r] : 0.0f;
#pragma unroll
          for (int q = 0; q < kZRows; ++q) e[q] = __shfl_sync(0xffffffffu, ei, seg * kZRows + q);
        } else {
#pragma unroll
          for (int q = 0; q < kZRows; ++q) {
            const int r = r0 + seg * kZRows + q;
            e[q] = r < rend ? glm_error(z[q], ys[r], act) * ms[r] : 0.0f;
          }
        }
#pragma unroll
        for (int q = 0; q < kZRows; ++q) {
#pragma unroll
          for (int k = 0; k < kZCache; ++k) ts[k] = fmaf(e[q], xv[q][k], ts[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kZCache; ++k) {
        if (t.first) {
          acc[k] = ts[k];
          cmp[k] = 0.0f;
        } else {
          kahan_add(acc[k], cmp[k], ts[k]);
        }
      }
      if (t.last) {  // the warp's segments summed; segment 0 writes the warp's g
        for (int off = L; off < 32; off <<= 1) {
#pragma unroll
          for (int k = 0; k < kZCache; ++k) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
        }
        if (seg == 0) {
#pragma unroll
          for (int k = 0; k < kZCache; ++k) {
            const int f = sub + k * L;
            if (f < d) red_s[warp * d + f] = acc[k];
          }
        }
      }
    } else {
      // z a segment a row, e through shared memory, then g a thread a feature
      for (int r0 = rbeg; r0 < rend; r0 += kZRows * segs) {
        float z[kZRows];
#pragma unroll
        for (int q = 0; q < kZRows; ++q) {
          const int r = r0 + q * segs + seg;
          z[q] = 0.0f;
          if (r < rend) {
            const float* xr = xs + (size_t)r * d;
            for (int f = sub; f < d; f += L) z[q] = fmaf(xr[f], w[f], z[q]);
          }
        }
        for (int off = L >> 1; off > 0; off >>= 1) {
#pragma unroll
          for (int q = 0; q < kZRows; ++q) z[q] += __shfl_xor_sync(0xffffffffu, z[q], off);
        }
        if (sub == 0) {
#pragma unroll
          for (int q = 0; q < kZRows; ++q) {
            const int r = r0 + q * segs + seg;
            if (r < rend) e_s[r] = glm_error(z[q], ys[r], act) * ms[r];
          }
        }
      }
      consumers_sync();
      for (int f = tid; f < d; f += kThreads) {
        const float tile_sum = column_sum(xs, e_s, d, f, t.rows);
        if (t.first) {
          g[f] = tile_sum;
          c[f] = 0.0f;
        } else {
          float sum = g[f], comp = c[f];
          kahan_add(sum, comp, tile_sum);
          g[f] = sum;
          c[f] = comp;
        }
      }
    }
    consumers_sync();  // the stage is read: hand it back to the producer
    if (kStaged && tid == 0) mbar_arrive(&empty[j & 1]);
    if (!t.last) continue;

    // the batch's end: g over the warps in order, the update, the norm
    float sq = 0.0f;
    for (int f = tid; f < d; f += kThreads) {
      float gv;
      if (kFast) {
        gv = 0.0f;
#pragma unroll
        for (int i = 0; i < kWarps; ++i) gv += red_s[i * d + f];
      } else {
        gv = g[f];
      }
      if (g_out) {
        g_out[f] = gv;
      } else {
        w[f] = __fsub_rn(__fmul_rn(a, w[f]), __fmul_rn(b, gv));
      }
      sq = fmaf(gv, gv, sq);
    }
    if (gnorms) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
      if (lane == 0) norm_s[warp] = sq;
    }
    consumers_sync();
    if (gnorms && warp == 0) {  // the warps' sums, in a fixed tree
      float s = lane < kWarps ? norm_s[lane] : 0.0f;
#pragma unroll
      for (int off = kWarps / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) gnorms[t.batch] = sqrtf(s);
    }
  }
  if (w_out)
    for (int f = tid; f < d; f += kThreads) w_out[f] = w[f];
}

int launch(const void* x, const void* y, const void* mask, const void* w_in, void* w_out,
           void* g_out, void* gnorms, void* work, long long n, int d, int coef, int act,
           float a, float b, void* stream) {
  const bool staged = d <= kMaxSmemWidth;
  const bool fast = d <= kFastWidth;
  const Plan p = make_plan(n, d, coef, staged);
  const size_t bytes = (size_t)p.l.total * sizeof(float);
  auto kern = !staged ? glm_sgd_kernel<false, false>
              : fast  ? glm_sgd_kernel<true, true>
                      : glm_sgd_kernel<true, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<1, kThreads + 32, bytes, (cudaStream_t)stream>>>(
      p, (const float*)x, (const float*)y, (const float*)mask, (const float*)w_in,
      (float*)w_out, (float*)g_out, (float*)gnorms, (float*)work, act, a, b);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The widest D whose w and g stay in shared memory; wider needs `work`.
int glm_sgd_max_smem_width() { return kMaxSmemWidth; }

// w_out (d,) and gnorms (ceil(n / coef),) on `stream`: SGD over the merge
// batches of coef rows in order, with n, d, coef >= 1. `work` is scratch of
// 3*d floats when d > glm_sgd_max_smem_width(), else unused. Returns
// cudaGetLastError() after the launch (0 when it was accepted).
int glm_sgd_chunk(const void* x, const void* y, const void* mask, const void* w_in,
                  void* w_out, void* gnorms, void* work, int n, int d, int coef, int act,
                  float a, float b, void* stream) {
  return launch(x, y, mask, w_in, w_out, nullptr, gnorms, work, n, d, coef, act, a, b,
                stream);
}

// out (d,) = X^T (err(X w, y) * mask) on `stream`, with n >= 1 and d >= 1:
// glm_sgd_chunk's one-batch case. `work` as there.
int glm_grad(const void* x, const void* y, const void* w, const void* mask, void* out,
             void* work, int n, int d, int act, void* stream) {
  return launch(x, y, mask, w, nullptr, out, nullptr, work, n, d, n, act, 0.0f, 0.0f,
                stream);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
