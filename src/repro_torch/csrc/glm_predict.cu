// GLM scoring for Hopper (sm_90a): out[i] = mask[i] > 0 ? act(x[i] . w) : 0.
//
// Replaces the TPU kernel repro/kernels/engine/engine.py::_glm_predict_kernel
// (launched by glm_predict_pallas through pl.pallas_call). Same contract:
// x (N, D) f32, w (D,), mask (N,) f32 or bool -> (N,) f32 with act z
// (linear), 1/(1+expf(-z)) (logistic) or (z >= 0 ? 1 : -1) (svm), as in
// repro/kernels/engine/ref.py::glm_act.
//
// Bound: bytes. Each element of X is read once for one multiply-add, and X is
// never reused, so this matrix-vector product gains nothing from the tensor
// cores: 3.35 TB/s of device memory sets the least time, the live rows of X,
// the mask and w read once and the output written once. At the scan's chunk
// (70,656 x 54, 65% of rows live, a bool mask) that is 10.3 MB, 3.1 us; every
// row of X, which a design that streams whole tiles reads, 15.8 MB, 4.7 us.
//
// Design: a streaming pass that keeps enough bytes in flight.
//
// - Persistent CTAs (three an SM) stride over tiles of R consecutive rows:
//   one contiguous span of R*D*4 bytes, 16-byte aligned when x is (R is a
//   multiple of 4). At D = 54, R = 128: 27.6 KB a tile, two stages a CTA.
// - A producer thread keeps a ring of stages full: it copies each tile's rows
//   of X by the TMA as soon as a stage is free (tma_ring.cuh: the 16-byte
//   body by cp.async.bulk, the few words around it by cp.async when x's base
//   is only 4-byte aligned). A full and an empty mbarrier a stage hand the
//   stages over. Nothing the producer issues waits on a load of its own.
// - Eight consumer warps take a contiguous block of each tile's rows (at most
//   32), each row on a segment of L lanes (L the power of two that leaves
//   each lane at most 8 features; 8 at D = 54). Lane i loads the mask of the
//   warp's i-th row of the next tile while this one is scored, so the mask's
//   latency hides behind the copies. w sits in registers for the whole
//   launch. A lane sums its features of 4 rows, a fixed shuffle tree within
//   the segment gives z, and lane i evaluates act and the select for the
//   i-th row of the warp's group, so a group's outputs leave in one coalesced
//   store.
// - Wider rows (a stage holds fewer than 4) take a second body in the same
//   kernel: a consumer warp a row, read in place from device memory with 8
//   loads a lane in flight.
//
// The launch geometry (R, the stages, L, the grid, the stage size) comes
// from kernels/engine/kernel.py::glm_predict_plan. The last tile is masked
// inside: rows at or past N are never read. Each row's sum has a fixed order
// and there are no float atomics, so a second call gives the same bits. A
// dead row is written as 0 by a select, never as a product with the mask: a
// dead row of inf or 1e38 would otherwise give NaN. expf, not __expf, and no
// fast-math flag, so logistic rounds as torch.sigmoid's 1/(1+exp(-z)) does.
#include <cuda_runtime.h>

#include <cstdint>

#include "tma_ring.cuh"

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * (kConsumerWarps + 1);  // one more warp produces
constexpr int kMinBlocks = 3;  // resident CTAs an SM the registers must allow
constexpr int kMaxStages = 4;
constexpr int kMaxTileRows = 32 * kConsumerWarps;  // a warp's block of a tile: at most 32 rows
constexpr int kBarrierBytes = 2 * kMaxStages * 8;  // full, then empty, a stage each
constexpr int kZCache = 8;    // features a lane holds in registers
constexpr int kZRows = 4;     // rows a lane segment takes at once
constexpr int kWideBatch = 8;  // loads a lane has in flight in the wide body

enum Act { kLinear = 0, kLogistic = 1, kSvm = 2 };
enum Body { kStagedFew = 0, kStagedMany = 1, kWide = 2 };

struct Plan {
  long long n;
  int d, act, mask_bytes;
  int rows;         // per tile
  int tiles;        // ceil(n / rows); CTA b takes tiles b, b + grid, ...
  int stages;       // of the ring
  int lanes;        // a row's segment
  int stage_bytes;  // stage s at kBarrierBytes + s * stage_bytes
};

__device__ __forceinline__ float glm_act(float z, int act) {
  if (act == kLinear) return z;
  if (act == kLogistic) return 1.0f / (1.0f + expf(-z));
  return z >= 0.0f ? 1.0f : -1.0f;
}

__device__ __forceinline__ bool live_at(const void* mask, int mask_bytes, long long i) {
  if (mask_bytes == 1) return __ldg(static_cast<const unsigned char*>(mask) + i) != 0;
  return __ldg(static_cast<const float*>(mask) + i) > 0.0f;
}

// The producer: one thread copies the rows of X of each of the CTA's tiles
// into the ring as soon as a stage is free. The full barrier (count 2)
// completes when its cp.async words have landed and the bulk copy's bytes are
// in.
__device__ __forceinline__ void produce(const Plan& p, unsigned char* smem, uint64_t* full,
                                        uint64_t* empty, const float* __restrict__ x) {
  int j = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, ++j) {
    const int s = j % p.stages;
    const long long row0 = (long long)t * p.rows;
    const int rows = (int)min((long long)p.rows, p.n - row0);
    if (j >= p.stages) mbar_wait(&empty[s], (j / p.stages - 1) & 1);
    float* stage = reinterpret_cast<float*>(smem + kBarrierBytes + (size_t)s * p.stage_bytes);
    const Span sx = span_of(stage, x + row0 * p.d, rows * p.d);
    mbar_arrive_expect_tx(&full[s], 16u * sx.body);
    copy_span(sx, &full[s]);
    cp_async_arrive(&full[s]);
  }
  // its last copies have landed before it leaves
  if (j > 0) mbar_wait(&full[(j - 1) % p.stages], ((j - 1) / p.stages) & 1);
}

// The first of a consumer warp's rows of a tile, and their count (at most 32):
// each warp takes a contiguous block.
__device__ __forceinline__ int warp_rows(int rows, int warp, int& count) {
  const int per_warp = (rows + kConsumerWarps - 1) / kConsumerWarps;
  const int first = min(rows, warp * per_warp);
  count = min(rows, first + per_warp) - first;
  return first;
}

// Whether row `first + lane` of the tile at row0 is live (false past count).
__device__ __forceinline__ bool lane_live(const Plan& p, const void* __restrict__ mask,
                                          long long row0, int first, int count, int lane) {
  return lane < count && live_at(mask, p.mask_bytes, row0 + first + lane);
}

// The wide body: each consumer warp scores one row of each of the CTA's tiles
// (p.rows == kConsumerWarps), reading it in place.
__device__ __forceinline__ void score_wide(const Plan& p, const float* __restrict__ x,
                                           const float* __restrict__ w,
                                           const void* __restrict__ mask,
                                           float* __restrict__ out, int warp, int lane) {
  const int d = p.d;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const long long row = (long long)t * p.rows + warp;
    if (row >= p.n) continue;
    const bool live = live_at(mask, p.mask_bytes, row);  // warp-uniform
    float z = 0.0f;
    if (live) {
      const float* xr = x + row * d;
      float acc[kWideBatch];
#pragma unroll
      for (int u = 0; u < kWideBatch; ++u) acc[u] = 0.0f;
      for (int f0 = 0; f0 < d; f0 += 32 * kWideBatch) {
        float xv[kWideBatch], wv[kWideBatch];
#pragma unroll
        for (int u = 0; u < kWideBatch; ++u) {
          const int f = f0 + 32 * u + lane;
          xv[u] = f < d ? __ldg(xr + f) : 0.0f;
          wv[u] = f < d ? __ldg(w + f) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kWideBatch; ++u) acc[u] = fmaf(xv[u], wv[u], acc[u]);
      }
#pragma unroll
      for (int h = kWideBatch / 2; h > 0; h >>= 1) {
#pragma unroll
        for (int u = 0; u < h; ++u) acc[u] += acc[u + h];
      }
      z = acc[0];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) z += __shfl_xor_sync(0xffffffffu, z, off);
    }
    if (lane == 0) out[row] = live ? glm_act(z, p.act) : 0.0f;
  }
}

// kStagedFew: D <= 32 * kZCache, a lane's features of w in registers.
// kStagedMany: D up to a quarter of a stage, w read through the L1.
// kWide: no ring; score_wide.
template <int kBody>
__global__ void __launch_bounds__(kThreads, kMinBlocks) glm_predict_kernel(
    const Plan p, const float* __restrict__ x, const float* __restrict__ w,
    const void* __restrict__ mask, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int d = p.d;

  if (kBody == kWide) {
    if (warp < kConsumerWarps) score_wide(p, x, w, mask, out, warp, lane);
    return;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 2);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (warp == kConsumerWarps) {
    if (lane == 0) produce(p, smem, full, empty, x);
    return;
  }

  const int L = p.lanes;
  const int seg = lane / L;
  const int sub = lane & (L - 1);
  const int group = kZRows * (32 / L);  // a warp's rows at once
  float wr[kZCache];
#pragma unroll
  for (int k = 0; k < kZCache; ++k) {
    const int f = sub + k * L;
    wr[k] = kBody == kStagedFew && f < d ? __ldg(w + f) : 0.0f;
  }

  // lane i holds the mask of the warp's i-th row of the tile, loaded a tile
  // ahead so that its latency hides behind the copies
  int count;
  int first = warp_rows((int)min((long long)p.rows, p.n - (long long)blockIdx.x * p.rows), warp,
                        count);
  bool live = lane_live(p, mask, (long long)blockIdx.x * p.rows, first, count, lane);
  int j = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, ++j) {
    const int s = j % p.stages;
    const long long row0 = (long long)t * p.rows;
    const int n_cur = count;
    const int r_beg = first;
    const bool live_cur = live;
    const long long next = row0 + (long long)gridDim.x * p.rows;
    if (next < p.n) {
      first = warp_rows((int)min((long long)p.rows, p.n - next), warp, count);
      live = lane_live(p, mask, next, first, count, lane);
    }
    mbar_wait(&full[s], (j / p.stages) & 1);
    const float* xs = reinterpret_cast<const float*>(smem + kBarrierBytes +
                                                     (size_t)s * p.stage_bytes) +
                      misalign(x + row0 * d);
    float* o = out + row0 + r_beg;
    for (int g = 0; g < n_cur; g += group) {
      // a segment takes kZRows consecutive rows: at the same q the segments
      // are kZRows rows apart (at D = 54 their banks do not collide)
      float z[kZRows];
#pragma unroll
      for (int q = 0; q < kZRows; ++q) {
        const int r = g + seg * kZRows + q;
        z[q] = 0.0f;
        if (r < n_cur) {
          const float* xr = xs + (size_t)(r_beg + r) * d;
          if (kBody == kStagedFew) {
#pragma unroll
            for (int k = 0; k < kZCache; ++k) {
              const int f = sub + k * L;
              if (f < d) z[q] = fmaf(xr[f], wr[k], z[q]);
            }
          } else {
            for (int f = sub; f < d; f += L) z[q] = fmaf(xr[f], __ldg(w + f), z[q]);
          }
        }
      }
      for (int off = L >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int q = 0; q < kZRows; ++q) z[q] += __shfl_xor_sync(0xffffffffu, z[q], off);
      }
      if (group <= 32) {
        // lane i takes row g + i: one coalesced store of the group's outputs
        float zi = 0.0f;
#pragma unroll
        for (int q = 0; q < kZRows; ++q) {
          const float v = __shfl_sync(0xffffffffu, z[q], (lane / kZRows) * L);
          if (lane % kZRows == q) zi = v;
        }
        const int r = g + lane;
        const bool li = __shfl_sync(0xffffffffu, live_cur, r & 31);
        if (lane < group && r < n_cur) o[r] = li ? glm_act(zi, p.act) : 0.0f;
      } else {  // L < 4: a warp's rows are one group; each segment stores its own
#pragma unroll
        for (int q = 0; q < kZRows; ++q) {
          const int r = seg * kZRows + q;
          const bool lq = __shfl_sync(0xffffffffu, live_cur, r & 31);
          if (sub == 0 && r < n_cur) o[r] = lq ? glm_act(z[q], p.act) : 0.0f;
        }
      }
    }
    __syncwarp();  // the warp's reads of the stage are done: hand it back
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

bool valid(const Plan& p, int body, int grid, int smem_bytes) {
  const bool pow2 = p.lanes >= 1 && p.lanes <= 32 && (p.lanes & (p.lanes - 1)) == 0;
  if (body < kStagedFew || body > kWide || grid < 1 || p.n < 1 || p.d < 0 || !pow2 ||
      (p.mask_bytes != 1 && p.mask_bytes != 4) || p.act < kLinear || p.act > kSvm ||
      p.rows < 1 || p.tiles != (p.n + p.rows - 1) / p.rows)
    return false;
  if (body == kWide) return p.rows == kConsumerWarps;
  if (body == kStagedFew ? p.lanes * kZCache < p.d : p.lanes != 32) return false;
  return p.rows <= kMaxTileRows && p.stages >= 1 && p.stages <= kMaxStages &&
         p.stage_bytes >= 4 * (p.rows * p.d + 3) && p.stage_bytes % 16 == 0 &&
         smem_bytes >= kBarrierBytes + p.stages * p.stage_bytes;
}

}  // namespace

extern "C" {

// out (n,) = where(mask > 0, act(x w), 0) on `stream`, with n >= 1; mask is
// f32 (mask_bytes 4) or bool (1). body, rows, tiles, stages, lanes, grid and
// the stage size are glm_predict_plan's. Returns cudaGetLastError() after
// the launch (0 when it was accepted), or cudaErrorInvalidValue for a plan
// the kernel cannot run.
int glm_predict(const void* x, const void* w, const void* mask, void* out, int n, int d,
                int act, int mask_bytes, int body, int rows, int tiles, int stages, int lanes,
                int grid, int stage_bytes, int smem_bytes, void* stream) {
  Plan p;
  p.n = n;
  p.d = d;
  p.act = act;
  p.mask_bytes = mask_bytes;
  p.rows = rows;
  p.tiles = tiles;
  p.stages = stages;
  p.lanes = lanes;
  p.stage_bytes = stage_bytes;
  if (!valid(p, body, grid, smem_bytes)) return (int)cudaErrorInvalidValue;
  auto kern = body == kStagedFew    ? glm_predict_kernel<kStagedFew>
              : body == kStagedMany ? glm_predict_kernel<kStagedMany>
                                    : glm_predict_kernel<kWide>;
  if (body == kWide) smem_bytes = 0;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      p, (const float*)x, (const float*)w, mask, (float*)out);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
