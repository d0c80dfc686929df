// Strider page decode for Hopper (sm_90a): database pages -> dense tuples.
//
// Replaces the TPU kernel repro/kernels/strider/strider.py::_strider_kernel
// (launched by strider_decode through pl.pallas_call). Same contract: pages
// (P, page_words) u32 -> feats (P, T, D) f32, labels (P, T) f32, mask (P, T)
// f32. n_tuples is header word 4; slot i lives at word
// (data_end - (i+1)*stride)/4, which is the TPU kernel's [::-1] over the
// tuple region; slots at or past n_tuples are zero and have mask 0.
//
// Bound: bytes. Each output word is one payload word copied, or one int8 byte
// dequantised by one multiply, so the card's 3.35 TB/s of device memory sets
// the least time: pages read once plus decoded tensors written once.
//
// Design: a grid of (page, tile of slots). No page is staged in shared memory
// (a 512 KB page is more than a block's 227 KB); each block reads its slots'
// payload words straight from device memory. Consecutive threads produce
// consecutive output words, so stores coalesce fully and loads coalesce along
// a slot's payload. f32 payload and label words are copied as 32-bit integers
// and dead slots are zeroed by a select, never by float arithmetic: token
// tables store int32 ids as f32 denormals, which a flushing float op would
// destroy. int8 features are (byte - 128) * scale with __fmul_rn, the same
// single rounding as the reference's (raw - 128).astype(f32) * scale.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTupleHeaderWords = 2;  // t_len, row id
constexpr int kNTuplesWord = 4;       // page header word holding n_tuples

__global__ void __launch_bounds__(kThreads) strider_decode_kernel(
    const uint32_t* __restrict__ pages, uint32_t* __restrict__ feats,
    uint32_t* __restrict__ labels, float* __restrict__ mask, int page_words,
    int tuples_per_page, int n_features, int stride_w, int payload_w,
    int region_start_w, int scale_w, int quantized, int slots_per_block) {
  const int page = blockIdx.x;
  const int slot0 = blockIdx.y * slots_per_block;
  const int n_slots = min(slots_per_block, tuples_per_page - slot0);
  const uint32_t* pg = pages + (size_t)page * page_words;
  const uint32_t n_tuples = __ldg(pg + kNTuplesWord);
  // slot s starts at region + (T - 1 - s) * stride_w (downward packing)
  const uint32_t* region = pg + region_start_w;
  const size_t row0 = (size_t)page * tuples_per_page + slot0;
  const int n_out = n_slots * n_features;

  if (quantized) {
    const float scale = __uint_as_float(__ldg(pg + scale_w));
    float* out = reinterpret_cast<float*>(feats) + row0 * n_features;
    for (int j = threadIdx.x; j < n_out; j += kThreads) {
      const int s = j / n_features;
      const int f = j - s * n_features;
      const int slot = slot0 + s;
      float v = 0.0f;
      if ((uint32_t)slot < n_tuples) {
        const uint32_t* tup =
            region + (size_t)(tuples_per_page - 1 - slot) * stride_w;
        const uint32_t word = __ldg(tup + kTupleHeaderWords + (f >> 2));
        const int raw = (int)((word >> ((f & 3) * 8)) & 0xFFu);
        v = __fmul_rn((float)(raw - 128), scale);
      }
      out[j] = v;
    }
  } else {
    uint32_t* out = feats + row0 * n_features;
    for (int j = threadIdx.x; j < n_out; j += kThreads) {
      const int s = j / n_features;
      const int f = j - s * n_features;
      const int slot = slot0 + s;
      uint32_t v = 0u;
      if ((uint32_t)slot < n_tuples) {
        const uint32_t* tup =
            region + (size_t)(tuples_per_page - 1 - slot) * stride_w;
        v = __ldg(tup + kTupleHeaderWords + f);
      }
      out[j] = v;
    }
  }

  for (int s = threadIdx.x; s < n_slots; s += kThreads) {
    const int slot = slot0 + s;
    const bool live = (uint32_t)slot < n_tuples;
    uint32_t label = 0u;
    if (live) {
      const uint32_t* tup =
          region + (size_t)(tuples_per_page - 1 - slot) * stride_w;
      label = __ldg(tup + kTupleHeaderWords + payload_w);
    }
    labels[row0 + s] = label;
    mask[row0 + s] = live ? 1.0f : 0.0f;
  }
}

}  // namespace

extern "C" {

// Decode n_pages pages on `stream`. Returns cudaGetLastError() after the
// launch (0 when the launch was accepted).
int strider_decode(const void* pages, void* feats, void* labels, void* mask,
                   int n_pages, int page_words, int tuples_per_page,
                   int n_features, int stride_w, int payload_w,
                   int region_start_w, int scale_w, int quantized,
                   int slots_per_block, void* stream) {
  const dim3 grid(n_pages,
                  (tuples_per_page + slots_per_block - 1) / slots_per_block);
  strider_decode_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)pages, (uint32_t*)feats, (uint32_t*)labels,
      (float*)mask, page_words, tuples_per_page, n_features, stride_w,
      payload_w, region_start_w, scale_w, quantized, slots_per_block);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
