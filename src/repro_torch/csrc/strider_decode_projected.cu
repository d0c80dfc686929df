// Projected Strider page decode for Hopper (sm_90a): the pushdown decode of
// a scoring query, which reads only the columns the query needs.
//
// Replaces the TPU kernel repro/kernels/strider/strider.py::
// _strider_kernel_projected (launched by strider_decode(plan=...) through
// pl.pallas_call). Same contract: pages (P, page_words) u32 -> feats
// (P, T, C) f32 in the plan's column order, labels (P, T) f32 (zeros when the
// plan drops the label), mask (P, T) f32. The slot walk is B1's
// (strider_decode.cu): n_tuples is header word 4, slot i lives at word
// (data_end - (i+1)*stride)/4, slots at or past n_tuples are zero with mask 0.
//
// The plan reaches the kernel as a table `src` of C int32 source positions,
// one per output column: the payload word for f32 pages, the payload byte for
// int8 pages. The TPU kernel instead concatenates static slices of the plan's
// word runs; here each output element gathers its own word, so dropped
// columns are never read and any plan takes the same compiled kernel.
//
// Bound: bytes. Each output word is one gathered payload word, or one int8
// byte dequantised by one multiply: the plan's bytes per live tuple read once
// plus the outputs written once, over the card's 3.35 TB/s.
//
// Design: B1's grid of (page, tile of slots), nothing staged in shared
// memory (pages reach 512 KB). Consecutive threads write consecutive output
// words, so stores coalesce; loads coalesce along each run of the plan. f32
// words and the label are copied as 32-bit integers and dead slots are zeroed
// by a select, never by float arithmetic, so int32 tokens stored as f32
// denormals survive. int8 columns are (byte - 128) * scale with __fmul_rn,
// the reference's single rounding; scale is the f32 at word data_end/4.
// A plan with no columns (label only) writes labels and mask alone.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTupleHeaderWords = 2;  // t_len, row id
constexpr int kNTuplesWord = 4;       // page header word holding n_tuples

__global__ void __launch_bounds__(kThreads) strider_projected_kernel(
    const uint32_t* __restrict__ pages, const int* __restrict__ src,
    uint32_t* __restrict__ feats, uint32_t* __restrict__ labels,
    float* __restrict__ mask, int page_words, int tuples_per_page,
    int n_cols, int stride_w, int payload_w, int region_start_w, int scale_w,
    int quantized, int include_label, int slots_per_block) {
  const int page = blockIdx.x;
  const int slot0 = blockIdx.y * slots_per_block;
  const int n_slots = min(slots_per_block, tuples_per_page - slot0);
  const uint32_t* pg = pages + (size_t)page * page_words;
  const uint32_t n_tuples = __ldg(pg + kNTuplesWord);
  // slot s starts at region + (T - 1 - s) * stride_w (downward packing)
  const uint32_t* region = pg + region_start_w;
  const size_t row0 = (size_t)page * tuples_per_page + slot0;
  const int n_out = n_slots * n_cols;

  if (quantized) {
    const float scale = __uint_as_float(__ldg(pg + scale_w));
    float* out = reinterpret_cast<float*>(feats) + row0 * n_cols;
    for (int j = threadIdx.x; j < n_out; j += kThreads) {
      const int s = j / n_cols;
      const int slot = slot0 + s;
      float v = 0.0f;
      if ((uint32_t)slot < n_tuples) {
        const int b = __ldg(src + (j - s * n_cols));  // payload byte
        const uint32_t* tup =
            region + (size_t)(tuples_per_page - 1 - slot) * stride_w;
        const uint32_t word = __ldg(tup + kTupleHeaderWords + (b >> 2));
        const int raw = (int)((word >> ((b & 3) * 8)) & 0xFFu);
        v = __fmul_rn((float)(raw - 128), scale);
      }
      out[j] = v;
    }
  } else {
    uint32_t* out = feats + row0 * n_cols;
    for (int j = threadIdx.x; j < n_out; j += kThreads) {
      const int s = j / n_cols;
      const int slot = slot0 + s;
      uint32_t v = 0u;
      if ((uint32_t)slot < n_tuples) {
        const int w = __ldg(src + (j - s * n_cols));  // payload word
        const uint32_t* tup =
            region + (size_t)(tuples_per_page - 1 - slot) * stride_w;
        v = __ldg(tup + kTupleHeaderWords + w);
      }
      out[j] = v;
    }
  }

  for (int s = threadIdx.x; s < n_slots; s += kThreads) {
    const int slot = slot0 + s;
    const bool live = (uint32_t)slot < n_tuples;
    uint32_t label = 0u;
    if (live && include_label) {
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

// Decode n_pages pages through the plan `src` (n_cols positions) on
// `stream`. Returns cudaGetLastError() after the launch (0 when accepted).
int strider_decode_projected(const void* pages, const void* src, void* feats,
                             void* labels, void* mask, int n_pages,
                             int page_words, int tuples_per_page, int n_cols,
                             int stride_w, int payload_w, int region_start_w,
                             int scale_w, int quantized, int include_label,
                             int slots_per_block, void* stream) {
  const dim3 grid(n_pages,
                  (tuples_per_page + slots_per_block - 1) / slots_per_block);
  strider_projected_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)pages, (const int*)src, (uint32_t*)feats,
      (uint32_t*)labels, (float*)mask, page_words, tuples_per_page, n_cols,
      stride_w, payload_w, region_start_w, scale_w, quantized, include_label,
      slots_per_block);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
