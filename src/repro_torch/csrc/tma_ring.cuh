// Copies into a ring of shared-memory stages for Hopper (sm_90a), shared by
// the kernels that stream rows of an f32 array through one: glm_grad.cu (B2)
// and glm_predict.cu (B4).
//
// A producer thread copies a span of 4-byte words, which may start anywhere
// on the 4-byte grid, into a stage: the 16-byte-aligned body by the TMA's
// bulk copy (cp.async.bulk, completion reported to an mbarrier as bytes), the
// up to 3 words before it and the up to 3 after it by cp.async, whose
// completion the thread reports to the same mbarrier with one arrival
// (cp_async_arrive). The span lands in the stage at its source's alignment,
// misalign(src) words into its area, so the area needs 3 words of slack.
// Each stage has a full and an empty mbarrier; mbar_wait spins on a phase's
// parity.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// An arrival on the barrier once the thread's cp.async copies issued so far
// have landed (without incrementing the pending count first).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// An arrival that also expects `bytes` more of bulk copies in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// The TMA's bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned),
// reported to the barrier as completed bytes.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// After the thread's mbar_init calls: the barriers visible to the TMA (the
// async proxy). The block synchronises before any thread uses them.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Words past the last 16-byte boundary at or before `p`: a span lands in
// shared memory that many words into its area, at its source's alignment.
__device__ __forceinline__ int misalign(const float* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// A span of `count` words: up to 3 head words to the first 16-byte boundary,
// `body` 16-byte units, then up to 3 tail words.
struct Span {
  float* dst;
  const float* src;
  int head, body, count;
};

__device__ __forceinline__ Span span_of(float* area, const float* src, int count) {
  Span sp;
  sp.src = src;
  sp.dst = area + misalign(src);
  sp.count = count;
  sp.head = min(count, (4 - misalign(src)) & 3);
  sp.body = (count - sp.head) >> 2;
  return sp;
}

__device__ __forceinline__ void copy_span(const Span& sp, uint64_t* bar) {
  if (sp.body) bulk_copy(sp.dst + sp.head, sp.src + sp.head, 16u * sp.body, bar);
  for (int i = 0; i < sp.head; ++i) cp_async4(sp.dst + i, sp.src + i);
  for (int i = sp.head + 4 * sp.body; i < sp.count; ++i) cp_async4(sp.dst + i, sp.src + i);
}

}  // namespace
