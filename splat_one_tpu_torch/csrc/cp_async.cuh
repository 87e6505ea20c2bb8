// 16-byte asynchronous copies from global into shared memory (cp.async,
// sm_80 and later), shared by the compositing kernels that stage a chunk
// of slot rows while they walk the previous one.

#pragma once

#include <cuda_runtime.h>

namespace cp_async {

// Copy 16 bytes, global -> shared (cached in L2 only).
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until every copy this thread issued has landed: the thread then
// reads its own copies; a barrier after it makes the block's copies
// visible to all its threads.
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The same for every group but the N most recently committed.
template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace cp_async
