// Host memory that a kernel reads or writes in place, through unified virtual
// addressing: page-locked (pinned) host memory, as PyTorch's pinned allocator
// hands it out (pin_memory=True), is mapped into the device's address space.
#pragma once
#include <cuda_runtime.h>

// The address the device dereferences for host pointer `ptr`, or 0 when `ptr`
// is not page-locked host memory mapped for the device (pageable memory,
// device memory, or an error). Wrappers refuse such operands: there is no
// staging fallback.
static inline unsigned long long host_device_ptr(const void* ptr) {
  cudaPointerAttributes attr;
  if (cudaPointerGetAttributes(&attr, ptr) != cudaSuccess) {
    cudaGetLastError();  // clear the error this query left behind
    return 0ull;
  }
  if (attr.type != cudaMemoryTypeHost || attr.devicePointer == nullptr) {
    return 0ull;
  }
  return reinterpret_cast<unsigned long long>(attr.devicePointer);
}
