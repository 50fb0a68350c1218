// Batched page migration between page pools (Hopper).
//
// Replaces the TPU kernel repro/kernels/page_migrate.py::migrate_pages (body
// _migrate_kernel; pallas_call at page_migrate.py:44): for i < n it copies
// page src_idx[i] of the source pool onto page dst_idx[i] of the destination
// pool, in place. Pages not named in dst_idx are never touched, as with the
// TPU kernel's donated, aliased destination. The copy moves raw bytes, so any
// element type is exact.
//
// Either pool may be pinned host memory, read or written in place through
// unified virtual addressing (the wrapper passes the pointer the device sees):
// promotion copies the host pool into the HBM pool, demotion the reverse, with
// no staging copy. Precondition: dst_idx holds no repeated page (two blocks
// would write one page); the serving path only ever names distinct slots.
//
// Bound: bytes. Each copied page is read once and written once. Between two
// HBM pools that is 2 * n * page_bytes at 3.35 TB/s; when one side is host
// memory the PCIe link (64 GB/s per direction for Gen5 x16) bounds it at
// n * page_bytes / 64 GB/s.
//
// Design: grid.x runs over the n pages, grid.y over chunks of a page (a block
// of 256 threads copies kUnroll * 256 units a step, grid-striding over the
// page's chunks when there are more than grid.y). The unit is the widest of
// 16, 8, 4, 2 and 1 bytes that divides both base addresses, both page strides
// and the page size, so aligned pools move 16 bytes a thread a load; each
// thread issues all its loads before its stores, keeping kUnroll reads in
// flight, which matters for the microsecond-scale PCIe reads of host memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "host_memory.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
migrate_kernel(char* __restrict__ dst, const char* __restrict__ src,
               const int64_t* __restrict__ dst_idx,
               const int64_t* __restrict__ src_idx, int64_t units,
               int64_t dst_stride, int64_t src_stride) {
  const int64_t page = blockIdx.x;
  const T* s = reinterpret_cast<const T*>(src + src_idx[page] * src_stride);
  T* d = reinterpret_cast<T*>(dst + dst_idx[page] * dst_stride);
  const int64_t step = static_cast<int64_t>(kThreads) * kUnroll;
  for (int64_t base = static_cast<int64_t>(blockIdx.y) * step; base < units;
       base += static_cast<int64_t>(gridDim.y) * step) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * kThreads + threadIdx.x;
      if (i < units) v[u] = s[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * kThreads + threadIdx.x;
      if (i < units) d[i] = v[u];
    }
  }
}

template <typename T>
void launch(char* dst, const char* src, const int64_t* dst_idx,
            const int64_t* src_idx, long long n, long long page_bytes,
            long long dst_stride, long long src_stride, cudaStream_t stream) {
  const int64_t units = page_bytes / static_cast<int64_t>(sizeof(T));
  const int64_t step = static_cast<int64_t>(kThreads) * kUnroll;
  int64_t chunks = (units + step - 1) / step;
  if (chunks > 65535) chunks = 65535;  // grid.y limit; blocks then stride
  const dim3 grid(static_cast<unsigned int>(n),
                  static_cast<unsigned int>(chunks));
  migrate_kernel<T><<<grid, kThreads, 0, stream>>>(
      dst, src, dst_idx, src_idx, units, dst_stride, src_stride);
}

}  // namespace

// dst and src are pointers the device can dereference (device memory, or
// the device address of pinned host memory); dst_idx and src_idx are device
// pointers to n int64 page ids. Page i of a pool starts at base + i * stride
// bytes; page_bytes bytes are copied per page in units of `unit` bytes (16, 8,
// 4, 2 or 1; the caller checks alignment). n <= 2^31 - 1. Launches on `stream`
// and returns cudaGetLastError() as an int (0 = launched).
extern "C" int migrate_pages_launch(void* dst, const void* src,
                                    const void* dst_idx, const void* src_idx,
                                    long long n, long long page_bytes,
                                    long long dst_stride, long long src_stride,
                                    int unit, void* stream) {
  if (n <= 0 || page_bytes <= 0) return static_cast<int>(cudaSuccess);
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  const int64_t* di = static_cast<const int64_t*>(dst_idx);
  const int64_t* si = static_cast<const int64_t*>(src_idx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16: launch<uint4>(d, s, di, si, n, page_bytes, dst_stride, src_stride, st); break;
    case 8: launch<uint2>(d, s, di, si, n, page_bytes, dst_stride, src_stride, st); break;
    case 4: launch<uint32_t>(d, s, di, si, n, page_bytes, dst_stride, src_stride, st); break;
    case 2: launch<uint16_t>(d, s, di, si, n, page_bytes, dst_stride, src_stride, st); break;
    case 1: launch<uint8_t>(d, s, di, si, n, page_bytes, dst_stride, src_stride, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The device address of pinned host memory `ptr` (0 when it is not), for the
// wrapper's check of a host operand (see host_memory.cuh).
extern "C" unsigned long long page_migrate_host_device_ptr(const void* ptr) {
  return host_device_ptr(ptr);
}
