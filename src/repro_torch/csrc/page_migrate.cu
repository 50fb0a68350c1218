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
// n * page_bytes / 64 GB/s. On an H100 80GB HBM3 the SMs read pinned host
// memory at about 30 GB/s however the reads are shaped (16-byte loads, with
// or without an L2 prefetch hint, or TMA bulk copies), where the copy engines
// reach about 48 GB/s; writes to host memory reach about 52 GB/s either way
// (PERF.md, section 6).
//
// Design: a page is cut into chunks of kChunk bytes, and the (page, chunk)
// items are spread over a persistent grid of at most kBlocksPerSm blocks an
// SM, block b taking items b, b + grid, b + 2 grid, ...; a one-page batch
// (224 chunks of a Qwen3-1.7B KV page) thus spreads over the whole card.
// Where both pools, both page strides and the page size are 16-byte aligned,
// one thread of the block moves its items with TMA bulk copies: a ring of
// kStages chunk buffers in shared memory, each filled by cp.async.bulk
// (global or mapped host memory -> shared, completed on an mbarrier) and
// drained by a bulk store (shared -> global), kStages chunks in flight a
// block. Otherwise the block's threads copy each chunk with the widest access
// (8, 4, 2 or 1 bytes) that divides the addresses, strides and page size.
//
// Page ids come in a kernel parameter when the wrapper has them on the host
// (at most kInline pages, every batch of the serving path), so a launch
// needs no index copy; else from device arrays of int64.
#include <cuda_runtime.h>
#include <stdint.h>

#include "host_memory.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 8192;      // bytes an item
constexpr int kStages = 4;        // chunks in flight a block (32 KB shared)
constexpr int kBlocksPerSm = 6;
constexpr int kInline = 256;      // page ids a kernel parameter holds

struct PageIds {
  const int64_t* dst;  // device arrays, or null: the ids are in `inline_*`
  const int64_t* src;
  int32_t inline_dst[kInline];
  int32_t inline_src[kInline];
};

struct Plan {
  char* dst;
  const char* src;
  int64_t page_bytes, dst_stride, src_stride, chunks_per_page, items;
};

__device__ __forceinline__ void item_range(const Plan& p, const PageIds& ids,
                                           int64_t item, int64_t* from,
                                           int64_t* to, int64_t* bytes) {
  const int64_t i = item / p.chunks_per_page;
  const int64_t begin = (item % p.chunks_per_page) * kChunk;
  const int64_t s = ids.src ? ids.src[i] : ids.inline_src[i];
  const int64_t d = ids.dst ? ids.dst[i] : ids.inline_dst[i];
  *from = s * p.src_stride + begin;
  *to = d * p.dst_stride + begin;
  *bytes = min(static_cast<int64_t>(kChunk), p.page_bytes - begin);
}

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One thread moves the block's items through the shared-memory ring.
__device__ void copy_bulk(const Plan& p, const PageIds& ids) {
  __shared__ __align__(128) char ring[kStages][kChunk];
  __shared__ __align__(8) unsigned long long full[kStages];
  if (threadIdx.x != 0) return;
  for (int s = 0; s < kStages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem(&full[s]))
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  const int64_t mine = (p.items - blockIdx.x + gridDim.x - 1) / gridDim.x;
  auto load = [&](int64_t k) {  // the block's k-th item into stage k % kStages
    int64_t from, to, bytes;
    item_range(p, ids, blockIdx.x + k * gridDim.x, &from, &to, &bytes);
    const int s = static_cast<int>(k % kStages);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                     smem(&full[s])),
                 "r"(static_cast<uint32_t>(bytes))
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];" ::"r"(smem(ring[s])),
        "l"(p.src + from), "r"(static_cast<uint32_t>(bytes)),
        "r"(smem(&full[s]))
        : "memory");
  };
  for (int64_t k = 0; k < mine && k < kStages; ++k) load(k);
  for (int64_t k = 0; k < mine; ++k) {
    const int s = static_cast<int>(k % kStages);
    wait_parity(smem(&full[s]), static_cast<uint32_t>((k / kStages) & 1));
    int64_t from, to, bytes;
    item_range(p, ids, blockIdx.x + k * gridDim.x, &from, &to, &bytes);
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::
                     "l"(p.dst + to),
                 "r"(smem(ring[s])), "r"(static_cast<uint32_t>(bytes))
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    if (k + kStages < mine) {
      // the store just issued has read stage s before the stage is refilled
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      load(k + kStages);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// The block's threads copy its items in units of T.
template <typename T>
__device__ void copy_threads(const Plan& p, const PageIds& ids) {
  for (int64_t item = blockIdx.x; item < p.items; item += gridDim.x) {
    int64_t from, to, bytes;
    item_range(p, ids, item, &from, &to, &bytes);
    const T* s = reinterpret_cast<const T*>(p.src + from);
    T* d = reinterpret_cast<T*>(p.dst + to);
    const int64_t units = bytes / static_cast<int64_t>(sizeof(T));
    for (int64_t u = threadIdx.x; u < units; u += kThreads) d[u] = s[u];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
migrate_kernel(const __grid_constant__ Plan p,
               const __grid_constant__ PageIds ids) {
  if constexpr (sizeof(T) == 16) {
    copy_bulk(p, ids);
  } else {
    copy_threads<T>(p, ids);
  }
}

}  // namespace

// dst and src are pointers the device can dereference (device memory, or
// the device address of pinned host memory). Page ids: dst_idx and src_idx
// are device pointers to n int64 ids, or both null, and then host_dst and
// host_src are host pointers to n <= 256 int64 ids, passed to the kernel by
// value. Page i of a pool starts at base + i * stride bytes; page_bytes bytes
// are copied per page. `unit` (16, 8, 4, 2 or 1) is the widest access that
// divides both base addresses, both strides and the page size (the caller
// computes it); 16 takes the TMA path. Launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int migrate_pages_launch(void* dst, const void* src,
                                    const void* dst_idx, const void* src_idx,
                                    const long long* host_dst,
                                    const long long* host_src, long long n,
                                    long long page_bytes, long long dst_stride,
                                    long long src_stride, int unit,
                                    int sm_count, void* stream) {
  if (n <= 0 || page_bytes <= 0) return static_cast<int>(cudaSuccess);
  PageIds ids;
  ids.dst = static_cast<const int64_t*>(dst_idx);
  ids.src = static_cast<const int64_t*>(src_idx);
  if (ids.dst == nullptr || ids.src == nullptr) {
    if (host_dst == nullptr || host_src == nullptr || n > kInline)
      return static_cast<int>(cudaErrorInvalidValue);
    ids.dst = ids.src = nullptr;
    for (long long i = 0; i < n; ++i) {
      ids.inline_dst[i] = static_cast<int32_t>(host_dst[i]);
      ids.inline_src[i] = static_cast<int32_t>(host_src[i]);
    }
  }
  Plan p;
  p.dst = static_cast<char*>(dst);
  p.src = static_cast<const char*>(src);
  p.page_bytes = page_bytes;
  p.dst_stride = dst_stride;
  p.src_stride = src_stride;
  p.chunks_per_page = (page_bytes + kChunk - 1) / kChunk;
  p.items = n * p.chunks_per_page;
  const long long cap = static_cast<long long>(kBlocksPerSm) *
                        (sm_count > 0 ? sm_count : 1);
  const unsigned grid =
      static_cast<unsigned>(p.items < cap ? p.items : cap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16: migrate_kernel<uint4><<<grid, kThreads, 0, st>>>(p, ids); break;
    case 8: migrate_kernel<uint2><<<grid, kThreads, 0, st>>>(p, ids); break;
    case 4: migrate_kernel<uint32_t><<<grid, kThreads, 0, st>>>(p, ids); break;
    case 2: migrate_kernel<uint16_t><<<grid, kThreads, 0, st>>>(p, ids); break;
    case 1: migrate_kernel<uint8_t><<<grid, kThreads, 0, st>>>(p, ids); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The device address of pinned host memory `ptr` (0 when it is not), for the
// wrapper's check of a host operand (see host_memory.cuh).
extern "C" unsigned long long page_migrate_host_device_ptr(const void* ptr) {
  return host_device_ptr(ptr);
}
