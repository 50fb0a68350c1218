// Tuna's micro-benchmark probe over two page pools (Hopper).
//
// Replaces the TPU kernel repro/kernels/strided_probe.py::strided_probe (body
// _probe_kernel; pallas_call at strided_probe.py:73). Over the nf fast-pool
// pages fast_idx[0..nf) and then the ns slow-pool pages slow_idx[0..ns), in
// that order, every element x of a page runs ai_iters steps of
// acc = acc * 1.000001f + x from acc = 0 (one fused multiply-add a step, as the
// TPU kernel is FMA-shaped on purpose), and the per-element results are summed
// over the pages into a (1, page_elems) float32 checksum.
//
// The slow pool may be pinned host memory read in place through unified
// virtual addressing (the wrapper passes the pointer the device sees): the
// paper's micro-benchmark (section 3.2) on this card's two real tiers, HBM
// and host memory over PCIe.
//
// Bound: bytes or operations, by ai_iters. It reads (nf + ns) * page_elems
// floats once and does ai_iters FMAs on each: the larger of the bytes over
// the reading tier's rate (3.35 TB/s HBM, 64 GB/s PCIe Gen5 x16) and the FMAs
// over the scalar float32 rate (67 TFLOP/s, 33.5 T FMA/s).
//
// Design: thread c of the grid owns element column c of the page. The page
// list is cut into contiguous segments (grid.y), so that enough blocks are in
// flight to fill the card even for 4 KiB pages (1,024 columns); each thread
// walks its segment in page order, four pages at a time (four independent
// FMA chains for instruction-level parallelism, loads issued first), and
// keeps the running sum in a register. With one segment the thread writes the
// checksum; with several it writes a partial row, and a second kernel adds the
// partial rows in segment order. No atomics: the result is deterministic and
// its additions follow the page order, in segments.
#include <cuda_runtime.h>
#include <stdint.h>

#include "host_memory.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPages = 4;  // pages in flight per thread

__device__ __forceinline__ const float* page_row(
    const float* fast, const float* slow, const int64_t* fast_idx,
    const int64_t* slow_idx, int64_t nf, int64_t fast_ld, int64_t slow_ld,
    int64_t p) {
  return p < nf ? fast + fast_idx[p] * fast_ld
                : slow + slow_idx[p - nf] * slow_ld;
}

__global__ void __launch_bounds__(kThreads)
probe_kernel(const float* __restrict__ fast, const float* __restrict__ slow,
             const int64_t* __restrict__ fast_idx,
             const int64_t* __restrict__ slow_idx, int64_t nf, int64_t ns,
             int64_t page_elems, int64_t fast_ld, int64_t slow_ld,
             int ai_iters, int64_t pages_per_seg, float* __restrict__ out) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= page_elems) return;
  const int64_t p0 = static_cast<int64_t>(blockIdx.y) * pages_per_seg;
  const int64_t p1 = (p0 + pages_per_seg < nf + ns) ? p0 + pages_per_seg : nf + ns;
  float sum = 0.0f;
  int64_t p = p0;
  for (; p + kPages <= p1; p += kPages) {
    float x[kPages];
    float acc[kPages];
#pragma unroll
    for (int u = 0; u < kPages; ++u) {
      x[u] = page_row(fast, slow, fast_idx, slow_idx, nf, fast_ld, slow_ld,
                      p + u)[col];
      acc[u] = 0.0f;
    }
    for (int k = 0; k < ai_iters; ++k) {
#pragma unroll
      for (int u = 0; u < kPages; ++u) acc[u] = fmaf(acc[u], 1.000001f, x[u]);
    }
#pragma unroll
    for (int u = 0; u < kPages; ++u) sum += acc[u];
  }
  for (; p < p1; ++p) {
    const float x =
        page_row(fast, slow, fast_idx, slow_idx, nf, fast_ld, slow_ld, p)[col];
    float acc = 0.0f;
    for (int k = 0; k < ai_iters; ++k) acc = fmaf(acc, 1.000001f, x);
    sum += acc;
  }
  out[static_cast<int64_t>(blockIdx.y) * page_elems + col] = sum;
}

// out[c] = sum over s of partial[s][c], in segment order
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ partial, int64_t n_seg,
               int64_t page_elems, float* __restrict__ out) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= page_elems) return;
  float sum = 0.0f;
  for (int64_t s = 0; s < n_seg; ++s) sum += partial[s * page_elems + col];
  out[col] = sum;
}

}  // namespace

// fast and slow are float32 pools the device can dereference (the slow one
// may be the device address of pinned host memory), row i of a pool at
// base + i * ld elements; fast_idx (nf) and slow_idx (ns) are device pointers
// to int64 page ids, nf + ns > 0. The pages are cut into n_seg =
// ceil((nf + ns) / pages_per_seg) segments (n_seg <= 65535); when n_seg > 1,
// partial is device scratch of n_seg * page_elems floats. out receives the
// page_elems checksum. Launches on `stream` and returns cudaGetLastError() as
// an int (0 = launched).
extern "C" int strided_probe_launch(const void* fast, const void* slow,
                                    const void* fast_idx, const void* slow_idx,
                                    long long nf, long long ns,
                                    long long page_elems, long long fast_ld,
                                    long long slow_ld, int ai_iters,
                                    long long pages_per_seg, void* partial,
                                    void* out, void* stream) {
  const int64_t n = nf + ns;
  if (n <= 0 || page_elems <= 0 || pages_per_seg <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_seg = (n + pages_per_seg - 1) / pages_per_seg;
  if (n_seg > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned int col_blocks =
      static_cast<unsigned int>((page_elems + kThreads - 1) / kThreads);
  float* first = static_cast<float*>(n_seg == 1 ? out : partial);
  probe_kernel<<<dim3(col_blocks, static_cast<unsigned int>(n_seg)), kThreads,
                 0, st>>>(
      static_cast<const float*>(fast), static_cast<const float*>(slow),
      static_cast<const int64_t*>(fast_idx),
      static_cast<const int64_t*>(slow_idx), nf, ns, page_elems, fast_ld,
      slow_ld, ai_iters, pages_per_seg, first);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_seg == 1) return static_cast<int>(err);
  combine_kernel<<<col_blocks, kThreads, 0, st>>>(
      static_cast<const float*>(partial), n_seg, page_elems,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The device address of pinned host memory `ptr` (0 when it is not), for the
// wrapper's check of a host pool (see host_memory.cuh).
extern "C" unsigned long long strided_probe_host_device_ptr(const void* ptr) {
  return host_device_ptr(ptr);
}
