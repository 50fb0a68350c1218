// Tuna's micro-benchmark probe over two page pools (Hopper).
//
// Replaces the TPU kernel repro/kernels/strided_probe.py::strided_probe (body
// _probe_kernel; pallas_call at strided_probe.py:73). Over the nf fast-pool
// pages fast_idx[0..nf) and the ns slow-pool pages slow_idx[0..ns) (page p of
// the list is fast_idx[p] for p < nf, else slow_idx[p - nf]), every element x
// of a page runs ai_iters steps of acc = fmaf(acc, 1.000001f, x) from acc = 0
// (one fused multiply-add a step, as the TPU kernel is FMA-shaped on purpose),
// and the per-element results are summed over the pages into a
// (1, page_elems) float32 checksum.
//
// The slow pool may be pinned host memory read in place through unified
// virtual addressing (the wrapper passes the pointer the device sees): the
// paper's micro-benchmark (section 3.2) on this card's two real tiers, HBM
// and host memory over PCIe.
//
// Bound: bytes or operations, by ai_iters. It reads (nf + ns) * page_elems
// floats once and does ai_iters FMAs on each: the larger of the bytes over
// the reading tier's rate (3.35 TB/s HBM, 64 GB/s PCIe Gen5 x16) and the FMAs
// over the scalar float32 rate (67 TFLOP/s, 33.5 T FMA/s). At 2 x 0.5 GiB of
// 4 KiB pages, half in each tier, ai_iters 64: 8.39 ms, PCIe's half. On an
// H100 80GB HBM3 the SMs read pinned host memory at 25-30 GB/s whatever the
// shape of the reads (TMA or loads, in page order or at random), where the
// copy engines reach 47-53 GB/s (PERF.md, section 6).
//
// Design: a persistent grid of a few blocks an SM (BLOCKS_PER_SM of
// kernels/strided_probe.py) walks the page list by stride: block b of G
// takes pages b, b + G, b + 2G, ..., so every SM issues host reads in every
// mix of tiers. Pages wider than a stage are cut into stages of kChunk
// floats, and blockIdx.y picks the chunk. One producer warp puts each page
// (chunk) into a ring of kStages shared-memory stages with one
// cp.async.bulk (TMA; it accepts mapped host memory), completed on the
// stage's "full" mbarrier; it reads the page ids 32 at a time, one a lane,
// so no id load sits between two copies. kConsumers threads own one float4
// of columns each: they take two stages at once, run 8 independent FMA
// chains (two pages x four columns), free both stages on their "empty"
// mbarriers and add the two results, in page order, into column sums held in
// registers. Each block writes one partial row, and combine_kernel adds the
// partial rows in block order: no atomics, so the result is deterministic,
// with a chain of ceil(n / G) + G additions a column.
//
// TMA needs 16-byte-aligned addresses and sizes. Where a pool base, a page
// stride or the page size is not a multiple of 16 bytes, the same kernel takes
// its plain-load branch (kBulk = false): the consumers load their columns
// themselves, as floats, with the same page order and arithmetic.
#include <cuda_runtime.h>
#include <stdint.h>

#include "host_memory.cuh"

namespace {

constexpr int kConsumers = 256;            // one float4 of columns each
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kChunk = 4 * kConsumers;     // floats a stage (4 KiB)
constexpr int kStages = 16;                // pages in flight a block
constexpr int kRingBytes = kStages * kChunk * 4;
constexpr float kC = 1.000001f;

struct Probe {
  const float* fast;
  const float* slow;
  const int64_t* fast_idx;
  const int64_t* slow_idx;
  int64_t nf, n, page_elems, fast_ld, slow_ld;
  int ai_iters;
};

__device__ __forceinline__ const float* chunk_src(const Probe& q, int64_t p,
                                                  int64_t col0) {
  return (p < q.nf ? q.fast + q.fast_idx[p] * q.fast_ld
                   : q.slow + q.slow_idx[p - q.nf] * q.slow_ld) +
         col0;
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

__device__ __forceinline__ void arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// ai_iters FMA steps on one page's four columns (4 chains), added into sum
__device__ __forceinline__ void one_page(float4 x, int ai, float4& sum) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int k = 0; k < ai; ++k) {
    a.x = fmaf(a.x, kC, x.x);
    a.y = fmaf(a.y, kC, x.y);
    a.z = fmaf(a.z, kC, x.z);
    a.w = fmaf(a.w, kC, x.w);
  }
  sum.x += a.x;
  sum.y += a.y;
  sum.z += a.z;
  sum.w += a.w;
}

// the same on two pages at once (8 chains); page x0's result is added first
__device__ __forceinline__ void two_pages(float4 x0, float4 x1, int ai,
                                          float4& sum) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 b = a;
#pragma unroll 4
  for (int k = 0; k < ai; ++k) {
    a.x = fmaf(a.x, kC, x0.x);
    a.y = fmaf(a.y, kC, x0.y);
    a.z = fmaf(a.z, kC, x0.z);
    a.w = fmaf(a.w, kC, x0.w);
    b.x = fmaf(b.x, kC, x1.x);
    b.y = fmaf(b.y, kC, x1.y);
    b.z = fmaf(b.z, kC, x1.z);
    b.w = fmaf(b.w, kC, x1.w);
  }
  sum.x = (sum.x + a.x) + b.x;
  sum.y = (sum.y + a.y) + b.y;
  sum.z = (sum.z + a.z) + b.z;
  sum.w = (sum.w + a.w) + b.w;
}

// columns 4t .. 4t + 3 of a chunk `width` floats wide, zeros past its end
__device__ __forceinline__ float4 load_plain(const float* src, int t,
                                             int64_t width) {
  const int64_t c = 4 * static_cast<int64_t>(t);
  return make_float4(c < width ? src[c] : 0.f, c + 1 < width ? src[c + 1] : 0.f,
                     c + 2 < width ? src[c + 2] : 0.f,
                     c + 3 < width ? src[c + 3] : 0.f);
}

template <bool kBulk>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const __grid_constant__ Probe q, float* __restrict__ out) {
  extern __shared__ __align__(128) float4 ring[];  // [kStages][kConsumers]
  __shared__ __align__(8) unsigned long long full[kStages];
  __shared__ __align__(8) unsigned long long empty[kStages];
  const int t = threadIdx.x;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * kChunk;
  const int64_t width = min(static_cast<int64_t>(kChunk), q.page_elems - col0);
  const int64_t grid = gridDim.x;
  const int64_t mine = (q.n - blockIdx.x + grid - 1) / grid;  // pages here

  if constexpr (kBulk) {
    if (t == 0) {
      for (int s = 0; s < kStages; ++s) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                         smem(&full[s]))
                     : "memory");
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                         smem(&empty[s])),
                     "r"(kConsumers)
                     : "memory");
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    __syncthreads();
    if (t >= kConsumers) {  // the producer warp
      const int lane = t - kConsumers;
      const uint32_t bytes = static_cast<uint32_t>(width * 4);
      for (int64_t k0 = 0; k0 < mine; k0 += 32) {
        const int64_t k = k0 + lane;
        const unsigned long long src =
            k < mine ? reinterpret_cast<unsigned long long>(
                           chunk_src(q, blockIdx.x + k * grid, col0))
                     : 0ull;
        const int cnt = static_cast<int>(min(static_cast<int64_t>(32), mine - k0));
        for (int j = 0; j < cnt; ++j) {
          const unsigned long long a = __shfl_sync(0xffffffffu, src, j);
          if (lane == 0) {
            const int64_t kk = k0 + j;
            const int s = static_cast<int>(kk % kStages);
            if (kk >= kStages) {  // the consumers freed the stage's last page
              wait_parity(smem(&empty[s]),
                          static_cast<uint32_t>((kk / kStages + 1) & 1));
            }
            asm volatile(
                "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                    smem(&full[s])),
                "r"(bytes)
                : "memory");
            asm volatile(
                "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
                "bytes [%0], [%1], %2, [%3];" ::"r"(smem(ring + s * kConsumers)),
                "l"(a), "r"(bytes), "r"(smem(&full[s]))
                : "memory");
          }
        }
      }
      return;
    }
  } else {
    if (t >= kConsumers) return;
  }

  const bool has = 4 * static_cast<int64_t>(t) < width;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 sum = zero;
  for (int64_t k = 0; k < mine; k += 2) {
    const bool pair = k + 1 < mine;
    float4 x0, x1 = zero;
    if constexpr (kBulk) {
      const int s0 = static_cast<int>(k % kStages);
      const int s1 = static_cast<int>((k + 1) % kStages);
      const uint32_t par = static_cast<uint32_t>((k / kStages) & 1);
      wait_parity(smem(&full[s0]), par);
      x0 = has ? ring[s0 * kConsumers + t] : zero;
      arrive(smem(&empty[s0]));
      if (pair) {  // kStages is even, so k + 1 is in the same lap as k
        wait_parity(smem(&full[s1]), par);
        x1 = has ? ring[s1 * kConsumers + t] : zero;
        arrive(smem(&empty[s1]));
      }
    } else {
      x0 = load_plain(chunk_src(q, blockIdx.x + k * grid, col0), t, width);
      if (pair) {
        x1 = load_plain(chunk_src(q, blockIdx.x + (k + 1) * grid, col0), t,
                        width);
      }
    }
    if (pair) {
      two_pages(x0, x1, q.ai_iters, sum);
    } else {
      one_page(x0, q.ai_iters, sum);
    }
  }
  float* row = out + static_cast<int64_t>(blockIdx.x) * q.page_elems + col0;
  const int64_t c = 4 * static_cast<int64_t>(t);
  if (c < width) row[c] = sum.x;
  if (c + 1 < width) row[c + 1] = sum.y;
  if (c + 2 < width) row[c + 2] = sum.z;
  if (c + 3 < width) row[c + 3] = sum.w;
}

// out[c] = sum over b of partial[b][c], in block order; the rows are loaded
// 16 at a time so that their loads overlap
__global__ void __launch_bounds__(256)
combine_kernel(const float* __restrict__ partial, int64_t n_rows,
               int64_t page_elems, float* __restrict__ out) {
  constexpr int kAhead = 16;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (col >= page_elems) return;
  float sum = 0.0f;
  int64_t b = 0;
  for (; b + kAhead <= n_rows; b += kAhead) {
    float x[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) x[i] = partial[(b + i) * page_elems + col];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) sum += x[i];
  }
  for (; b < n_rows; ++b) sum += partial[b * page_elems + col];
  out[col] = sum;
}

bool aligned16(long long x) { return (x & 15) == 0; }

}  // namespace

// fast and slow are float32 pools the device can dereference (the slow one
// may be the device address of pinned host memory), row i of a pool at
// base + i * ld elements; fast_idx (nf) and slow_idx (ns) are device pointers
// to int64 page ids, nf + ns > 0. `grid` blocks (1 <= grid <= nf + ns) walk
// the pages by stride; when grid > 1, partial is device scratch of grid *
// page_elems floats. bulk = 1 reads pages by TMA and needs both bases 16-byte
// aligned and both strides and page_elems multiples of 4 elements; bulk = 0
// takes the plain-load branch. out receives the page_elems checksum. Launches
// on `stream` and returns cudaGetLastError() as an int (0 = launched).
extern "C" int strided_probe_launch(const void* fast, const void* slow,
                                    const void* fast_idx, const void* slow_idx,
                                    long long nf, long long ns,
                                    long long page_elems, long long fast_ld,
                                    long long slow_ld, int ai_iters,
                                    long long grid, int bulk, void* partial,
                                    void* out, void* stream) {
  const long long n = nf + ns;
  const long long chunks = (page_elems + kChunk - 1) / kChunk;
  if (n <= 0 || page_elems <= 0 || grid < 1 || grid > n ||
      grid > 0x7fffffffLL || chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bulk && !(aligned16(reinterpret_cast<long long>(fast)) &&
                aligned16(reinterpret_cast<long long>(slow)) &&
                aligned16(4 * fast_ld) && aligned16(4 * slow_ld) &&
                aligned16(4 * page_elems))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Probe q;
  q.fast = static_cast<const float*>(fast);
  q.slow = static_cast<const float*>(slow);
  q.fast_idx = static_cast<const int64_t*>(fast_idx);
  q.slow_idx = static_cast<const int64_t*>(slow_idx);
  q.nf = nf;
  q.n = n;
  q.page_elems = page_elems;
  q.fast_ld = fast_ld;
  q.slow_ld = slow_ld;
  q.ai_iters = ai_iters;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* first = static_cast<float*>(grid == 1 ? out : partial);
  const dim3 blocks(static_cast<unsigned>(grid), static_cast<unsigned>(chunks));
  if (bulk) {
    const cudaError_t err = cudaFuncSetAttribute(
        probe_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kRingBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    probe_kernel<true><<<blocks, kThreads, kRingBytes, st>>>(q, first);
  } else {
    probe_kernel<false><<<blocks, kThreads, 0, st>>>(q, first);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || grid == 1) return static_cast<int>(err);
  combine_kernel<<<static_cast<unsigned>((page_elems + 255) / 256), 256, 0,
                   st>>>(static_cast<const float*>(partial), grid, page_elems,
                         static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The device address of pinned host memory `ptr` (0 when it is not), for the
// wrapper's check of a host pool (see host_memory.cuh).
extern "C" unsigned long long strided_probe_host_device_ptr(const void* ptr) {
  return host_device_ptr(ptr);
}
