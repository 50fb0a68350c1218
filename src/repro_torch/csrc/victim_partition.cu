// Per-size victim selection over the shared demotion ranking (Hopper).
//
// Replaces the TPU kernel repro/kernels/demote_rank.py::_victim_partition_pallas
// (body _victim_partition_kernel; pallas_call at demote_rank.py:71). For each
// size row s it marks the entries with fast01 > 0 whose inclusive running
// count of fast01 is <= demand[s]: the first demand[s] fast-tier pages of the
// interval's demotion ranking, which the sweep step demotes.
//
// Bound: bytes. Every element is read once as int32 and written once as
// int32, 8 bytes an element; at the main path's [20, 3,250,585] that is about
// 0.52 GB, about 0.16 ms at the H100's 3.35 TB/s. The scan does a few integer
// operations an element, far below the card's ALU rate.
//
// Design (the first, simple one): one block of 1024 threads per row walks the
// row in tiles of 4096 elements, four consecutive elements a thread, read and
// written as one int4 where the row is 16-byte aligned. A block-wide inclusive
// scan (serial over a thread's four, warp shuffles, shared memory for the 32
// warp totals) gives every element its running count; a carry holds the count
// of the tiles before. Once the carry reaches the demand no later element can
// be selected, so the rest of the row is written as zeros and never read.
// With one block per row, 20 rows keep 20 of the 132 SMs busy, so this runs
// far below the memory bound; splitting rows across blocks (decoupled
// look-back) is the next design.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;  // 32: one warp scans the warp totals
constexpr int kPerThread = 4;          // one int4
constexpr int kTile = kThreads * kPerThread;

__device__ __forceinline__ void store4(int32_t* o, int64_t i, int64_t n,
                                       bool vec, const int32_t r[kPerThread]) {
  if (vec && i + kPerThread <= n) {
    *reinterpret_cast<int4*>(o + i) = make_int4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (i + k < n) o[i + k] = r[k];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
victim_partition_kernel(const int32_t* __restrict__ fast01,
                        const int32_t* __restrict__ demand,
                        int32_t* __restrict__ out, int64_t n_cols,
                        int64_t ld_in, int64_t ld_out, int vec_in,
                        int vec_out) {
  __shared__ int32_t warp_sum[kWarps];
  const int64_t row = blockIdx.x;
  const int32_t* f = fast01 + row * ld_in;
  int32_t* o = out + row * ld_out;
  const int32_t d = demand[row];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int32_t zeros[kPerThread] = {0, 0, 0, 0};
  int32_t carry = 0;  // running count of the tiles before; block-uniform
  for (int64_t base = 0; base < n_cols; base += kTile) {
    const int64_t i0 = base + static_cast<int64_t>(threadIdx.x) * kPerThread;
    if (carry >= d) {
      // every later fast entry has a running count > d: zeros, unread
      for (int64_t i = i0; i < n_cols; i += kTile) {
        store4(o, i, n_cols, vec_out, zeros);
      }
      return;
    }
    int32_t v[kPerThread];
    if (vec_in && i0 + kPerThread <= n_cols) {
      const int4 q = *reinterpret_cast<const int4*>(f + i0);
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        v[k] = (i0 + k < n_cols) ? f[i0 + k] : 0;
      }
    }
    int32_t s[kPerThread];  // inclusive scan over the thread's elements
    s[0] = v[0];
#pragma unroll
    for (int k = 1; k < kPerThread; ++k) s[k] = s[k - 1] + v[k];
    int32_t x = s[kPerThread - 1];  // inclusive scan over the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {  // inclusive scan over the warp totals
      int32_t w = warp_sum[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += y;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    const int32_t before =
        carry + (warp == 0 ? 0 : warp_sum[warp - 1]) + x - s[kPerThread - 1];
    int32_t r[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      r[k] = (v[k] > 0 && before + s[k] <= d) ? 1 : 0;
    }
    store4(o, i0, n_cols, vec_out, r);
    carry += warp_sum[kWarps - 1];
    __syncthreads();  // the next tile rewrites warp_sum
  }
}

}  // namespace

// fast01, demand and out are device pointers to int32; row r of fast01
// starts at fast01 + r * ld_in (out: ld_out). vec_in / vec_out say whether
// the rows are 16-byte aligned for int4 access. Launches on `stream` and
// returns cudaGetLastError() as an int (0 = launched).
extern "C" int victim_partition_launch(const void* fast01, const void* demand,
                                       void* out, long long n_rows,
                                       long long n_cols, long long ld_in,
                                       long long ld_out, int vec_in,
                                       int vec_out, void* stream) {
  if (n_rows <= 0 || n_cols <= 0) return static_cast<int>(cudaSuccess);
  victim_partition_kernel<<<static_cast<unsigned int>(n_rows), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(fast01), static_cast<const int32_t*>(demand),
      static_cast<int32_t*>(out), n_cols, ld_in, ld_out, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}
