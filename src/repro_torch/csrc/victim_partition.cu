// Per-size victim selection over the shared demotion ranking (Hopper).
//
// Replaces the TPU kernel repro/kernels/demote_rank.py::_victim_partition_pallas
// (body _victim_partition_kernel; pallas_call at demote_rank.py:71). For each
// size row s it marks the entries with fast01 > 0 whose inclusive running
// count of fast01 is <= demand[s]: the first demand[s] fast-tier pages of the
// interval's demotion ranking, which the sweep step demotes. fast01 holds 0
// or 1 (any value >= 0 keeps every count below a lower bound of the truth).
//
// Bound: bytes. The mask is written whole as int32 (4 bytes an element); the
// input is read only up to the element where a row's running count reaches
// its demand. At the main path's [20, 3,250,585] that is 0.26 GB written and
// up to 0.26 GB read, 0.08-0.16 ms at the H100's 3.35 TB/s. The scan does a
// few integer operations an element, far below the card's ALU rate.
//
// Design: a single-pass scan with the rows split across blocks (Merrill and
// Garland's decoupled look-back). A row is cut into tiles of kTile = 8,192
// elements, one 512-thread block a tile: 7,940 blocks at the main path's
// shape. A block takes its tile from an atomicAdd counter, not from
// blockIdx, so every tile it waits on has already started (blocks are
// scheduled in no order); tiles of all rows interleave (tile t of row r is
// number t * n_rows + r), so the rows advance together. Each (row, tile) has
// one 64-bit status word: flag (0 none, 1 the tile's own count, 2 the
// inclusive count of the row through the tile) above the count, published
// by one release store and read by acquire loads. A block reads its tile
// (four 16-byte loads a thread), scans it (thread, warp shuffles, shared
// memory), publishes its count, and then warp 0 walks back over the
// predecessors' words 32 at a time, adding counts up to the nearest
// inclusive one; the block publishes its inclusive count and writes the
// mask. Only "has the count reached demand[s]?" matters past the demand, so
// a published count may be a lower bound once it is >= the demand, and a
// per-row flag records that some tile's inclusive count reached it: a tile
// that starts after that (or whose demand is <= 0) writes zeros without
// reading its input and publishes the demand as its inclusive count. Read
// first keeps every block's loads in flight while it waits on its
// predecessors; looking back first would chain the tiles of a row one after
// another (PERF.md, section 6, has both measured).
//
// Scratch (zeroed by the wrapper on every call; the kernel allocates
// nothing): one 64-bit word for the tile counter, n_rows * tiles_per_row
// status words, then n_rows 32-bit flags.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                  // int4 loads a thread
constexpr int kSeg = kThreads * 4;       // elements one round of loads covers
constexpr int kTile = kSeg * kVec;       // 8,192 elements a tile

constexpr unsigned long long kOwn = 1ull << 32;        // the tile's count
constexpr unsigned long long kInclusive = 2ull << 32;  // the row's count through it

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Warp 0: the running count of the row before `tile`, from the status words
// of its predecessors, 32 at a time. A window is summed up to its nearest
// inclusive word once no word up to that one is still unpublished.
__device__ __forceinline__ int32_t look_back(const unsigned long long* status,
                                             int tile, int lane) {
  int32_t before = 0;
  for (long long pos = tile - 1;; pos -= 32) {
    const long long q = pos - lane;
    unsigned long long w;
    unsigned inclusive, window;
    while (true) {
      w = q >= 0 ? ld_acquire(status + q) : kInclusive;  // row start: 0
      const unsigned flag = static_cast<unsigned>(w >> 32);
      inclusive = __ballot_sync(0xffffffffu, flag == 2u);
      const unsigned missing = __ballot_sync(0xffffffffu, flag == 0u);
      const int last = inclusive ? __ffs(inclusive) - 1 : 31;
      window = last == 31 ? 0xffffffffu : (2u << last) - 1u;
      if (!(missing & window)) break;
    }
    int32_t c = ((window >> lane) & 1u)
                    ? static_cast<int32_t>(static_cast<uint32_t>(w))
                    : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      c += __shfl_xor_sync(0xffffffffu, c, off);
    before += c;
    if (inclusive) return before;
  }
}

// Thread t holds elements u * kSeg + 4 t + c (u < kVec, c < 4) of the tile:
// each round of loads covers kSeg consecutive elements.
__device__ __forceinline__ void load_tile(const int32_t* f, long long c0,
                                          long long n, bool vec,
                                          int32_t v[kVec][4]) {
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const long long i = c0 + u * kSeg + threadIdx.x * 4;
    if (vec && i + 4 <= n) {
      const int4 q = *reinterpret_cast<const int4*>(f + i);
      v[u][0] = q.x;
      v[u][1] = q.y;
      v[u][2] = q.z;
      v[u][3] = q.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) v[u][c] = (i + c < n) ? f[i + c] : 0;
    }
  }
}

__device__ __forceinline__ void store_tile(int32_t* o, long long c0,
                                           long long n, bool vec,
                                           const int32_t r[kVec][4]) {
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const long long i = c0 + u * kSeg + threadIdx.x * 4;
    if (vec && i + 4 <= n) {
      *reinterpret_cast<int4*>(o + i) =
          make_int4(r[u][0], r[u][1], r[u][2], r[u][3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (i + c < n) o[i + c] = r[u][c];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
victim_partition_kernel(const int32_t* __restrict__ fast01,
                        const int32_t* __restrict__ demand,
                        int32_t* __restrict__ out,
                        unsigned long long* __restrict__ scratch,
                        long long n_cols, long long ld_in, long long ld_out,
                        int n_rows, int tiles_per_row, int vec_in,
                        int vec_out) {
  __shared__ int s_row, s_tile, s_skip;
  __shared__ int32_t s_demand, s_before;
  __shared__ int32_t seg[kVec][kWarps];  // scans of the warp totals
  unsigned long long* status = scratch + 1;
  unsigned* reached = reinterpret_cast<unsigned*>(
      status + static_cast<long long>(n_rows) * tiles_per_row);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    const unsigned id = atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u);
    const int row = static_cast<int>(id % static_cast<unsigned>(n_rows));
    s_row = row;
    s_tile = static_cast<int>(id / static_cast<unsigned>(n_rows));
    s_demand = demand[row];
    s_skip = s_demand <= 0 || ld_relaxed(reached + row) != 0u;
  }
  __syncthreads();
  const int row = s_row;
  const int tile = s_tile;
  const int32_t d = s_demand;
  const int32_t* f = fast01 + row * ld_in;
  int32_t* o = out + row * ld_out;
  unsigned long long* row_status =
      status + static_cast<long long>(row) * tiles_per_row;
  const long long c0 = static_cast<long long>(tile) * kTile;
  int32_t r[kVec][4];
  if (s_skip) {
    // the count before this tile is >= the demand: zeros, unread
#pragma unroll
    for (int u = 0; u < kVec; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) r[u][c] = 0;
    store_tile(o, c0, n_cols, vec_out, r);
    if (threadIdx.x == 0)
      st_release(row_status + tile,
                 kInclusive | static_cast<uint32_t>(d > 0 ? d : 0));
    return;
  }
  int32_t v[kVec][4];
  load_tile(f, c0, n_cols, vec_in, v);
  int32_t s[kVec][4], x[kVec];  // inclusive scans: the thread's, the warp's
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    s[u][0] = v[u][0];
#pragma unroll
    for (int c = 1; c < 4; ++c) s[u][c] = s[u][c - 1] + v[u][c];
    x[u] = s[u][3];
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int32_t y = __shfl_up_sync(0xffffffffu, x[u], off);
      if (lane >= off) x[u] += y;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int u = 0; u < kVec; ++u) seg[u][warp] = x[u];
  }
  __syncthreads();
  if (warp < kVec) {  // warp u scans the warp totals of round u
    int32_t w = lane < kWarps ? seg[warp][lane] : 0;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < kWarps) seg[warp][lane] = w;
  }
  __syncthreads();
  int32_t count = 0;  // the tile's own count
#pragma unroll
  for (int u = 0; u < kVec; ++u) count += seg[u][kWarps - 1];
  if (warp == 0) {
    int32_t before = 0;
    if (tile == 0) {
      if (lane == 0)
        st_release(row_status, kInclusive | static_cast<uint32_t>(count));
    } else {
      if (lane == 0)
        st_release(row_status + tile, kOwn | static_cast<uint32_t>(count));
      before = look_back(row_status, tile, lane);
      if (lane == 0)
        st_release(row_status + tile,
                   kInclusive | static_cast<uint32_t>(before + count));
    }
    if (lane == 0) {
      s_before = before;
      if (before + count >= d) st_relaxed(reached + row, 1u);
    }
  }
  __syncthreads();
  int32_t before = s_before;
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const int32_t pre =
        before + (warp ? seg[u][warp - 1] : 0) + x[u] - s[u][3];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      r[u][c] = (v[u][c] > 0 && pre + s[u][c] <= d) ? 1 : 0;
    before += seg[u][kWarps - 1];
  }
  store_tile(o, c0, n_cols, vec_out, r);
}

}  // namespace

// The 64-bit words of scratch a launch over n_rows x n_cols needs; the
// wrapper hands the kernel that many, zeroed.
extern "C" long long victim_partition_scratch_words(long long n_rows,
                                                    long long n_cols) {
  const long long tiles_per_row = (n_cols + kTile - 1) / kTile;
  return 1 + n_rows * tiles_per_row + (n_rows + 1) / 2;
}

// fast01, demand, out and scratch are device pointers; row r of fast01
// starts at fast01 + r * ld_in (out: ld_out). vec_in / vec_out say whether
// the rows are 16-byte aligned for int4 access. `tile` must be kTile (the
// wrapper's TILE). Launches on `stream` and returns cudaGetLastError() as an
// int (0 = launched).
extern "C" int victim_partition_launch(const void* fast01, const void* demand,
                                       void* out, void* scratch,
                                       long long n_rows, long long n_cols,
                                       long long ld_in, long long ld_out,
                                       int vec_in, int vec_out, int tile,
                                       void* stream) {
  if (tile != kTile) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0 || n_cols <= 0) return static_cast<int>(cudaSuccess);
  const long long tiles_per_row = (n_cols + kTile - 1) / kTile;
  const long long blocks = n_rows * tiles_per_row;
  if (blocks > 0xffffffffll || tiles_per_row > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidValue);
  victim_partition_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(fast01), static_cast<const int32_t*>(demand),
      static_cast<int32_t*>(out), static_cast<unsigned long long*>(scratch),
      n_cols, ld_in, ld_out, static_cast<int>(n_rows),
      static_cast<int>(tiles_per_row), vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}
