// The backward of the RWKV6 (Finch) WKV recurrence on Hopper.
//
// Replaces jax.grad of repro/kernels/ref.py:91 (ref.wkv6): the JAX package
// has no backward kernel (jax.grad through its Pallas wkv6_chunked raises,
// and repro/kernels/ops.py then differentiates the reference). This is the
// gradient of that same function, for the forward of csrc/wkv6.cu. Per
// (batch, head), from a zero state, S_t = diag(w_t) S_{t-1} + k_t v_t^T and
// o_t = r_t (S_{t-1} + diag(u) k_t v_t^T). Given dO and the gradient of the
// final state (or none: zeros), with G_t the gradient of S_t (G of the last
// token is the final state's), walking the tokens backward:
//   dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
//   dk_t[i] = sum_j (G_t[i,j] + r_t[i] u[i] do_t[j]) v_t[j]
//   dv_t[j] = sum_i (G_t[i,j] + r_t[i] u[i] do_t[j]) k_t[i]
//   dr_t[i] = sum_j do_t[j] (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
//   du[i]   = sum over batch and t of r_t[i] k_t[i] (do_t . v_t)
//   G_{t-1} = diag(w_t) G_t + r_t do_t^T
//
// S_{t-1} is never recovered by dividing by w_t: the decays go to ~0. The
// kernel walks the tokens forward once, keeping the state at the start of
// every chunk of kChunk tokens (a checkpoint in device memory); then it
// walks the chunks backward, rebuilding each chunk's states S_{t-1} forward
// from its checkpoint (and dr with them) before walking the chunk backward
// with G. Every sum is float32 in a fixed order, with no floating-point
// atomics, so every run gives the same bits.
//
// Bound: operations. The function needs about 14 flops per (token, i, j):
// the state rebuilt (3), G (3), dw, dk, dv, dr (2 each, the bonus terms
// folded in), at the card's float32 rate outside the tensor cores: about
// 19 GFLOP a layer at RWKV6-3B's 4 x 2,048-token step (40 heads of 64),
// 0.28 ms at 67 TFLOP/s; the kernel also runs the recurrence once more for
// the checkpoints, and half a chunk once more (below). Every token is a
// dependent step of each state element's chain, so a block takes a long
// time however few share its SM, and the kernel's time is nearly the
// number of waves of blocks times a block's time: the design fits the
// training shape's grid (640 blocks: 4 x 40 heads, 4 slices each) into one
// wave, 6 blocks an SM on 132 SMs (at 5, the 160 clusters of 4 do not all
// fit at once), with 16 elements a thread for instruction-level
// parallelism.
//
// Design. One thread block cluster a (batch, head): hd / kSlice blocks, one
// a slice of kSlice = 16 state columns, so that the sums over j (dr, dk,
// dw) of a head are finished inside the cluster, through distributed
// shared memory, and never go through device memory. In a block, kGroups =
// 4 consecutive lanes share a group of kRows = 4 state rows (i, i + hd / 4,
// i + hd / 2, i + 3 hd / 4; 2 rows at hd 16, so that a block is a whole
// warp), each holding kCols = 4 of the slice's columns of each: hd threads
// (2 warps at hd 64), 16 elements a thread. A thread keeps kHold = 4
// states S_{t-1} of its elements in registers (64): it rebuilds the chunk's
// first half from the checkpoint without keeping them, rebuilds the second
// half keeping them (and its dr) and walks it backward with G; then it
// rebuilds the first half again from the checkpoint, keeping them (and its
// dr), and walks it backward. The checkpoints stay every kChunk = 8 tokens
// (671 MB written and read at the training shape; every 4 tokens measured
// slower at full occupancy, the traffic doubled). The rebuilds and walks
// are unrolled over the chunk, which is padded past S with no-op tokens so
// that it runs without a branch; 168 registers a thread.
// Per token, a row group's partial dr (rebuild) and dk, dw (backward) are
// finished over its 4 lanes by a reduce-scatter of __shfl_xor_sync (two
// steps, each lane ending with its own rows' sums) and stored straight into
// the shared memory of the block that owns the token (token tt of a chunk
// belongs to block tt % slices) by st.async, which counts the bytes on
// that block's mbarrier full[b]: the owner waits there, and no fence is
// needed (a cluster barrier's release costs a GPU-wide fence a chunk).
// dv's sum over i adds the thread's rows, then is a reduce-scatter over the
// warp's 8 row groups (three steps, four columns) into shared memory, added
// over the warps a chunk later. The bonus terms ride once a row or a
// column, not once an element (dr = sum_j dO_j S_{t-1} + u k (dO . v), dk =
// sum_j G v_j + r u (dO . v), dv adds dO_j sum_i r u k). At the end of a
// chunk a block waits for its full[b], adds up the chunk's row partials it
// owns, slice by slice in a fixed order, two rows a step, and writes the
// final dr, dk (type T) and dw; after the next block barrier one thread
// arrives at every sender's empty[b], and a sender waits there before it
// writes buffer b again (kBufs = 2 buffers: chunk c's partials go to
// buffer c % 2). du's partials are summed into one row a (batch, head)
// over the cluster at the end, and a second, small kernel adds those over
// the batch in order. The backward stages chunks by cp.async (16-byte
// pieces, raw T and float32) two deep and widens each once, four elements a
// step ((k, w) float32 pairs, r as T, v and dO float32), one block barrier
// a chunk; the checkpoint pass reads k, w and v through a cp.async ring of
// Smem::kRing (3) slots of 16 tokens in the same shared memory, one block
// barrier a slot, with kRows adjacent rows a thread (their k and w in one
// load each) storing each row's checkpoint for the thread that holds it in
// the backward. At hd 64 in bfloat16 a block holds 35 KB of shared memory
// (6 blocks an SM need at most 37 KB each).
//
// Scratch, sized by the wrapper (kernels/wkv6.py): the checkpoints ckpt
// (B x H x ceil(S / kChunk) x hd x hd float32) and du_part (B x H x hd
// float32). r, k, v, dO and dr, dk, dv are bfloat16 or float32 (one type),
// w, u, dw, du and the state's gradient float32; hd is 16, 32, 64 or 128
// (clusters of 1, 2, 4 or 8 blocks).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cgx = cooperative_groups;

constexpr int kChunk = 8;   // tokens between checkpoints (and staged at once)
constexpr int kHold = kChunk / 2;  // states a thread holds: half a chunk
constexpr int kSlice = 16;  // state columns a block (hd / kSlice blocks a cluster)
constexpr int kCols = 4;    // columns a thread
constexpr int kGroups = kSlice / kCols;  // lanes that share a group of rows
constexpr int kBufs = 2;  // buffers of row partials
constexpr int kFwdChunks = 2;  // chunks a slot of the forward's staging ring
// blocks an SM at hd 64: RWKV6-3B's 640 blocks in 160 clusters of 4 need 6
// for one wave on 132 SMs (at 5, not every cluster fits at once); 168
// registers a thread
constexpr int kMinBlocks64 = 6;

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const void* dout;
  const float* dstate;  // (B, H, hd, hd) or null
  float4* ckpt;         // (B, H, slices, chunks, kRows, threads) scratch
  void* dr;
  void* dk;
  void* dv;
  float* dw;
  float* du_part;       // (B, H, hd)
  int B, S, H;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
// two adjacent values (p 2-element aligned)
__device__ __forceinline__ void store2(float* p, float2 x) { *reinterpret_cast<float2*>(p) = x; }
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 x) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x.x, x.y);
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the shared::cluster address of shared::cta address `addr` in block
// `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// mbarriers. A float32 store into another block's shared memory that
// counts its 4 bytes on that block's barrier `bar` (both shared::cluster
// addresses): the owner learns from its barrier that the bytes are in,
// and no fence is needed on this side
__device__ __forceinline__ void st_async(uint32_t addr, float x, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];" ::"r"(
                   addr),
               "f"(x), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
// this thread's arrival, expecting `bytes` more in the current phase
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
// an arrival on another block's barrier (shared::cluster address)
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(bar) : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "WAIT:\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "\t@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

template <int HD>
struct Dims {
  static constexpr int kRows = HD == 16 ? 2 : 4;  // rows a thread
  static constexpr int kStride = HD / kRows;     // between a thread's rows
  static constexpr int kSlices = HD / kSlice;    // blocks of a head's cluster
  static constexpr int kThreads = kStride * kGroups;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kPerChunk = kChunk / kSlices;  // tokens of a chunk a block adds up
  // (at hd 128 shared memory holds 2 blocks an SM: 255 registers a thread)
  static constexpr int kMinBlocks = HD == 128 ? 2 : kMinBlocks64 * 64 / kThreads;
  static_assert(kThreads % 32 == 0, "a block is whole warps");
};

template <typename T, int HD>
struct Smem {
  static constexpr size_t kRow = sizeof(T) * kChunk * HD;       // r or k of a chunk
  static constexpr size_t kW = sizeof(float) * kChunk * HD;     // w of a chunk
  static constexpr size_t kCol = sizeof(T) * kChunk * kSlice;   // v or dO of the slice
  static constexpr size_t kStage = 2 * kRow + kW + 2 * kCol;   // one raw staging buffer
  // a chunk widened to float32: (k, w) [kChunk][HD] float2, r [kChunk][HD]
  // (as T), then v and dO [2][kChunk][kSlice]; two of them
  static constexpr size_t kWide = sizeof(float2) * kChunk * HD + sizeof(T) * kChunk * HD +
                                  sizeof(float) * 2 * kChunk * kSlice;
  // row partials received from the cluster's blocks, [kBufs][source block]
  // [kPerChunk tokens][dr, dk, dw][HD]; dv's warp sums [2][warps][kChunk]
  // [kSlice]; the barriers full[kBufs] and empty[kBufs]. At the end du's row
  // [HD] takes the staging buffers' place
  static constexpr size_t kRecv = sizeof(float) * kBufs * kChunk * 3 * HD;
  static constexpr size_t kDvRed = sizeof(float) * 2 * Dims<HD>::kWarps * kChunk * kSlice;
  static constexpr size_t kBars = sizeof(uint64_t) * 2 * kBufs;
  static constexpr size_t kBytes = 2 * kStage + 2 * kWide + kRecv + kDvRed + kBars;
  // bytes of row partials a block receives for one chunk
  static constexpr uint32_t kRecvBytes = sizeof(float) * kChunk * 3 * HD;
  static_assert(sizeof(float) * HD <= 2 * kStage, "du's row fits the staging buffers");
  // the forward's ring (k, w of every row, v of the slice): as many slots
  // as the staging and widened buffers hold, at most 4
  static constexpr size_t kFwd = kFwdChunks * (kRow + kW + kCol);
  static constexpr int kRing = (2 * kStage + 2 * kWide) / kFwd < 4
                                   ? static_cast<int>((2 * kStage + 2 * kWide) / kFwd)
                                   : 4;
  static_assert(kRing >= 3, "the forward's ring holds 3 slots");
};

// four values of T from device memory, raw, and as float32
template <typename T>
struct Quad;
template <>
struct Quad<float> {
  using type = float4;
  static __device__ __forceinline__ void get(const type& x, float (&f)[4]) {
    f[0] = x.x, f[1] = x.y, f[2] = x.z, f[3] = x.w;
  }
};
template <>
struct Quad<__nv_bfloat16> {
  using type = uint2;
  static __device__ __forceinline__ void get(const type& x, float (&f)[4]) {
    f[0] = __uint_as_float(x.x << 16), f[1] = __uint_as_float(x.x & 0xffff0000u);
    f[2] = __uint_as_float(x.y << 16), f[3] = __uint_as_float(x.y & 0xffff0000u);
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(Dims<HD>::kThreads, Dims<HD>::kMinBlocks)
    wkv6_bwd_kernel(const __grid_constant__ Args a) {
  using D = Dims<HD>;
  using M = Smem<T, HD>;
  using Q = Quad<T>;
  constexpr int R = D::kRows;
  constexpr int kStride = D::kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  float* recv = reinterpret_cast<float*>(smem + 2 * M::kStage + 2 * M::kWide);
  float* dvred = recv + kBufs * kChunk * 3 * HD;
  // full[b]: buffer b's partials are in (one arrival, the owner's, and the
  // bytes); empty[b]: every owner has read its buffer b (an arrival each)
  const uint32_t full0 = smem_u32(dvred + 2 * D::kWarps * kChunk * kSlice);
  const uint32_t empty0 = full0 + 8 * kBufs;
  cgx::cluster_group cluster = cgx::this_cluster();

  const int slice = blockIdx.x % D::kSlices;  // the block's rank in its cluster
  const int h = blockIdx.x / D::kSlices;
  const int b = blockIdx.y;
  const int j0 = slice * kSlice;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int grp = lane % kGroups;  // columns j0 + kCols grp ..
  const int i0 = tid / kGroups;    // rows i0 + kStride rr
  const int64_t tok = static_cast<int64_t>(a.H) * HD;  // elements a token
  const int64_t bh = static_cast<int64_t>(b) * a.H + h;
  const int64_t base = static_cast<int64_t>(b) * a.S * tok + static_cast<int64_t>(h) * HD;
  const int n_chunks = (a.S + kChunk - 1) / kChunk;
  // checkpoint c of the block's elements: [c][rr][thread] float4, by the
  // backward's threads and rows
  float4* const ckpt0 = a.ckpt + (bh * D::kSlices + slice) * n_chunks * R * D::kThreads;
  float uu[R];
#pragma unroll
  for (int rr = 0; rr < R; ++rr) uu[rr] = a.u[h * HD + i0 + rr * kStride];
  T* drp = static_cast<T*>(a.dr);
  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
  constexpr int rq = HD * sizeof(T) / 16;  // 16-byte pieces of a token's r or k row
  constexpr int wq = HD * sizeof(float) / 16;
  constexpr int vq = kSlice * sizeof(T) / 16;

  if (tid == 0) {
    for (int bi = 0; bi < kBufs; ++bi) {
      mbar_init(full0 + 8 * bi, 1);
      mbar_init(empty0 + 8 * bi, D::kSlices);
    }
    // the first use of each buffer (chunks n - 1 and n - 2)
    for (int c = n_chunks - 1; c >= 0 && c >= n_chunks - kBufs; --c) {
      mbar_expect(full0 + 8 * (c % kBufs), M::kRecvBytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();  // every block's barriers are set before any block sends

  // ---- forward: the state at the start of every chunk. k, w of every row
  // and v of the slice, raw, through a ring of M::kRing slots by cp.async
  float st[R][kCols];
#pragma unroll
  for (int rr = 0; rr < R; ++rr)
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) st[rr][cc] = 0.0f;
  const char* rp = static_cast<const char*>(a.r);
  const char* kp = static_cast<const char*>(a.k);
  const char* vp = static_cast<const char*>(a.v);
  const char* wp = reinterpret_cast<const char*>(a.w);
  const char* dp = static_cast<const char*>(a.dout);
  {
    // slot f of the ring holds chunks f * kFwdChunks .. (whole ones: the
    // forward stops before the last chunk)
    constexpr int kTok = kFwdChunks * kChunk;
    auto fetch = [&](int f) {
      unsigned char* kd = smem + (f % M::kRing) * M::kFwd;
      unsigned char* wd = kd + kTok * HD * sizeof(T);
      unsigned char* vd = wd + kTok * HD * sizeof(float);
      const int t0 = f * kTok;
      const int n = min(kTok, (n_chunks - 1) * kChunk - t0);
      for (int e = tid; e < n * rq; e += D::kThreads) {
        const int t = e / rq, q = e % rq;
        cp16(kd + t * HD * sizeof(T) + 16 * q, kp + (base + (t0 + t) * tok) * sizeof(T) + 16 * q);
      }
      for (int e = tid; e < n * wq; e += D::kThreads) {
        const int t = e / wq, q = e % wq;
        cp16(wd + t * HD * sizeof(float) + 16 * q,
             wp + (base + (t0 + t) * tok) * sizeof(float) + 16 * q);
      }
      for (int e = tid; e < n * vq; e += D::kThreads) {
        const int t = e / vq, q = e % vq;
        cp16(vd + t * kSlice * sizeof(T) + 16 * q,
             vp + (base + (t0 + t) * tok + j0) * sizeof(T) + 16 * q);
      }
    };
    const int n_fwd = n_chunks - 1;  // the last chunk's own tokens make no checkpoint
    const int n_slots = (n_fwd + kFwdChunks - 1) / kFwdChunks;
#pragma unroll
    for (int f = 0; f < M::kRing - 1; ++f) {
      if (f < n_slots) fetch(f);
      asm volatile("cp.async.commit_group;" ::: "memory");
    }
    // here a thread holds kRows adjacent rows (R i0 ..), so that their k and
    // w come in one load each; each row's checkpoint goes to the backward
    // thread that holds it
    for (int c = 0; c < n_chunks; ++c) {
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const int row = R * i0 + m;
        ckpt0[(static_cast<int64_t>(c) * R + row / kStride) * D::kThreads +
              (row % kStride) * kGroups + grp] =
            make_float4(st[m][0], st[m][1], st[m][2], st[m][3]);
      }
      if (c == n_fwd) break;
      const int f = c / kFwdChunks;
      if (c % kFwdChunks == 0) {
        asm volatile("cp.async.wait_group %0;" ::"n"(M::kRing - 2) : "memory");
        __syncthreads();  // slot f is in; every thread is done with slot f - 1
        if (f + M::kRing - 1 < n_slots) fetch(f + M::kRing - 1);
        asm volatile("cp.async.commit_group;" ::: "memory");
      }
      const int at = (c % kFwdChunks) * kChunk * HD;
      const unsigned char* kd = smem + (f % M::kRing) * M::kFwd;
      const T* ks = reinterpret_cast<const T*>(kd) + at + R * i0;
      const float* ws = reinterpret_cast<const float*>(kd + kTok * HD * sizeof(T)) + at + R * i0;
      const T* vs = reinterpret_cast<const T*>(kd + kTok * HD * (sizeof(T) + sizeof(float))) +
                    (c % kFwdChunks) * kChunk * kSlice + grp * kCols;
#pragma unroll
      for (int tt = 0; tt < kChunk; ++tt) {  // a chunk before the last is whole
        float v[kCols];
        Q::get(*reinterpret_cast<const typename Q::type*>(vs + tt * kSlice), v);
        float kt[R], wt[R];
        if constexpr (R == 4) {
          Q::get(*reinterpret_cast<const typename Q::type*>(ks + tt * HD), kt);
          const float4 w4 = *reinterpret_cast<const float4*>(ws + tt * HD);
          wt[0] = w4.x, wt[1] = w4.y, wt[2] = w4.z, wt[3] = w4.w;
        } else {
#pragma unroll
          for (int m = 0; m < R; ++m) kt[m] = to_f32(ks[tt * HD + m]), wt[m] = ws[tt * HD + m];
        }
#pragma unroll
        for (int m = 0; m < R; ++m) {
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) st[m][cc] = fmaf(wt[m], st[m][cc], kt[m] * v[cc]);
        }
      }
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();  // every thread is done with the ring, which the backward reuses
  }

  // ---- backward, chunk by chunk from the last
  // tokens c * kChunk .. raw into staging buffer c & 1 by cp.async: r, k, w
  // of every row, v and dO of this slice's columns
  auto stage = [&](int c) {
    unsigned char* dst = smem + (c & 1) * M::kStage;
    const int t0 = c * kChunk;
    const int n = min(kChunk, a.S - t0);
    const int64_t at0 = base + static_cast<int64_t>(t0) * tok;
#pragma unroll
    for (int it = 0; it < (kChunk * rq + D::kThreads - 1) / D::kThreads; ++it) {
      const int e = tid + it * D::kThreads;
      const int t = e / rq, q = e % rq;
      if (t < n) {
        const int64_t at = (at0 + t * tok) * sizeof(T) + 16 * q;
        const int to = t * HD * sizeof(T) + 16 * q;
        cp16(dst + to, rp + at);
        cp16(dst + M::kRow + to, kp + at);
      }
    }
#pragma unroll
    for (int it = 0; it < (kChunk * wq + D::kThreads - 1) / D::kThreads; ++it) {
      const int e = tid + it * D::kThreads;
      const int t = e / wq, q = e % wq;
      if (t < n) {
        cp16(dst + 2 * M::kRow + t * HD * sizeof(float) + 16 * q,
             wp + (at0 + t * tok) * sizeof(float) + 16 * q);
      }
    }
#pragma unroll
    for (int it = 0; it < (kChunk * vq + D::kThreads - 1) / D::kThreads; ++it) {
      const int e = tid + it * D::kThreads;
      const int t = e / vq, q = e % vq;
      if (t < n) {
        const int64_t at = (at0 + t * tok + j0) * sizeof(T) + 16 * q;
        const int to = t * kSlice * sizeof(T) + 16 * q;
        cp16(dst + 2 * M::kRow + M::kW + to, vp + at);
        cp16(dst + 2 * M::kRow + M::kW + M::kCol + to, dp + at);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  // chunk c widened once to float32 into buffer c & 1 (its staging buffer
  // must have landed for every thread). Tokens past S (the last chunk's
  // tail) are exact no-ops: w = 1 and r = k = v = dO = 0 leave S and G as
  // they are and add 0 to du
  auto widen = [&](int c) {
    const unsigned char* in = smem + (c & 1) * M::kStage;
    const T* rs = reinterpret_cast<const T*>(in);
    const T* ks = reinterpret_cast<const T*>(in + M::kRow);
    const float* ws = reinterpret_cast<const float*>(in + 2 * M::kRow);
    const T* vs = reinterpret_cast<const T*>(in + 2 * M::kRow + M::kW);
    const T* ds = vs + kChunk * kSlice;
    unsigned char* wide = smem + 2 * M::kStage + (c & 1) * M::kWide;
    float2* kw = reinterpret_cast<float2*>(wide);
    T* rw = reinterpret_cast<T*>(wide + sizeof(float2) * kChunk * HD);
    float* vdf = reinterpret_cast<float*>(rw + kChunk * HD);
    const int n = min(kChunk, a.S - c * kChunk);
    using QT = typename Q::type;
    // four elements (of one token) a thread a step
#pragma unroll
    for (int it = 0; it < kChunk * HD / 4 / D::kThreads; ++it) {
      const int e = 4 * (tid + it * D::kThreads);
      float kf[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float4 w4 = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
      QT r4 = {};
      if (e < n * HD) {
        Q::get(*reinterpret_cast<const QT*>(ks + e), kf);
        r4 = *reinterpret_cast<const QT*>(rs + e);
        w4 = *reinterpret_cast<const float4*>(ws + e);
      }
      float4* kw4 = reinterpret_cast<float4*>(kw + e);
      kw4[0] = make_float4(kf[0], w4.x, kf[1], w4.y);
      kw4[1] = make_float4(kf[2], w4.z, kf[3], w4.w);
      *reinterpret_cast<QT*>(rw + e) = r4;
    }
    constexpr int kVd = kChunk * kSlice / 4;  // steps of v, then of dO
#pragma unroll
    for (int it = 0; it < (2 * kVd + D::kThreads - 1) / D::kThreads; ++it) {
      const int e4 = tid + it * D::kThreads;
      if (e4 < 2 * kVd) {
        const int e = 4 * (e4 % kVd);
        float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (e < n * kSlice) Q::get(*reinterpret_cast<const QT*>((e4 < kVd ? vs : ds) + e), x);
        *reinterpret_cast<float4*>(vdf + (e4 / kVd) * kChunk * kSlice + e) =
            make_float4(x[0], x[1], x[2], x[3]);
      }
    }
  };
  // dv of chunk c: the warps' sums, warp by warp (the slice's columns are
  // this block's alone)
  auto dv_sum = [&](int c) {
    const float* red = dvred + (c & 1) * D::kWarps * kChunk * kSlice;
    const int t0 = c * kChunk;
    const int n = min(kChunk, a.S - t0);
    for (int e = tid; e < n * kSlice; e += D::kThreads) {
      const int tt = e / kSlice, jj = e % kSlice;
      float sum = 0.0f;
#pragma unroll
      for (int wi = 0; wi < D::kWarps; ++wi) sum += red[(wi * kChunk + tt) * kSlice + jj];
      store(dvp + base + (t0 + tt) * tok + j0 + jj, sum);
    }
  };
  // dr, dk, dw of this block's tokens of chunk c from the row partials the
  // cluster's blocks sent it, block by block (after the barrier the chunk
  // arrived at). Token tt of a chunk belongs to block tt % slices. gather()
  // reads and adds them up; put() stores them
  // two adjacent rows a step
  constexpr int kPairs = D::kPerChunk * 3 * HD / 2;  // row pairs of a chunk a block adds up
  constexpr int kOut = (kPairs + D::kThreads - 1) / D::kThreads;  // steps a thread
  float2 sums[kOut];
  auto gather = [&](int c) {
    const float* in = recv + (c % kBufs) * kChunk * 3 * HD;
#pragma unroll
    for (int it = 0; it < kOut; ++it) {
      const int e = 2 * (tid + it * D::kThreads);
      if (kPairs % D::kThreads != 0 && e >= 2 * kPairs) break;
      const int tl = e / (3 * HD);
      float2 x = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int src = 0; src < D::kSlices; ++src) {
        const float2 y = *reinterpret_cast<const float2*>(
            in + ((src * D::kPerChunk + tl) * 3 + (e / HD) % 3) * HD + e % HD);
        x.x += y.x;
        x.y += y.y;
      }
      sums[it] = x;
    }
  };
  auto put = [&](int c) {
#pragma unroll
    for (int it = 0; it < kOut; ++it) {
      const int e = 2 * (tid + it * D::kThreads);
      if (kPairs % D::kThreads != 0 && e >= 2 * kPairs) break;
      const int tl = e / (3 * HD);
      const int q = (e / HD) % 3;
      const int row = e % HD;
      const int t = c * kChunk + tl * D::kSlices + slice;
      if (t >= a.S) continue;
      const int64_t out = base + t * tok + row;
      if (q == 0) {
        store2(drp + out, sums[it]);
      } else if (q == 1) {
        store2(dkp + out, sums[it]);
      } else {
        store2(a.dw + out, sums[it]);
      }
    }
  };

  float g[R][kCols];
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    if (a.dstate != nullptr) {
      const float4 x = *reinterpret_cast<const float4*>(
          a.dstate + (bh * HD + i0 + rr * kStride) * HD + j0 + grp * kCols);
      g[rr][0] = x.x, g[rr][1] = x.y, g[rr][2] = x.z, g[rr][3] = x.w;
    } else {
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) g[rr][cc] = 0.0f;
    }
  }
  float du[R];
#pragma unroll
  for (int rr = 0; rr < R; ++rr) du[rr] = 0.0f;
  // the checkpoint of chunk c into st (issued early: st is free until used)
  auto load_ckpt = [&](int c) {
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const float4 x = ckpt0[(static_cast<int64_t>(c) * R + rr) * D::kThreads + tid];
      st[rr][0] = x.x, st[rr][1] = x.y, st[rr][2] = x.z, st[rr][3] = x.w;
    }
  };
  if (n_chunks > 0) {
    load_ckpt(n_chunks - 1);
    stage(n_chunks - 1);
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    if (n_chunks > 1) stage(n_chunks - 2);
    widen(n_chunks - 1);
  }
  // One block barrier a chunk: at its top, chunk c's widened buffer is
  // complete, chunk c - 1's copy has landed, and every thread is done with
  // chunk c + 1 (whose staging, widened and dv buffers are c's partners')
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int b = c % kBufs;
    const uint32_t use = (n_chunks - 1 - c) / kBufs;  // of buffer b, from 0
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    if (tid == 0 && c + 1 < n_chunks) {
      // every thread has read chunk c + 1's partials: its buffer is free
      // in this block, for chunk c - 1 (armed here), from every sender
      const int bp = (c + 1) % kBufs;
      if (c >= 1) mbar_expect(full0 + 8 * bp, M::kRecvBytes);
#pragma unroll
      for (int o = 0; o < D::kSlices; ++o) mbar_arrive_remote(map_rank(empty0 + 8 * bp, o));
    }
    if (c >= 2) stage(c - 2);
    if (c + 1 < n_chunks) dv_sum(c + 1);
    const unsigned char* wide = smem + 2 * M::kStage + (c & 1) * M::kWide;
    const float2* kw_i = reinterpret_cast<const float2*>(wide) + i0;
    const T* r_i = reinterpret_cast<const T*>(wide + sizeof(float2) * kChunk * HD) + i0;
    const float* vf = reinterpret_cast<const float*>(wide + sizeof(float2) * kChunk * HD +
                                                     sizeof(T) * kChunk * HD) +
                      grp * kCols;
    const float* df = vf + kChunk * kSlice;
    float* red = dvred + (c & 1) * D::kWarps * kChunk * kSlice;

    // where this block sends chunk c's row partials of token tt: block
    // tt % slices, buffer b, slot [slice][tt / slices], counted on that
    // block's full[b] (at the same offset from the slot in every block);
    // first every owner must have read buffer b's last use
    const uint32_t slot = smem_u32(recv + b * kChunk * 3 * HD + slice * D::kPerChunk * 3 * HD);
    const uint32_t to_bar = full0 + 8 * b - slot;
    uint32_t to[D::kSlices];
#pragma unroll
    for (int o = 0; o < D::kSlices; ++o) to[o] = map_rank(slot, o);
    if (use >= 1) mbar_wait(empty0 + 8 * b, (use - 1) & 1);
    auto send = [&](int tt, int q, int row, float x) {
      st_async(to[tt % D::kSlices] +
                   4u * static_cast<uint32_t>(((tt / D::kSlices) * 3 + q) * HD + row),
               x, to[tt % D::kSlices] + to_bar);
    };
    auto load_vd = [&](int tt, float (&v)[kCols], float (&d)[kCols]) {
      const float4 v4 = *reinterpret_cast<const float4*>(vf + tt * kSlice);
      const float4 d4 = *reinterpret_cast<const float4*>(df + tt * kSlice);
      v[0] = v4.x, v[1] = v4.y, v[2] = v4.z, v[3] = v4.w;
      d[0] = d4.x, d[1] = d4.y, d[2] = d4.z, d[3] = d4.w;
    };

    // tokens t0 .. t0 + kHold - 1 forward from st: the states only
    auto advance = [&](int t0) {
#pragma unroll
      for (int tt = t0; tt < t0 + kHold; ++tt) {
        const float4 v4 = *reinterpret_cast<const float4*>(vf + tt * kSlice);
        const float v[kCols] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          const float2 x = kw_i[tt * HD + rr * kStride];  // k, w of the row
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) st[rr][cc] = fmaf(x.y, st[rr][cc], x.x * v[cc]);
        }
      }
    };
    // tokens t0 .. t0 + kHold - 1 forward from st, keeping each S_{t-1} in
    // hist, and dr = sum_j dO_j S_{t-1}[i, j] + u_i k_i (dO . v)
    float hist[kHold][R][kCols];
    float dovs[kHold];  // the thread's share of dO . v, from the rebuild to the walk
    auto rebuild = [&](int t0) {
#pragma unroll
      for (int th = 0; th < kHold; ++th) {
        const int tt = t0 + th;
        float v[kCols], d[kCols];
        load_vd(tt, v, d);
        float dov = 0.0f;  // this thread's columns' share of dO . v
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) dov = fmaf(d[cc], v[cc], dov);
        dovs[th] = dov;
        float acc[R];
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          const float2 x = kw_i[tt * HD + rr * kStride];
          acc[rr] = 0.0f;
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) {
            hist[th][rr][cc] = st[rr][cc];
            acc[rr] = fmaf(d[cc], st[rr][cc], acc[rr]);
            st[rr][cc] = fmaf(x.y, st[rr][cc], x.x * v[cc]);
          }
          acc[rr] = fmaf(uu[rr] * x.x, dov, acc[rr]);
        }
        // over the row group's 4 lanes, a reduce-scatter: lane l ends with
        // the dr of its row (l & 2 ? 2 : 0) + (l & 1) (R = 2: l & 2 ? 1 : 0,
        // two lanes hold it)
        const bool upper = lane & 2, odd = lane & 1;
        if constexpr (R == 4) {
          float y0 = upper ? acc[2] : acc[0];
          float y1 = upper ? acc[3] : acc[1];
          y0 += __shfl_xor_sync(0xffffffffu, upper ? acc[0] : acc[2], 2);
          y1 += __shfl_xor_sync(0xffffffffu, upper ? acc[1] : acc[3], 2);
          float y = odd ? y1 : y0;
          y += __shfl_xor_sync(0xffffffffu, odd ? y0 : y1, 1);
          send(tt, 0, i0 + ((upper ? 2 : 0) + (odd ? 1 : 0)) * kStride, y);
        } else {
          float y = upper ? acc[1] : acc[0];
          y += __shfl_xor_sync(0xffffffffu, upper ? acc[0] : acc[1], 2);
          y += __shfl_xor_sync(0xffffffffu, y, 1);
          if (!odd) send(tt, 0, i0 + (upper ? kStride : 0), y);  // once a row
        }
      }
    };
    // tokens t0 + kHold - 1 .. t0 backward with G: dk = sum_j G v_j + r_i
    // u_i (dO . v), dw = sum_j G S_{t-1}, and dv's share sum_i (G + r_i u_i
    // dO_j) k_i
    auto walk = [&](int t0) {
#pragma unroll
      for (int th = kHold - 1; th >= 0; --th) {
        const int tt = t0 + th;
        float v[kCols], d[kCols];
        load_vd(tt, v, d);
        const float dov = dovs[th];
        float dw[R], dk[R], col[kCols];
        float rukk = 0.0f;  // sum over the thread's rows of r_i u_i k_i
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          const float2 x = kw_i[tt * HD + rr * kStride];  // k, w of the row
          const float rt = to_f32(r_i[tt * HD + rr * kStride]);
          const float ruk = rt * uu[rr];
          dw[rr] = 0.0f, dk[rr] = 0.0f;
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) {
            dw[rr] = fmaf(g[rr][cc], hist[th][rr][cc], dw[rr]);
            dk[rr] = fmaf(g[rr][cc], v[cc], dk[rr]);
            col[cc] = rr == 0 ? g[rr][cc] * x.x : fmaf(g[rr][cc], x.x, col[cc]);
            g[rr][cc] = fmaf(x.y, g[rr][cc], rt * d[cc]);
          }
          dk[rr] = fmaf(ruk, dov, dk[rr]);
          du[rr] = fmaf(rt * x.x, dov, du[rr]);
          rukk = fmaf(ruk, x.x, rukk);
        }
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) col[cc] = fmaf(d[cc], rukk, col[cc]);
        // (dk, dw) of the thread's rows over the row group's 4 lanes, a
        // reduce-scatter: lane l ends with dk and dw of its row (l & 2 ? 2 :
        // 0) + (l & 1) (R = 2: dk (l & 1 == 0) or dw, of row l & 2 ? 1 : 0)
        const bool upper = lane & 2, odd = lane & 1;
        if constexpr (R == 4) {
          float a0 = upper ? dk[2] : dk[0], a1 = upper ? dk[3] : dk[1];
          float b0 = upper ? dw[2] : dw[0], b1 = upper ? dw[3] : dw[1];
          a0 += __shfl_xor_sync(0xffffffffu, upper ? dk[0] : dk[2], 2);
          a1 += __shfl_xor_sync(0xffffffffu, upper ? dk[1] : dk[3], 2);
          b0 += __shfl_xor_sync(0xffffffffu, upper ? dw[0] : dw[2], 2);
          b1 += __shfl_xor_sync(0xffffffffu, upper ? dw[1] : dw[3], 2);
          float yk = odd ? a1 : a0, yw = odd ? b1 : b0;
          yk += __shfl_xor_sync(0xffffffffu, odd ? a0 : a1, 1);
          yw += __shfl_xor_sync(0xffffffffu, odd ? b0 : b1, 1);
          const int row = i0 + ((upper ? 2 : 0) + (odd ? 1 : 0)) * kStride;
          send(tt, 1, row, yk);
          send(tt, 2, row, yw);
        } else {
          float y0 = upper ? dk[1] : dk[0];
          float y1 = upper ? dw[1] : dw[0];
          y0 += __shfl_xor_sync(0xffffffffu, upper ? dk[0] : dk[1], 2);
          y1 += __shfl_xor_sync(0xffffffffu, upper ? dw[0] : dw[1], 2);
          float y = odd ? y1 : y0;
          y += __shfl_xor_sync(0xffffffffu, odd ? y0 : y1, 1);
          send(tt, odd ? 2 : 1, i0 + (upper ? kStride : 0), y);
        }
        // dv: the 4 columns over the warp's 8 row groups (lanes 4 apart), a
        // reduce-scatter leaving lane l with column (l & 16 ? 2 : 0) +
        // (l & 8 ? 1 : 0) of its group
        {
          const bool b16 = lane & 16, b8 = lane & 8;
          float x0 = b16 ? col[2] : col[0];
          float x1 = b16 ? col[3] : col[1];
          x0 += __shfl_xor_sync(0xffffffffu, b16 ? col[0] : col[2], 16);
          x1 += __shfl_xor_sync(0xffffffffu, b16 ? col[1] : col[3], 16);
          float x = b8 ? x1 : x0;
          x += __shfl_xor_sync(0xffffffffu, b8 ? x0 : x1, 8);
          x += __shfl_xor_sync(0xffffffffu, x, 4);
          // lanes 4 apart store the same
          red[(warp * kChunk + tt) * kSlice + grp * kCols + (b16 ? 2 : 0) + (b8 ? 1 : 0)] = x;
        }
      }
    };

    // st holds the chunk's checkpoint: its first half forward, its second
    // half forward kept and walked back; then the first half again from the
    // checkpoint (reloaded into st, which is free during the walk), kept and
    // walked back
    advance(0);
    rebuild(kHold);
    load_ckpt(c);
    walk(kHold);
    rebuild(0);
    if (c > 0) load_ckpt(c - 1);  // the next chunk's, early
    walk(0);
    if (c >= 1) widen(c - 1);
    // every block's partials of chunk c are in: add up the ones this block
    // owns (the next chunk's top frees the buffer in every sender)
    mbar_wait(full0 + 8 * b, use & 1);
    gather(c);
    put(c);
  }
  if (n_chunks > 0) {
    __syncthreads();
    dv_sum(0);
  }
  // du: over the row group's lanes, then over the cluster's slices, slice
  // by slice
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    du[rr] += __shfl_xor_sync(0xffffffffu, du[rr], 1);
    du[rr] += __shfl_xor_sync(0xffffffffu, du[rr], 2);
  }
  float* dus = reinterpret_cast<float*>(smem);  // the staging buffers are idle now
  if (grp == 0) {
#pragma unroll
    for (int rr = 0; rr < R; ++rr) dus[i0 + rr * kStride] = du[rr];
  }
  cluster.sync();
  if (slice == 0) {
    for (int e = tid; e < HD; e += D::kThreads) {
      float x = 0.0f;
#pragma unroll
      for (int src = 0; src < D::kSlices; ++src) x += cluster.map_shared_rank(dus, src)[e];
      a.du_part[bh * HD + e] = x;
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// du (H, hd) from the (batch, H, hd) partials, batch by batch
__global__ void wkv6_bwd_du_kernel(const float* du_part, float* du, int B, int hh) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= hh) return;
  float x = 0.0f;
  for (int b = 0; b < B; ++b) x += du_part[static_cast<int64_t>(b) * hh + e];
  du[e] = x;
}

template <typename T, int HD>
int launch(const Args& a, float* du, cudaStream_t stream) {
  using D = Dims<HD>;
  constexpr size_t smem = Smem<T, HD>::kBytes;
  // all of an SM's unified L1 as shared memory, so that 5 blocks fit (the
  // driver's own choice for a block under 48 KB holds fewer)
  cudaError_t err = cudaFuncSetAttribute(wkv6_bwd_kernel<T, HD>,
                                         cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(wkv6_bwd_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(D::kSlices * a.H, a.B, 1);
  cfg.blockDim = dim3(D::kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = D::kSlices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, wkv6_bwd_kernel<T, HD>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hh = a.H * HD;
  wkv6_bwd_du_kernel<<<(hh + 255) / 256, 256, 0, stream>>>(a.du_part, du, a.B, hh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const Args& a, int hd, float* du, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(a, du, stream);
    case 32: return launch<T, 32>(a, du, stream);
    case 64: return launch<T, 64>(a, du, stream);
    case 128: return launch<T, 128>(a, du, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Tokens between checkpoints, state columns a block (a cluster holds hd /
// slice blocks), columns a thread and rows a thread at head size hd (0:
// unsupported): the wrapper sizes the scratch and checks its launch
// geometry (kernels/wkv6.py::wkv6_bwd_grid) with them.
extern "C" int wkv6_bwd_chunk() { return kChunk; }
extern "C" int wkv6_bwd_slice() { return kSlice; }
extern "C" int wkv6_bwd_cols() { return kCols; }
extern "C" int wkv6_bwd_rows(int hd) {
  switch (hd) {
    case 16: return Dims<16>::kRows;
    case 32: return Dims<32>::kRows;
    case 64: return Dims<64>::kRows;
    case 128: return Dims<128>::kRows;
    default: return 0;
  }
}

// r, k, v, dout, dr, dk, dv (batch, S, H, hd) of one type (dtype 0 =
// float32, 1 = bfloat16); w, dw (batch, S, H, hd), u, du (H, hd) and dstate
// (batch, H, hd, hd; null for zeros) float32; scratch ckpt (batch * H *
// chunks * hd * hd, chunks = ceil(S / kChunk)) and du_part (batch * H * hd)
// float32: contiguous device arrays, 16-byte aligned. Launches the two
// kernels on `stream` and returns the CUDA error as an int (0 = launched).
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* dout,
                               const void* dstate, void* ckpt, void* du_part,
                               void* dr, void* dk, void* dv, void* dw, void* du,
                               int dtype, int batch, int S, int H, int hd, void* stream) {
  if (batch <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (S < 0 || batch > 65535 || H > 2147483647 / 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{r, k, v, static_cast<const float*>(w), static_cast<const float*>(u), dout,
               static_cast<const float*>(dstate), static_cast<float4*>(ckpt), dr, dk, dv,
               static_cast<float*>(dw), static_cast<float*>(du_part), batch, S, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* duf = static_cast<float*>(du);
  if (dtype == 0) return launch_hd<float>(a, hd, duf, st);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(a, hd, duf, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
