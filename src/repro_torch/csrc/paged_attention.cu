// One-token decode attention over a paged KV cache, or over a contiguous
// decode cache read in place (Hopper).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::
// paged_decode_attention (body _paged_kernel; pallas_call at
// paged_attention.py:113). Sequence b attends with its H query heads over
// the pages page_table[b, 0..ppseq) of the K and V pools (-1 marks a hole),
// to the first lengths[b] token positions; query head h reads KV head
// h / (H / KV) (grouped-query attention). The softmax is float32. A sequence
// with no valid token returns zeros, as the reference ref.paged_decode_
// attention does (the TPU kernel would return the mean of the masked page's
// V there).
//
// The same kernel serves the models' decode cache (B, S_max, KV, hd), which
// ops.decode_attention reads (ref.decode_attention in the JAX package, which
// has no TPU kernel for it): with no page table, sequence b is "page" b, the
// page stride is the cache's batch stride, and every sequence has the same
// valid_len tokens. Token t of sequence b, KV head g, is then read at
// base + b * stride_b + t * stride_t + g * stride_h, in place: no sliced or
// float32 copy of the cache is made.
//
// Bound: bytes. Decode reads every valid token's K and V row once
// (2 * valid tokens * KV * hd elements) and does 4 * H * hd flops per valid
// token: about rep flops a byte in bf16, far below the 295 at which the
// tensor cores would be the limit, so the K/V bytes over 3.35 TB/s bound it.
// At 16 sequences of 32,768 tokens (8 KV heads of 128, bf16) that is 2.15 GB
// and 0.641 ms a call; at serving shapes a few microseconds.
//
// Design: long runs through a cp.async ring, merged by log-sum-exp.
// paged_split_kernel runs one block of 128 threads per (sequence, KV head,
// group of up to 8 of its query heads, split); a split is a run of
// split_tokens consecutive token positions, which the wrapper sizes so that
// the grid is what the card holds at once (runs of thousands of positions at
// long contexts, so a block's start and end are a small share of it and the
// merge reads a few partials). The block walks its run in tiles of TILE
// tokens through a ring of kStages tiles in shared memory: while it computes
// tile i, the cp.async copies of tiles i + 1 .. i + kStages - 1 are in flight
// (16 bytes a thread, zero-filled past the run's end and in holes; plain
// loads where a pool's pointers or strides are not 16-byte aligned). A group
// of L lanes takes a token row, each lane 16 bytes of it, and keeps its own
// online softmax in registers for every query head of the block: the dot
// products with the query rows held in registers, reduced by shuffles, times
// sm_scale * log2(e); the running max m, sum l of exp2(score - m) and output
// o = sum p v, rescaled when m grows. At the run's end the block's lane
// groups merge their (m, l, o) through shared memory. With one split the
// block writes o / l straight to the output. With more, each split writes (m,
// l, o) in float32 to scratch, and paged_merge_kernel, launched right after
// by the same call, merges them: M = max m_s, out = sum exp2(m_s - M) o_s /
// sum exp2(m_s - M) l_s, in q's dtype. A split with no valid token has m =
// -inf and l = 0 and adds nothing; a sequence with none gives zeros. No
// tensor cores: the work is a few flops a byte. The pools are read through a
// page (or batch) stride, a token stride and a head stride (the head
// dimension contiguous), so K and V of one layer group are read straight out
// of a serving pool whose pages hold all groups, and a layer's cache straight
// out of the decode state. hd is 16, 32, 64, 128 or 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStages = 3;       // tiles of the ring
constexpr int kRowsPerGroup = 4;  // token rows a lane group takes from a tile
constexpr int kMaxRepTile = 8;    // query heads a block holds in registers
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of shared memory as float32 values
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* table;    // null: a contiguous cache, sequence b is page b
  const int32_t* lengths;  // null: every sequence has valid_len tokens
  void* out;
  float* part;  // (batch, heads, n_splits) x (hd + 2) floats: o, then m, l
  int heads, kv_heads, rep_groups, page_size, ppseq, valid_len, split_tokens;
  int64_t q_sb, q_sh;                // q strides: sequence, head
  int64_t k_sp, k_st, k_sh;          // K strides: page (or sequence), token, head
  int64_t v_sp, v_st, v_sh;          // V strides
  int64_t o_sb, o_sh;                // out strides
  float scale_log2;                  // sm_scale * log2(e)
  bool async_loads;                  // 16-byte aligned rows: cp.async
};

// The shape of one instantiation: a token row is C chunks of 16 bytes (N
// elements), taken by L lanes, NCH chunks a lane; G lane groups a block, a
// tile of G * kRowsPerGroup rows.
template <typename T, int HD>
struct Shape {
  static constexpr int N = 16 / sizeof(T);
  static constexpr int C = HD / N;
  static constexpr int L = C < 32 ? C : 32;
  static constexpr int NCH = C / L;
  static constexpr int G = kThreads / L;
  static constexpr int TILE = G * kRowsPerGroup;
  static constexpr int RS = NCH * N;  // elements of a row a lane holds
};

// dynamic shared memory of a split block: the ring, reused at the end for
// the lane groups' (m, l, o)
template <typename T, int HD, int RT>
constexpr size_t split_smem() {
  using S = Shape<T, HD>;
  constexpr size_t ring = size_t(kStages) * 2 * S::TILE * HD * sizeof(T);
  constexpr size_t merge = size_t(S::G) * RT * (HD + 2) * sizeof(float);
  return ring > merge ? ring : merge;
}

template <typename T, int HD, int RT>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(Args a) {
  using S = Shape<T, HD>;
  constexpr int N = S::N, C = S::C, L = S::L, NCH = S::NCH, G = S::G;
  constexpr int TILE = S::TILE, RS = S::RS;
  constexpr int kStage = 2 * TILE * HD;  // elements of a ring stage: K, then V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);

  const int b = blockIdx.x;
  const int g = blockIdx.y / a.rep_groups;  // KV head
  const int r0 = (blockIdx.y % a.rep_groups) * RT;
  const int rep = a.heads / a.kv_heads;
  const int split = blockIdx.z;
  const int32_t* trow =
      a.table ? a.table + static_cast<int64_t>(b) * a.ppseq : nullptr;
  const int len = trow ? min(a.lengths[b], a.ppseq * a.page_size) : a.valid_len;
  const int t0 = split * a.split_tokens;
  const int t1 = min(t0 + a.split_tokens, len);
  const int n_tiles = t1 > t0 ? (t1 - t0 + TILE - 1) / TILE : 0;
  const T* kp = static_cast<const T*>(a.k) + g * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + g * a.v_sh;

  // tile i's K and V rows into ring stage i % kStages
  auto load_tile = [&](int i) {
    T* ks = ring + (i % kStages) * kStage;
    T* vs = ks + TILE * HD;
    const int base = t0 + i * TILE;
#pragma unroll
    for (int it = 0; it < TILE * C / kThreads; ++it) {
      const int e = it * kThreads + threadIdx.x;
      const int row = e / C;
      const int c = e % C;
      const int t = base + row;
      bool ok = t < t1;
      int64_t ko = 0, vo = 0;
      if (ok) {
        int64_t page = b;
        int within = t;
        if (trow) {
          page = trow[t / a.page_size];
          within = t % a.page_size;
          ok = page >= 0;
        }
        if (ok) {
          ko = page * a.k_sp + within * a.k_st + c * N;
          vo = page * a.v_sp + within * a.v_st + c * N;
        }
      }
      T* kd = ks + row * HD + c * N;
      T* vd = vs + row * HD + c * N;
      if (a.async_loads) {
        cp_async16(kd, kp + ko, ok ? 16 : 0);
        cp_async16(vd, vp + vo, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          kd[j] = ok ? kp[ko + j] : from_f32<T>(0.0f);
          vd[j] = ok ? vp[vo + j] : from_f32<T>(0.0f);
        }
      }
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }

  // the block's query heads in registers while the first tiles fly
  const int grp = threadIdx.x / L;
  const int li = threadIdx.x % L;
  float qr[RT][RS];
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const bool ok = r0 + r < rep;
    const T* qh = qb + static_cast<int64_t>(g * rep + (ok ? r0 + r : 0)) * a.q_sh;
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc)
#pragma unroll
      for (int j = 0; j < N; ++j)
        qr[r][cc * N + j] = ok ? to_f32(qh[(cc * L + li) * N + j]) : 0.0f;
  }
  float m[RT], l[RT], o[RT][RS];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < RS; ++e) o[r][e] = 0.0f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile i landed
    __syncthreads();               // everyone's; and tile i - 1 is read
    if (i + kStages - 1 < n_tiles) load_tile(i + kStages - 1);
    cp_async_commit();
    const T* ks = ring + (i % kStages) * kStage;
    const T* vs = ks + TILE * HD;
    const int base = t0 + i * TILE;

    // scores of the group's rows grp, G + grp, ...: neighbouring groups read
    // neighbouring rows
    float s[kRowsPerGroup][RT];
#pragma unroll
    for (int j = 0; j < kRowsPerGroup; ++j) {
      const T* kr = ks + (j * G + grp) * HD;
#pragma unroll
      for (int r = 0; r < RT; ++r) s[j][r] = 0.0f;
#pragma unroll
      for (int cc = 0; cc < NCH; ++cc) {
        float kf[N];
        load16(kr + (cc * L + li) * N, kf);
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int e = 0; e < N; ++e) s[j][r] = fmaf(qr[r][cc * N + e], kf[e], s[j][r]);
      }
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < kRowsPerGroup; ++j)
#pragma unroll
        for (int r = 0; r < RT; ++r)
          s[j][r] += __shfl_xor_sync(0xffffffffu, s[j][r], off);
#pragma unroll
    for (int j = 0; j < kRowsPerGroup; ++j) {
      const int t = base + j * G + grp;
      const bool valid = t < t1 && (!trow || trow[t / a.page_size] >= 0);
#pragma unroll
      for (int r = 0; r < RT; ++r) s[j][r] = valid ? s[j][r] * a.scale_log2 : -INFINITY;
    }

    // online softmax: rescale by exp2(m_old - m_new) when the max grows
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < kRowsPerGroup; ++j) mx = fmaxf(mx, s[j][r]);
      const float mu = mx == -INFINITY ? 0.0f : mx;  // no valid token yet: p = 0
      const float corr = exp2f(m[r] - mu);
      l[r] *= corr;
#pragma unroll
      for (int e = 0; e < RS; ++e) o[r][e] *= corr;
#pragma unroll
      for (int j = 0; j < kRowsPerGroup; ++j) {
        s[j][r] = exp2f(s[j][r] - mu);
        l[r] += s[j][r];
      }
      m[r] = mx;
    }
#pragma unroll
    for (int j = 0; j < kRowsPerGroup; ++j) {
      const T* vr = vs + (j * G + grp) * HD;
#pragma unroll
      for (int cc = 0; cc < NCH; ++cc) {
        float vf[N];
        load16(vr + (cc * L + li) * N, vf);
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int e = 0; e < N; ++e)
            o[r][cc * N + e] = fmaf(s[j][r], vf[e], o[r][cc * N + e]);
      }
    }
  }

  // the lane groups' (m, l, o) merged through shared memory
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  float* mm = reinterpret_cast<float*>(smem_raw);  // [G][RT]
  float* ll = mm + G * RT;                          // [G][RT]
  float* oo = ll + G * RT;                          // [G][RT][HD]
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (li == 0) {
      mm[grp * RT + r] = m[r];
      ll[grp * RT + r] = l[r];
    }
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc)
#pragma unroll
      for (int e = 0; e < N; ++e)
        oo[(grp * RT + r) * HD + (cc * L + li) * N + e] = o[r][cc * N + e];
  }
  __syncthreads();
  const int n_splits = gridDim.z;
  for (int idx = threadIdx.x; idx < RT * HD; idx += kThreads) {
    const int r = idx / HD;
    const int d = idx % HD;
    if (r0 + r >= rep) break;
    float mx = -INFINITY;
    for (int gg = 0; gg < G; ++gg) mx = fmaxf(mx, mm[gg * RT + r]);
    const float mu = mx == -INFINITY ? 0.0f : mx;
    float lsum = 0.0f, acc = 0.0f;
    for (int gg = 0; gg < G; ++gg) {
      const float w = exp2f(mm[gg * RT + r] - mu);  // 0 for a group with no token
      lsum = fmaf(w, ll[gg * RT + r], lsum);
      acc = fmaf(w, oo[(gg * RT + r) * HD + d], acc);
    }
    const int h = g * rep + r0 + r;
    if (n_splits == 1) {
      static_cast<T*>(a.out)[b * a.o_sb + h * a.o_sh + d] =
          from_f32<T>(lsum > 0.0f ? acc / lsum : 0.0f);
    } else {
      float* part = a.part + ((static_cast<int64_t>(b) * a.heads + h) * n_splits +
                              split) * (HD + 2);
      part[d] = acc;
      if (d == 0) {
        part[HD] = mx;
        part[HD + 1] = lsum;
      }
    }
  }
}

// One block of HD threads per (sequence, query head): the log-sum-exp merge
// of the n_splits partials.
template <typename T, int HD>
__global__ void __launch_bounds__(HD) paged_merge_kernel(Args a, int n_splits) {
  const int b = blockIdx.x / a.heads;
  const int h = blockIdx.x % a.heads;
  const int d = threadIdx.x;
  const float* part = a.part + static_cast<int64_t>(blockIdx.x) * n_splits * (HD + 2);
  float mx = -INFINITY;
  for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, part[s * (HD + 2) + HD]);
  float o = 0.0f;
  if (mx != -INFINITY) {
    float l = 0.0f, acc = 0.0f;
    for (int s = 0; s < n_splits; ++s) {
      const float* ps = part + s * (HD + 2);
      const float w = exp2f(ps[HD] - mx);  // 0 for a split with no token
      l = fmaf(w, ps[HD + 1], l);
      acc = fmaf(w, ps[d], acc);
    }
    o = l > 0.0f ? acc / l : 0.0f;
  }
  static_cast<T*>(a.out)[b * a.o_sb + h * a.o_sh + d] = from_f32<T>(o);
}

// query heads a block takes: all of a KV head's, up to kMaxRepTile, as a
// power of two
int rep_tile(int rep) {
  int rt = 1;
  while (rt < rep && rt < kMaxRepTile) rt *= 2;
  return rt;
}

template <typename T, int HD, int RT>
cudaError_t allow_smem() {
  constexpr size_t smem = split_smem<T, HD, RT>();
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(paged_split_kernel<T, HD, RT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// out[0] = tile tokens, out[1] = split blocks an SM holds at once
struct Plan {
  int* out;
  template <typename T, int HD, int RT>
  int run() const {
    cudaError_t err = allow_smem<T, HD, RT>();
    if (err != cudaSuccess) return static_cast<int>(err);
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, paged_split_kernel<T, HD, RT>, kThreads, split_smem<T, HD, RT>());
    out[0] = Shape<T, HD>::TILE;
    out[1] = blocks;
    return static_cast<int>(err);
  }
};

struct Launch {
  const Args* a;
  int batch, n_splits;
  cudaStream_t stream;
  template <typename T, int HD, int RT>
  int run() const {
    cudaError_t err = allow_smem<T, HD, RT>();
    if (err != cudaSuccess) return static_cast<int>(err);
    paged_split_kernel<T, HD, RT>
        <<<dim3(batch, a->kv_heads * a->rep_groups, n_splits), kThreads,
           split_smem<T, HD, RT>(), stream>>>(*a);
    err = cudaGetLastError();
    if (err != cudaSuccess || n_splits == 1) return static_cast<int>(err);
    paged_merge_kernel<T, HD><<<batch * a->heads, HD, 0, stream>>>(*a, n_splits);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, int HD, typename F>
int dispatch_rt(int rt, const F& f) {
  switch (rt) {
    case 1: return f.template run<T, HD, 1>();
    case 2: return f.template run<T, HD, 2>();
    case 4: return f.template run<T, HD, 4>();
    case 8: return f.template run<T, HD, 8>();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename F>
int dispatch_hd(int hd, int rt, const F& f) {
  switch (hd) {
    case 16: return dispatch_rt<T, 16>(rt, f);
    case 32: return dispatch_rt<T, 32>(rt, f);
    case 64: return dispatch_rt<T, 64>(rt, f);
    case 128: return dispatch_rt<T, 128>(rt, f);
    case 256: return dispatch_rt<T, 256>(rt, f);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename F>
int dispatch(int dtype, int hd, int rep, const F& f) {
  if (dtype == 0) return dispatch_hd<float>(hd, rep_tile(rep), f);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(hd, rep_tile(rep), f);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// For dtype (0 = float32, 1 = bfloat16), head size hd and rep query heads a
// KV head, on the current device: out[0] the tokens of a tile, out[1] the
// query-head groups a KV head is cut into (blocks of the grid's y per KV
// head), out[2] the split blocks an SM holds at once. Returns a CUDA error
// code (0 = success).
extern "C" int paged_attention_plan(int dtype, int hd, int rep, int* out) {
  if (rep <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int got[2] = {0, 0};
  const int rc = dispatch(dtype, hd, rep, Plan{got});
  const int rt = rep_tile(rep);
  out[0] = got[0];
  out[1] = (rep + rt - 1) / rt;
  out[2] = got[1];
  return rc;
}

// q (batch, heads, hd), out likewise; K and V with element strides (page,
// token, head) and the head dimension contiguous; all device pointers of
// one type: dtype 0 = float32, 1 = bfloat16. Paged: table (batch, ppseq)
// and lengths (batch) are contiguous device int32, pages of page_size
// tokens. Contiguous (table and lengths null): K and V are a cache
// (batch, S_max, KV, hd) whose batch stride is k_sp / v_sp, every sequence
// valid_len tokens long. Each block takes split_tokens consecutive
// positions; with n_splits > 1 (n_splits * split_tokens covering the
// positions), part holds batch * heads * n_splits * (hd + 2) float32 of
// scratch and a merge kernel follows. Launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int paged_attention_launch(
    const void* q, const void* k, const void* v, const void* table,
    const void* lengths, void* out, void* part, int dtype, int batch,
    int heads, int kv_heads, int hd, int page_size, int ppseq, int valid_len,
    int split_tokens, int n_splits, long long q_sb, long long q_sh,
    long long k_sp, long long k_st, long long k_sh, long long v_sp,
    long long v_st, long long v_sh, long long o_sb, long long o_sh,
    float sm_scale, void* stream) {
  if (batch <= 0 || heads <= 0) return static_cast<int>(cudaSuccess);
  const bool paged = table != nullptr;
  if (kv_heads <= 0 || heads % kv_heads != 0 || split_tokens <= 0 ||
      n_splits <= 0 || n_splits > 65535 || (n_splits > 1 && part == nullptr) ||
      paged != (lengths != nullptr) ||
      (paged && (page_size <= 0 || ppseq < 0)) || (!paged && valid_len < 0) ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long capacity =
      paged ? static_cast<long long>(ppseq) * page_size : valid_len;
  if (capacity > 2147483647LL ||
      static_cast<long long>(split_tokens) * n_splits < capacity) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rep = heads / kv_heads;
  const int rt = rep_tile(rep);
  const int rep_groups = (rep + rt - 1) / rt;
  if (static_cast<long long>(kv_heads) * rep_groups > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // cp.async needs 16-byte aligned K/V rows: pointers and strides
  const long long n = 16 / (dtype == 0 ? 4 : 2);
  const bool aligned = reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                       k_sp % n == 0 && k_st % n == 0 && k_sh % n == 0 &&
                       v_sp % n == 0 && v_st % n == 0 && v_sh % n == 0;
  Args a{q, k, v, static_cast<const int32_t*>(table),
         static_cast<const int32_t*>(lengths), out, static_cast<float*>(part),
         heads, kv_heads, rep_groups, page_size, ppseq, valid_len, split_tokens,
         q_sb, q_sh, k_sp, k_st, k_sh, v_sp, v_st, v_sh, o_sb, o_sh,
         sm_scale * kLog2e, aligned};
  return dispatch(dtype, hd, rep,
                  Launch{&a, batch, n_splits, static_cast<cudaStream_t>(stream)});
}
