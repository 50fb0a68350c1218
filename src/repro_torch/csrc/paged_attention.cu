// One-token decode attention over a paged KV cache (Hopper).
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
// Bound: bytes. Decode reads every valid token's K and V row once
// (2 * valid tokens * KV * hd elements) and does 4 * H * hd flops per valid
// token: about rep flops a byte in bf16, far below the 295 at which the
// tensor cores would be the limit, so the K/V bytes over 3.35 TB/s bound it.
// At serving shapes that is a few microseconds, so what the design fights
// is latency: enough blocks in flight, every load issued up front.
//
// Design: split the page list, then merge by log-sum-exp.
// paged_split_kernel runs one block of 128 threads per (sequence, KV head,
// split); a split is a fixed run of pages_per_split pages of the table,
// chosen by the wrapper so that the grid fills the card. The block issues
// every load of its split at once, K and V rows of its KV head, 16 bytes a
// thread with cp.async into shared memory (zero-filled for holes; plain
// loads where a pool's pointers or strides are not 16-byte aligned), and
// meanwhile loads its rep = H / KV query rows into registers. A group of
// hd / 8 (bf16) or hd / 4 (float32) lanes takes a token row, each lane 16
// bytes of it, and computes the dot products with all rep query heads
// from registers, reduced by shuffles; the scores (times sm_scale *
// log2(e)) go to shared memory, -inf past the length and in holes. One
// warp per query head then takes the split's max m and sum l of
// exp2(score - m), and the threads form o = sum p v for every (head, d).
// With one split the block writes o / l straight to the output. With more,
// each split writes (m, l, o) in float32 to scratch, and paged_merge_kernel,
// launched right after by the same call, merges them: M = max m_s, out =
// sum exp2(m_s - M) o_s / sum exp2(m_s - M) l_s, in q's dtype. A split
// with no valid token has m = -inf and l = 0 and adds nothing; a sequence
// with none gives zeros. No tensor cores: the work is a few flops a byte.
// The pools are read through a page stride, a token stride and a head
// stride (the head dimension contiguous), so K and V of one layer group
// are read straight out of a serving pool whose pages hold all groups.
// hd is 16, 32, 64, 128 or 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRepTile = 4;  // query heads held in registers at a time
constexpr float kLog2e = 1.4426950408889634f;
// shared memory a split block may stage (K, V, scores); the wrapper sizes
// pages_per_split under it
constexpr int kSmemBudget = 64 * 1024;

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

// two consecutive elements as float32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* table;
  const int32_t* lengths;
  void* out;
  float* part;  // (batch, heads, n_splits) x (hd + 2) floats: o, then m, l
  int heads, kv_heads, page_size, ppseq, pps;
  int64_t q_sb, q_sh;                // q strides: sequence, head
  int64_t k_sp, k_st, k_sh;          // K pool strides: page, token, head
  int64_t v_sp, v_st, v_sh;          // V pool strides
  int64_t o_sb, o_sh;                // out strides
  float scale_log2;                  // sm_scale * log2(e)
};

size_t split_smem(int elem, int rep, int hd, int rows) {
  return static_cast<size_t>(rows) * (2ull * hd * elem + 4ull * rep) +
         8ull * rep;
}

template <typename T, int HD, bool kAsync>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(Args a) {
  constexpr int N = 16 / sizeof(T);   // elements in 16 bytes
  constexpr int C = HD / N;           // 16-byte chunks a row
  constexpr int L = C < 32 ? C : 32;  // lanes a token row
  constexpr int NCH = C / L;          // chunks a lane
  constexpr int G = kThreads / L;     // token rows at a time
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ps = a.page_size;
  const int rows_cap = a.pps * ps;
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + static_cast<size_t>(rows_cap) * HD;
  float* sc = reinterpret_cast<float*>(vs + static_cast<size_t>(rows_cap) * HD);
  const int rep = a.heads / a.kv_heads;
  float* stat = sc + rep * rows_cap;  // m[rep], then l[rep]

  const int b = blockIdx.x;
  const int g = blockIdx.y;  // KV head
  const int split = blockIdx.z;
  const int pos0 = split * rows_cap;  // first token position of the split
  const int len = min(a.lengths[b], a.ppseq * ps);
  const int n_rows = max(0, min(rows_cap, len - pos0));
  const int32_t* trow =
      a.table + static_cast<int64_t>(b) * a.ppseq + split * a.pps;
  const T* kp = static_cast<const T*>(a.k) + g * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + g * a.v_sh;

  // 1. every K and V load of the split, at once
  for (int e = threadIdx.x; e < n_rows * C; e += kThreads) {
    const int t = e / C;
    const int c = e % C;
    const int page = trow[t / ps];
    const bool ok = page >= 0;
    const int64_t ko = ok ? page * a.k_sp + (t % ps) * a.k_st + c * N : 0;
    const int64_t vo = ok ? page * a.v_sp + (t % ps) * a.v_st + c * N : 0;
    T* kd = ks + t * HD + c * N;
    T* vd = vs + t * HD + c * N;
    if constexpr (kAsync) {
      cp_async16(kd, kp + ko, ok ? 16 : 0);
      cp_async16(vd, vp + vo, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        kd[i] = ok ? kp[ko + i] : from_f32<T>(0.0f);
        vd[i] = ok ? vp[vo + i] : from_f32<T>(0.0f);
      }
    }
  }
  if constexpr (kAsync) asm volatile("cp.async.commit_group;\n" ::: "memory");

  // 2. scores: a group of L lanes per token row, all query heads of the KV
  // head from registers, kRepTile at a time
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb;
  const int grp = threadIdx.x / L;
  const int li = threadIdx.x % L;
  for (int r0 = 0; r0 < rep; r0 += kRepTile) {
    float qr[kRepTile][NCH * N];
#pragma unroll
    for (int i = 0; i < kRepTile; ++i) {
      const bool ok = r0 + i < rep;
      const T* qh = q + static_cast<int64_t>(g * rep + r0 + i) * a.q_sh;
#pragma unroll
      for (int cc = 0; cc < NCH; ++cc)
#pragma unroll
        for (int j = 0; j < N; ++j)
          qr[i][cc * N + j] = ok ? to_f32(qh[(cc * L + li) * N + j]) : 0.0f;
    }
    if (r0 == 0) {  // the first query heads loaded while K and V flew
      if constexpr (kAsync) asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
    }
    for (int tb = 0; tb < n_rows; tb += G) {  // uniform across the block
      const int t = tb + grp;
      const bool ok = t < n_rows;
      float part[kRepTile];
#pragma unroll
      for (int i = 0; i < kRepTile; ++i) part[i] = 0.0f;
      if (ok) {
#pragma unroll
        for (int cc = 0; cc < NCH; ++cc) {
          float kf[N];
          load16(ks + t * HD + (cc * L + li) * N, kf);
#pragma unroll
          for (int i = 0; i < kRepTile; ++i)
#pragma unroll
            for (int j = 0; j < N; ++j)
              part[i] = fmaf(qr[i][cc * N + j], kf[j], part[i]);
        }
      }
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < kRepTile; ++i)
          part[i] += __shfl_xor_sync(0xffffffffu, part[i], o);
      if (ok && li == 0) {
        const bool valid = trow[t / ps] >= 0;
#pragma unroll
        for (int i = 0; i < kRepTile; ++i)
          if (r0 + i < rep)
            sc[(r0 + i) * rows_cap + t] =
                valid ? part[i] * a.scale_log2 : -INFINITY;
      }
    }
  }
  __syncthreads();

  // 3. the split's softmax: one warp per query head
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < rep; r += kWarps) {
    float* s = sc + r * rows_cap;
    float mx = -INFINITY;
    for (int t = lane; t < n_rows; t += 32) mx = fmaxf(mx, s[t]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_use = mx == -INFINITY ? 0.0f : mx;  // no valid token: p = 0
    float sum = 0.0f;
    for (int t = lane; t < n_rows; t += 32) {
      const float p = exp2f(s[t] - m_use);
      s[t] = p;
      sum += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      stat[r] = mx;
      stat[rep + r] = sum;
    }
  }
  __syncthreads();

  // 4. o = sum_t p v for two columns a thread; one split: out = o / l, else
  // the partials (o, m, l)
  constexpr int HP = HD / 2;
  const int n_splits = gridDim.z;
  for (int i = threadIdx.x; i < rep * HP; i += kThreads) {
    const int r = i / HP;
    const int d = (i % HP) * 2;
    const float* p = sc + r * rows_cap;
    float o0 = 0.0f, o1 = 0.0f;
    for (int t = 0; t < n_rows; ++t) {
      const float2 vv = load2(vs + t * HD + d);
      o0 = fmaf(p[t], vv.x, o0);
      o1 = fmaf(p[t], vv.y, o1);
    }
    const int h = g * rep + r;
    if (n_splits == 1) {
      const float l = stat[rep + r];
      const float inv = l > 0.0f ? 1.0f / l : 0.0f;
      T* out = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh + d;
      out[0] = from_f32<T>(o0 * inv);
      out[1] = from_f32<T>(o1 * inv);
    } else {
      float* part = a.part + ((static_cast<int64_t>(b) * a.heads + h) * n_splits +
                              split) * (HD + 2);
      part[d] = o0;
      part[d + 1] = o1;
      if (d == 0) {
        part[HD] = stat[r];
        part[HD + 1] = stat[rep + r];
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

template <typename T, int HD, bool kAsync>
int launch_split(const Args& a, int batch, int n_splits, size_t smem,
                 cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_split_kernel<T, HD, kAsync>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  paged_split_kernel<T, HD, kAsync>
      <<<dim3(batch, a.kv_heads, n_splits), kThreads, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return static_cast<int>(err);
  paged_merge_kernel<T, HD><<<batch * a.heads, HD, 0, stream>>>(a, n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_hd(const Args& a, int batch, int n_splits, size_t smem,
              bool aligned, cudaStream_t stream) {
  return aligned ? launch_split<T, HD, true>(a, batch, n_splits, smem, stream)
                 : launch_split<T, HD, false>(a, batch, n_splits, smem, stream);
}

template <typename T>
int launch(const Args& a, int hd, int batch, int n_splits, size_t smem,
           bool aligned, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_hd<T, 16>(a, batch, n_splits, smem, aligned, stream);
    case 32: return launch_hd<T, 32>(a, batch, n_splits, smem, aligned, stream);
    case 64: return launch_hd<T, 64>(a, batch, n_splits, smem, aligned, stream);
    case 128: return launch_hd<T, 128>(a, batch, n_splits, smem, aligned, stream);
    case 256: return launch_hd<T, 256>(a, batch, n_splits, smem, aligned, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The most token rows (pages_per_split * page_size) a split block may stage
// for dtype (0 = float32, 1 = bfloat16), rep query heads a KV head and head
// size hd.
extern "C" int paged_attention_max_rows(int dtype, int rep, int hd) {
  const int elem = dtype == 0 ? 4 : 2;
  const size_t per_row = split_smem(elem, rep, hd, 1) - split_smem(elem, rep, hd, 0);
  const size_t fixed = split_smem(elem, rep, hd, 0);
  if (fixed >= static_cast<size_t>(kSmemBudget)) return 0;
  return static_cast<int>((kSmemBudget - fixed) / per_row);
}

// q (batch, heads, hd), out likewise, K and V pools with element strides
// (page, token, head) and the head dimension contiguous; all device pointers
// of one type: dtype 0 = float32, 1 = bfloat16. page_table (batch, ppseq) and
// lengths (batch) are contiguous device int32. Each block takes
// pages_per_split pages of the table; with n_splits = ceil(ppseq /
// pages_per_split) > 1, part holds batch * heads * n_splits * (hd + 2)
// float32 of scratch and a merge kernel follows. Launches on `stream` and
// returns cudaGetLastError() as an int (0 = launched).
extern "C" int paged_attention_launch(
    const void* q, const void* k, const void* v, const void* table,
    const void* lengths, void* out, void* part, int dtype, int batch,
    int heads, int kv_heads, int hd, int page_size, int ppseq,
    int pages_per_split, long long q_sb, long long q_sh, long long k_sp,
    long long k_st, long long k_sh, long long v_sp, long long v_st,
    long long v_sh, long long o_sb, long long o_sh, float sm_scale,
    void* stream) {
  if (batch <= 0 || heads <= 0) return static_cast<int>(cudaSuccess);
  if (kv_heads <= 0 || heads % kv_heads != 0 || batch > 2147483647 ||
      kv_heads > 65535 || pages_per_split <= 0 || page_size <= 0 ||
      ppseq < 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_splits =
      ppseq > 0 ? (ppseq + pages_per_split - 1) / pages_per_split : 1;
  if (n_splits > 65535 || (n_splits > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rep = heads / kv_heads;
  const int elem = dtype == 0 ? 4 : 2;
  const size_t smem = split_smem(elem, rep, hd, pages_per_split * page_size);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  // cp.async needs 16-byte aligned K/V rows: pointers and strides
  const long long n = 16 / elem;
  const bool aligned = reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                       k_sp % n == 0 && k_st % n == 0 && k_sh % n == 0 &&
                       v_sp % n == 0 && v_st % n == 0 && v_sh % n == 0;
  Args a{q, k, v, static_cast<const int32_t*>(table),
         static_cast<const int32_t*>(lengths), out, static_cast<float*>(part),
         heads, kv_heads, page_size, ppseq, pages_per_split, q_sb, q_sh, k_sp,
         k_st, k_sh, v_sp, v_st, v_sh, o_sb, o_sh, sm_scale * kLog2e};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, hd, batch, n_splits, smem, aligned, st);
  return launch<__nv_bfloat16>(a, hd, batch, n_splits, smem, aligned, st);
}
