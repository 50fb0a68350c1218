// One-token decode attention over a paged KV cache (Hopper).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::
// paged_decode_attention (body _paged_kernel; pallas_call at
// paged_attention.py:113). Sequence b attends with its H query heads over
// the pages page_table[b, 0..ppseq) of the K and V pools (-1 marks a hole),
// to the first lengths[b] token positions; query head h reads KV head
// h / (H / KV) (grouped-query attention). Softmax runs online across pages in
// float32. A sequence with no valid token returns zeros, as the reference
// ref.paged_decode_attention does (the TPU kernel would return the mean of
// the masked page's V there).
//
// Bound: bytes. Decode reads every valid token's K and V row once
// (2 * valid tokens * KV * hd elements) and does 4 * H * hd flops per valid
// token: about rep flops a byte in bf16, far below the 295 at which the
// tensor cores would be the limit, so the K/V bytes over 3.35 TB/s bound it.
//
// Design (the first, simple one): one block of 128 threads per (sequence,
// KV head), so its rep = H / KV query heads share each K/V page load. The
// block walks the sequence's pages in table order, skipping holes and
// positions >= length, and stages one page's K and V rows for its KV head in
// shared memory as float32 (K rows padded by one float against bank
// conflicts). Threads then compute the rep x page scores (one dot product of
// length hd each), rep threads fold them into the running max m and sum l,
// and the threads rescale and accumulate the rep x hd output in shared
// memory. Loads and stores are in the working type (bf16 or float32); no
// tensor cores. The pools are read through a page stride, a token stride and
// a head stride (the head dimension contiguous), so K and V of one layer group
// can be read straight out of a serving pool whose pages hold all groups.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
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

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* table;
  const int32_t* lengths;
  void* out;
  int heads, kv_heads, hd, page_size, ppseq;
  int64_t q_sb, q_sh;                // q strides: sequence, head
  int64_t k_sp, k_st, k_sh;          // K pool strides: page, token, head
  int64_t v_sp, v_st, v_sh;          // V pool strides
  int64_t o_sb, o_sh;                // out strides
  float sm_scale;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(Args a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int g = blockIdx.y;  // KV head
  const int rep = a.heads / a.kv_heads;
  const int hd = a.hd;
  const int ps = a.page_size;
  const int ldk = hd + 1;
  float* ks = smem;                // ps * ldk
  float* vs = ks + ps * ldk;       // ps * hd
  float* qs = vs + ps * hd;        // rep * hd
  float* acc = qs + rep * hd;      // rep * hd
  float* sc = acc + rep * hd;      // rep * ps: scores, then probabilities
  float* m = sc + rep * ps;        // rep
  float* l = m + rep;              // rep
  float* alpha = l + rep;          // rep

  const T* q = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  for (int i = threadIdx.x; i < rep * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    qs[i] = to_f32(q[b * a.q_sb + static_cast<int64_t>(g * rep + r) * a.q_sh + d]);
    acc[i] = 0.0f;
  }
  if (threadIdx.x < rep) {
    m[threadIdx.x] = -INFINITY;
    l[threadIdx.x] = 0.0f;
  }
  const int len = a.lengths[b];
  int n_pages = len > 0 ? (len + ps - 1) / ps : 0;
  if (n_pages > a.ppseq) n_pages = a.ppseq;
  for (int j = 0; j < n_pages; ++j) {
    const int page = a.table[static_cast<int64_t>(b) * a.ppseq + j];
    if (page < 0) continue;  // a hole: block-uniform
    const int valid = min(ps, len - j * ps);
    __syncthreads();  // the previous page's reads of ks, vs and sc are done
    const T* kpage = kp + page * a.k_sp + g * a.k_sh;
    const T* vpage = vp + page * a.v_sp + g * a.v_sh;
    for (int i = threadIdx.x; i < valid * hd; i += kThreads) {
      const int t = i / hd, d = i % hd;
      ks[t * ldk + d] = to_f32(kpage[t * a.k_st + d]);
      vs[t * hd + d] = to_f32(vpage[t * a.v_st + d]);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rep * valid; i += kThreads) {
      const int r = i / valid, t = i % valid;
      const float* qr = qs + r * hd;
      const float* kt = ks + t * ldk;
      float s = 0.0f;
      for (int d = 0; d < hd; ++d) s += qr[d] * kt[d];
      sc[r * ps + t] = s * a.sm_scale;
    }
    __syncthreads();
    if (threadIdx.x < rep) {
      const int r = threadIdx.x;
      float mx = m[r];
      for (int t = 0; t < valid; ++t) mx = fmaxf(mx, sc[r * ps + t]);
      const float al = expf(m[r] - mx);  // 0 while m is still -inf
      float sum = 0.0f;
      for (int t = 0; t < valid; ++t) {
        const float p = expf(sc[r * ps + t] - mx);
        sc[r * ps + t] = p;
        sum += p;
      }
      l[r] = l[r] * al + sum;
      m[r] = mx;
      alpha[r] = al;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rep * hd; i += kThreads) {
      const int r = i / hd, d = i % hd;
      float o = acc[i] * alpha[r];
      for (int t = 0; t < valid; ++t) o += sc[r * ps + t] * vs[t * hd + d];
      acc[i] = o;
    }
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out);
  for (int i = threadIdx.x; i < rep * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const float o = l[r] > 0.0f ? acc[i] / l[r] : 0.0f;
    out[b * a.o_sb + static_cast<int64_t>(g * rep + r) * a.o_sh + d] =
        from_f32<T>(o);
  }
}

size_t smem_bytes(int rep, int hd, int ps) {
  return sizeof(float) * (static_cast<size_t>(ps) * (hd + 1) +
                          static_cast<size_t>(ps) * hd + 2ull * rep * hd +
                          static_cast<size_t>(rep) * ps + 3ull * rep);
}

template <typename T>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.heads / a.kv_heads, a.hd, a.page_size);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  paged_decode_kernel<T><<<dim3(batch, a.kv_heads), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory the kernel needs, in bytes (the wrapper refuses shapes above
// the 227 KB a block may use).
extern "C" long long paged_attention_smem_bytes(int rep, int hd, int page_size) {
  return static_cast<long long>(smem_bytes(rep, hd, page_size));
}

// q (batch, heads, hd), out likewise, K and V pools with element strides
// (page, token, head) and the head dimension contiguous; all device pointers
// of one type: dtype 0 = float32, 1 = bfloat16. page_table (batch, ppseq) and
// lengths (batch) are contiguous device int32. Launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int paged_attention_launch(
    const void* q, const void* k, const void* v, const void* table,
    const void* lengths, void* out, int dtype, int batch, int heads,
    int kv_heads, int hd, int page_size, int ppseq, long long q_sb,
    long long q_sh, long long k_sp, long long k_st, long long k_sh,
    long long v_sp, long long v_st, long long v_sh, long long o_sb,
    long long o_sh, float sm_scale, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaSuccess);
  if (kv_heads <= 0 || heads % kv_heads != 0 || batch > 2147483647 ||
      kv_heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q, k, v, static_cast<const int32_t*>(table),
         static_cast<const int32_t*>(lengths), out, heads, kv_heads, hd,
         page_size, ppseq, q_sb, q_sh, k_sp, k_st, k_sh, v_sp, v_st, v_sh,
         o_sb, o_sh, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, batch, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, batch, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
