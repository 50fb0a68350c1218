// RWKV6 (Finch) WKV recurrence on Hopper.
//
// Replaces the TPU kernel repro/kernels/rwkv6_chunk.py::wkv6_chunked (body
// _wkv_kernel; pallas_call at rwkv6_chunk.py:106). For each (batch, head)
// the hd x hd float32 state runs through the tokens in order:
//   o_t = r_t (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(w_t) S_{t-1} + k_t v_t^T
// and the final state is written out. The TPU kernel's chunked form, which
// divides by cumulative decays clamped at 1e-30 to feed its matrix unit, is
// not carried over: the sequential form here is exact in float32 for any
// decay. o_t is computed as r_t S_{t-1} + (r_t . (u * k_t)) v_t, the same
// sum in another order.
//
// Bound: operations, or rather their chain. Each (token, i, j) costs a
// multiply and two FMAs (5 flops), about 6.7 GFLOP a layer at RWKV6-3B's
// prefill of 4 x 2,048 tokens (40 heads of 64): 0.10 ms at the card's 67
// TFLOP/s of float32 outside the tensor cores, against about 252 MB of r,
// k, v (bf16), w (f32) and o (bf16), 0.075 ms at 3.35 TB/s. The tokens of
// one head are a dependent chain, so only B * H blocks run at once.
//
// Design: one block per (head, batch), hd * 4 threads. Thread (j, grp) holds
// column j of the state rows grp * hd/4 .. +hd/4 in registers (16 floats at
// hd 64). Tokens are staged 16 at a time in shared memory as float32: r, k
// and w of a (token, i) packed into one float4 (one broadcast load feeds a
// multiply and two FMAs), v, and r . (u * k) per token (a warp reduction).
// Each thread writes its partial r_t S_{t-1} column sum to shared memory;
// after the chunk the four partials, the bonus term and the cast to the
// working type go out as o. r, k, v and o are bfloat16 or float32, w and u
// float32, the state float32. hd is 16, 32, 64 or 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroups = 4;   // the state's rows split over 4 thread groups
constexpr int kChunk = 16;   // tokens staged a pass

template <int HD>
struct Dims {
  static constexpr int kThreads = HD * kGroups;
  static constexpr int kRows = HD / kGroups;  // state rows a thread holds
  static constexpr size_t kSmem =
      sizeof(float4) * kChunk * HD +                 // (r, k, w, -)
      sizeof(float) * (static_cast<size_t>(kChunk) * HD +   // v
                       static_cast<size_t>(kChunk) * kGroups * HD +  // partials
                       kChunk + HD);                 // r . (u k), u
};

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
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  void* o;
  float* state;
  int S, H;
};

template <typename T, int HD>
__global__ void __launch_bounds__(Dims<HD>::kThreads) wkv6_kernel(Args a) {
  using D = Dims<HD>;
  extern __shared__ __align__(16) float smem[];
  float4* rkw = reinterpret_cast<float4*>(smem);     // [kChunk][HD]
  float* vs = smem + 4 * kChunk * HD;                 // [kChunk][HD]
  float* part = vs + kChunk * HD;                     // [kChunk][kGroups][HD]
  float* rku = part + kChunk * kGroups * HD;          // [kChunk]
  float* us = rku + kChunk;                           // [HD]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int j = threadIdx.x % HD;
  const int grp = threadIdx.x / HD;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  constexpr int kWarps = D::kThreads / 32 > 0 ? D::kThreads / 32 : 1;

  const T* rp = static_cast<const T*>(a.r);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  T* op = static_cast<T*>(a.o);
  const int64_t tok_stride = static_cast<int64_t>(a.H) * HD;
  const int64_t base = static_cast<int64_t>(b) * a.S * tok_stride +
                       static_cast<int64_t>(h) * HD;

  if (threadIdx.x < HD) us[threadIdx.x] = a.u[h * HD + threadIdx.x];
  float st[D::kRows];
#pragma unroll
  for (int ii = 0; ii < D::kRows; ++ii) st[ii] = 0.0f;

  for (int t0 = 0; t0 < a.S; t0 += kChunk) {
    const int n = min(kChunk, a.S - t0);
    __syncthreads();  // the previous chunk's reads are done (and us is set)
    for (int e = threadIdx.x; e < n * HD; e += D::kThreads) {
      const int t = e / HD, i = e % HD;
      const int64_t at = base + static_cast<int64_t>(t0 + t) * tok_stride + i;
      rkw[e] = make_float4(to_f32(rp[at]), to_f32(kp[at]), a.w[at], 0.0f);
      vs[e] = to_f32(vp[at]);
    }
    __syncthreads();
    // r_t . (u * k_t) per token, one warp a token
    for (int t = warp; t < n; t += kWarps) {
      float x = 0.0f;
      for (int i = lane; i < HD; i += 32) {
        const float4 q = rkw[t * HD + i];
        x = fmaf(q.x, us[i] * q.y, x);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      if (lane == 0) rku[t] = x;
    }
    // the recurrence over this chunk's tokens, rows grp * kRows ..
    const float4* rows = rkw + grp * D::kRows;
    for (int t = 0; t < n; ++t) {
      const float vj = vs[t * HD + j];
      float o0 = 0.0f, o1 = 0.0f;
#pragma unroll
      for (int ii = 0; ii < D::kRows; ii += 2) {
        const float4 x0 = rows[t * HD + ii];
        const float4 x1 = rows[t * HD + ii + 1];
        o0 = fmaf(x0.x, st[ii], o0);
        o1 = fmaf(x1.x, st[ii + 1], o1);
        st[ii] = fmaf(x0.z, st[ii], x0.y * vj);
        st[ii + 1] = fmaf(x1.z, st[ii + 1], x1.y * vj);
      }
      part[(t * kGroups + grp) * HD + j] = o0 + o1;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < n * HD; e += D::kThreads) {
      const int t = e / HD, jj = e % HD;
      float o = rku[t] * vs[e];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) o += part[(t * kGroups + g) * HD + jj];
      op[base + static_cast<int64_t>(t0 + t) * tok_stride + jj] = from_f32<T>(o);
    }
  }
  float* sp = a.state + ((static_cast<int64_t>(b) * a.H + h) * HD +
                         grp * D::kRows) * HD + j;
#pragma unroll
  for (int ii = 0; ii < D::kRows; ++ii) sp[ii * HD] = st[ii];
}

template <typename T, int HD>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const size_t smem = Dims<HD>::kSmem;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  wkv6_kernel<T, HD><<<dim3(a.H, batch), Dims<HD>::kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const Args& a, int hd, int batch, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(a, batch, stream);
    case 32: return launch<T, 32>(a, batch, stream);
    case 64: return launch<T, 64>(a, batch, stream);
    case 128: return launch<T, 128>(a, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// r, k, v (batch, S, H, hd) of one type (dtype 0 = float32, 1 = bfloat16),
// w (batch, S, H, hd) float32, u (H, hd) float32, o like r, state (batch, H,
// hd, hd) float32: contiguous device arrays. Launches on `stream` and
// returns cudaGetLastError() as an int (0 = launched).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, void* o, void* state,
                           int dtype, int batch, int S, int H, int hd,
                           void* stream) {
  if (batch <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (S < 0 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{r, k, v, static_cast<const float*>(w),
               static_cast<const float*>(u), o, static_cast<float*>(state),
               S, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hd<float>(a, hd, batch, st);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(a, hd, batch, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
