// Blockwise (flash) attention for prefill on Hopper.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel; pallas_call at flash_attention.py:110). q (B, S, H,
// hd) attends over k, v (B, T, KV, hd); query head h reads KV head
// h / (H / KV) in place (grouped-query attention, no repeated K/V tensor).
// With causal masking the queries are right-aligned: query s sits at key
// position s + (T - S) and sees keys up to it. Keys past T are masked. The
// softmax runs online over key tiles in float32. A query row that sees no
// key at all (causal with S > T) gives zeros; ref.attention gives NaN there
// and the TPU kernel the mean of V over the padded tile.
//
// Bound: operations. 4 * B * H * hd * (query, key) pairs seen, about 69
// GFLOP a layer at Qwen3-1.7B's prefill of 4 x 2,048 tokens (16 heads of
// 128, causal), 0.07 ms at the tensor cores' 989 TFLOP/s, against about
// 101 MB of q, k, v and out in bfloat16 (0.030 ms at 3.35 TB/s).
//
// Design (the first, simple one; no tensor cores): one block of 256
// threads per (query tile of 64 rows, head, batch), heaviest causal tiles
// launched first. The block stages its query tile, pre-scaled by
// sm_scale * log2(e), in shared memory as float32, then walks the key tiles
// of 64 that its rows can see (causal tiles past the diagonal are skipped),
// staging K and V in shared memory. Each thread holds a 4 x 4 block of the
// score tile (rows ty*4.., keys tx + 16j) and a 4 x hd/16 block of the
// output accumulator in registers; float4 shared loads feed 16 FMAs each.
// Row maxima and sums go across the 16 threads of a row by warp shuffles;
// probabilities pass through shared memory into the P.V product. Loads and
// stores are in the working type (bfloat16 or float32), 16 bytes a thread;
// the arithmetic is float32 FMAs. hd is 16, 32, 64 or 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 64;        // keys a tile
constexpr int kLdP = kBK + 4;  // probability row stride in shared memory
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Dims {
  static constexpr int kLd = HD + 4;  // Q and K row stride (floats)
  static constexpr int kNC = HD / 16;  // output columns a thread
  static constexpr int kVec = kNC >= 4 ? 4 : kNC;
  static constexpr int kNG = kNC / kVec;
  static constexpr size_t kSmem =
      sizeof(float) * (static_cast<size_t>(kBQ) * kLd + kBK * kLd +
                       kBK * HD + kBQ * kLdP);
};

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

// 16 bytes of global memory as float32 values
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// Rows row0 .. row0 + 63 of a (rows x HD) operand whose row r starts at
// base + r * row_stride, into dst[r * ld + d] as float32 times `mul`; rows
// at or past `n_valid` (relative to row0) are zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* base,
                                          int64_t row_stride, int row0,
                                          int n_valid, float mul) {
  constexpr int N = Vec16<T>::N;
  constexpr int kPerRow = HD / N;
  for (int e = threadIdx.x; e < 64 * kPerRow; e += kThreads) {
    const int r = e / kPerRow;
    const int c = (e % kPerRow) * N;
    float vals[N];
    if (r < n_valid) {
      Vec16<T>::load(base + static_cast<int64_t>(row0 + r) * row_stride + c,
                     vals);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) vals[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      *reinterpret_cast<float4*>(dst + r * ld + c + i) =
          make_float4(vals[i] * mul, vals[i + 1] * mul, vals[i + 2] * mul,
                      vals[i + 3] * mul);
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int S, T, H, KV, causal;
  float scale_log2;  // sm_scale * log2(e)
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_kernel(Args a) {
  using D = Dims<HD>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                // [kBQ][kLd]
  float* ks = qs + kBQ * D::kLd;   // [kBK][kLd]
  float* vs = ks + kBK * D::kLd;   // [kBK][HD]
  float* ps = vs + kBK * HD;       // [kBQ][kLdP]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (a.H / a.KV);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int off = a.T - a.S;  // query s sits at key position s + off

  const T* qb = static_cast<const T*>(a.q) +
                (static_cast<int64_t>(b) * a.S * a.H + h) * HD;
  const T* kb = static_cast<const T*>(a.k) +
                (static_cast<int64_t>(b) * a.T * a.KV + g) * HD;
  const T* vb = static_cast<const T*>(a.v) +
                (static_cast<int64_t>(b) * a.T * a.KV + g) * HD;
  const int64_t kv_stride = static_cast<int64_t>(a.KV) * HD;
  load_tile<T, HD>(qs, D::kLd, qb, static_cast<int64_t>(a.H) * HD, q0,
                   a.S - q0, a.scale_log2);

  int kend = a.T;
  if (a.causal) kend = min(kend, q0 + kBQ + off);  // past the last row: masked
  const int n_tiles = kend > 0 ? (kend + kBK - 1) / kBK : 0;

  float m[4], l[4], acc[4][D::kNC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < D::kNC; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's reads of ks, vs and ps are done
    load_tile<T, HD>(ks, D::kLd, kb, kv_stride, k0, a.T - k0, 1.0f);
    load_tile<T, HD>(vs, HD, vb, kv_stride, k0, a.T - k0, 1.0f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * D::kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * D::kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(qv[i].x, kv[j].x, t);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          t = fmaf(qv[i].w, kv[j].w, t);
          s[i][j] = t;
        }
    }

    // mask, then fold the tile into the running max and sum of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i + off;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool ok = key < a.T && (!a.causal || key <= qpos);
        s[i][j] = ok ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      // a row with no visible key so far keeps p = 0 and its zeros
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float alpha = exp2f(m[i] - m_use);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - m_use);
        sum += p;
        ps[(ty * 4 + i) * kLdP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < D::kNC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * kLdP + kk];
#pragma unroll
      for (int gi = 0; gi < D::kNG; ++gi) {
        const float* vrow = vs + kk * HD + gi * 16 * D::kVec + tx * D::kVec;
        float vv[D::kVec];
        if constexpr (D::kVec == 4) {
          const float4 x = *reinterpret_cast<const float4*>(vrow);
          vv[0] = x.x;
          vv[1] = x.y;
          vv[2] = x.z;
          vv[3] = x.w;
        } else if constexpr (D::kVec == 2) {
          const float2 x = *reinterpret_cast<const float2*>(vrow);
          vv[0] = x.x;
          vv[1] = x.y;
        } else {
          vv[0] = vrow[0];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < D::kVec; ++c)
            acc[i][gi * D::kVec + c] = fmaf(p[i], vv[c], acc[i][gi * D::kVec + c]);
      }
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.S) continue;
    const float inv = l[i] > 0.0f ? 1.0f / l[i] : 0.0f;
    T* orow = out + ((static_cast<int64_t>(b) * a.S + row) * a.H + h) * HD;
#pragma unroll
    for (int gi = 0; gi < D::kNG; ++gi)
#pragma unroll
      for (int c = 0; c < D::kVec; ++c)
        orow[gi * 16 * D::kVec + tx * D::kVec + c] =
            from_f32<T>(acc[i][gi * D::kVec + c] * inv);
  }
}

template <typename T, int HD>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const size_t smem = Dims<HD>::kSmem;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.H, batch);
  flash_kernel<T, HD><<<grid, kThreads, smem, stream>>>(a);
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

// Shared memory a block needs for head size hd, in bytes (0: unsupported).
extern "C" long long flash_attention_smem_bytes(int hd) {
  switch (hd) {
    case 16: return static_cast<long long>(Dims<16>::kSmem);
    case 32: return static_cast<long long>(Dims<32>::kSmem);
    case 64: return static_cast<long long>(Dims<64>::kSmem);
    case 128: return static_cast<long long>(Dims<128>::kSmem);
    default: return 0;
  }
}

// q (batch, S, H, hd), k and v (batch, T, KV, hd), out like q: contiguous
// device arrays of one type, 16-byte aligned; dtype 0 = float32, 1 =
// bfloat16. Launches on `stream` and returns cudaGetLastError() as an int
// (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int dtype,
                                      int batch, int S, int T, int H, int KV,
                                      int hd, int causal, float sm_scale,
                                      void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || H % KV != 0 || T < 0 || H > 65535 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, out, S, T, H, KV, causal ? 1 : 0, sm_scale * kLog2e};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hd<float>(a, hd, batch, st);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(a, hd, batch, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
