// RWKV6 (Finch) WKV recurrence on Hopper.
//
// Replaces the TPU kernel repro/kernels/rwkv6_chunk.py::wkv6_chunked (body
// _wkv_kernel; pallas_call at rwkv6_chunk.py:106). For each (batch, head)
// the hd x hd float32 state runs through the tokens in order:
//   o_t = r_t (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(w_t) S_{t-1} + k_t v_t^T
// and the final state is written out. The TPU kernel's chunked form, which
// divides by cumulative decays clamped at 1e-30 to feed its matrix unit, is
// not carried over: the sequential form here is exact in float32 for any
// decay.
//
// Bound: operations. Each (token, i, j) costs a multiply and two FMAs (5
// flops), about 6.7 GFLOP a layer at RWKV6-3B's prefill of 4 x 2,048 tokens
// (40 heads of 64): 0.10 ms at the card's 67 TFLOP/s of float32 outside the
// tensor cores, against about 252 MB of r, k, v (bf16), w (f32) and o (bf16),
// 0.075 ms at 3.35 TB/s. The tokens of one (batch, head) are a dependent
// chain, but only through one FMA a state element: the columns of the state
// are independent (S[:, j] depends on v[:, j] alone), and so are its rows
// until o_t sums over them.
//
// Design: one block per (batch, head, column slice), `cols` columns a block;
// the wrapper picks the slice count (kernels/wkv6.py::wkv6_grid) so that
// every SM holds a few blocks. The rows of a state column are split over
// kGroups = 8 consecutive lanes of one warp, each holding kRows = hd / 8
// rows of kCols = 2 adjacent columns in registers. A lane adds r_i S_ij over
// its rows and (r_i u_i k_i) v_j once a column, so the bonus term
// (r_t . (u * k_t)) v_t rides in the same sum: 3 operations an element (a
// multiply and two FMAs) and 2 a row, shared by the lane's columns. o_t[j]
// is then a sum over the 8 lanes, taken by __shfl_xor_sync with no shared
// memory and no barrier: a lane keeps its shares of 8 tokens, and a
// reduce-scatter (recursive halving, 7 shuffles a column) leaves lane g
// with the whole o of the group's token g, which it writes. A group of 8
// tokens runs without a branch, so the tokens' independent work interleaves
// (only the state's one FMA a token is a chain). A lane's rows come in packs
// of kPack adjacent rows, pack q of lane g at row (8 q + g) kPack, so the 8
// lanes of a column read adjacent shared-memory words. Tokens are staged
// kChunk = 32 at a time by cp.async (16-byte pieces, raw bf16 or f32) into a
// double buffer: chunk c + 1 loads while chunk c runs, with one
// __syncthreads a chunk. Every slice reads r, k and w of the whole head
// (from L2 after the first) and v of its own columns. r, k, v and o are
// bfloat16 or float32, w and u float32, the state float32. hd is 16, 32, 64
// or 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;  // tokens staged a pass (a multiple of kGroups)
constexpr int kCols = 2;    // adjacent state columns a lane holds (even)
constexpr int kMaxThreads = 256;

template <int HD>
struct Lanes {
  static constexpr int kGroups = 8;  // lanes a column (kChunk is a multiple)
  static constexpr int kLogGroups = 3;
  static constexpr int kRows = HD / kGroups;           // state rows a lane
  static constexpr int kPack = kRows < 4 ? kRows : 4;  // adjacent rows a pack
  static constexpr int kPacks = kRows / kPack;
  static constexpr int kColsPerWarp = 32 / kGroups * kCols;
};

// kPack (2 or 4) adjacent values from shared memory, as float32
template <int N>
__device__ __forceinline__ void load_pack(const float* p, float* x) {
  if constexpr (N == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
  } else {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x, x[1] = f.y;
  }
}
// a bfloat16 pair as float32: a bf16 is the upper half of its float32
__device__ __forceinline__ float2 bf16x2_to_f32(uint32_t x) {
  return make_float2(__uint_as_float(x << 16), __uint_as_float(x & 0xffff0000u));
}
template <int N>
__device__ __forceinline__ void load_pack(const __nv_bfloat16* p, float* x) {
  if constexpr (N == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = bf16x2_to_f32(raw.x), b = bf16x2_to_f32(raw.y);
    x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
  } else {
    const float2 a = bf16x2_to_f32(*reinterpret_cast<const uint32_t*>(p));
    x[0] = a.x, x[1] = a.y;
  }
}

// two adjacent values of T
template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
  static __device__ __forceinline__ float2 get(type x) { return x; }
  static __device__ __forceinline__ type put(float a, float b) {
    return make_float2(a, b);
  }
};
template <>
struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ float2 get(type x) {
    return bf16x2_to_f32(*reinterpret_cast<const uint32_t*>(&x));
  }
  static __device__ __forceinline__ type put(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
};

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  void* o;
  float* state;
  int S, H, cols;
};

// bytes of one staging buffer: r, k [kChunk][HD] T, w [kChunk][HD] f32,
// v [kChunk][cols] T (all multiples of 16)
template <typename T, int HD>
__host__ __device__ constexpr size_t buffer_bytes(int cols) {
  return kChunk * (2 * HD * sizeof(T) + HD * sizeof(float) + cols * sizeof(T));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kMaxThreads)
wkv6_kernel(const __grid_constant__ Args a) {
  using L = Lanes<HD>;
  using P = Pair<T>;
  using V = typename P::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int cols = a.cols;
  const int slices = HD / cols;
  const int h = blockIdx.x / slices;
  const int j0 = (blockIdx.x % slices) * cols;
  const int b = blockIdx.y;
  const int grp = threadIdx.x % L::kGroups;  // row group: consecutive lanes
  const int jl = threadIdx.x / L::kGroups;   // column group within the slice
  const int row0 = grp * L::kPack;           // first row of pack 0
  const int threads = cols / kCols * L::kGroups;

  const size_t buf = buffer_bytes<T, HD>(cols);
  const char* rp = static_cast<const char*>(a.r);
  const char* kp = static_cast<const char*>(a.k);
  const char* vp = static_cast<const char*>(a.v);
  const char* wp = reinterpret_cast<const char*>(a.w);
  T* op = static_cast<T*>(a.o);
  const int64_t tok = static_cast<int64_t>(a.H) * HD;  // elements a token
  const int64_t base = static_cast<int64_t>(b) * a.S * tok +
                       static_cast<int64_t>(h) * HD;

  // tokens c * kChunk .. of this (batch, head) into buffer c & 1
  auto stage = [&](int c) {
    unsigned char* dst = smem + (c & 1) * buf;
    const int t0 = c * kChunk;
    const int n = min(kChunk, a.S - t0);
    constexpr int rk = HD * sizeof(T) / 16;  // pieces of a token's r or k
    constexpr int wq = HD * sizeof(float) / 16;
    const int vq = cols * static_cast<int>(sizeof(T)) / 16;
    unsigned char* kd = dst + kChunk * HD * sizeof(T);
    unsigned char* wd = dst + 2 * kChunk * HD * sizeof(T);
    unsigned char* vd = wd + kChunk * HD * sizeof(float);
    for (int e = threadIdx.x; e < n * rk; e += threads) {
      const int t = e / rk, q = e % rk;
      const int64_t at = (base + static_cast<int64_t>(t0 + t) * tok) * sizeof(T);
      cp16(dst + (t * HD) * sizeof(T) + 16 * q, rp + at + 16 * q);
      cp16(kd + (t * HD) * sizeof(T) + 16 * q, kp + at + 16 * q);
    }
    for (int e = threadIdx.x; e < n * wq; e += threads) {
      const int t = e / wq, q = e % wq;
      const int64_t at = (base + static_cast<int64_t>(t0 + t) * tok) * sizeof(float);
      cp16(wd + t * HD * sizeof(float) + 16 * q, wp + at + 16 * q);
    }
    for (int e = threadIdx.x; e < n * vq; e += threads) {
      const int t = e / vq, q = e % vq;
      const int64_t at = (base + static_cast<int64_t>(t0 + t) * tok + j0) * sizeof(T);
      cp16(vd + t * cols * sizeof(T) + 16 * q, vp + at + 16 * q);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  float uu[L::kRows], st[L::kRows][kCols];
#pragma unroll
  for (int q = 0; q < L::kPacks; ++q) {
#pragma unroll
    for (int e = 0; e < L::kPack; ++e) {
      const int i = q * L::kPack + e;
      uu[i] = a.u[h * HD + row0 + q * L::kGroups * L::kPack + e];
#pragma unroll
      for (int c = 0; c < kCols; ++c) st[i][c] = 0.0f;
    }
  }

  const int n_chunks = (a.S + kChunk - 1) / kChunk;
  if (n_chunks > 0) stage(0);
  for (int c = 0; c < n_chunks; ++c) {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    // chunk c is in for every thread, and every thread is done with chunk
    // c - 1, whose buffer may be refilled
    __syncthreads();
    if (c + 1 < n_chunks) stage(c + 1);

    const unsigned char* in = smem + (c & 1) * buf;
    const T* rs = reinterpret_cast<const T*>(in) + row0;
    const T* ks = reinterpret_cast<const T*>(in) + kChunk * HD + row0;
    const float* ws =
        reinterpret_cast<const float*>(in + 2 * kChunk * HD * sizeof(T)) + row0;
    const V* vs = reinterpret_cast<const V*>(in + 2 * kChunk * HD * sizeof(T) +
                                             kChunk * HD * sizeof(float)) +
                  jl * (kCols / 2);
    const int t0 = c * kChunk;
    const int n = min(kChunk, a.S - t0);
    // one token of the recurrence: this lane's share of o_t for its columns
    auto step = [&](int t, float (&o)[kCols]) {
      float r[L::kRows], k[L::kRows], w[L::kRows], v[kCols];
#pragma unroll
      for (int q = 0; q < L::kPacks; ++q) {
        const int at = t * HD + q * L::kGroups * L::kPack;
        load_pack<L::kPack>(rs + at, r + q * L::kPack);
        load_pack<L::kPack>(ks + at, k + q * L::kPack);
        load_pack<L::kPack>(ws + at, w + q * L::kPack);
      }
#pragma unroll
      for (int cc = 0; cc < kCols; cc += 2) {
        const float2 f = P::get(vs[t * (cols / 2) + cc / 2]);
        v[cc] = f.x;
        v[cc + 1] = f.y;
      }
      float rku = 0.0f;  // this lane's share of r_t . (u * k_t)
#pragma unroll
      for (int i = 0; i < L::kRows; ++i) rku = fmaf(r[i], uu[i] * k[i], rku);
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        float o0 = rku * v[cc], o1 = 0.0f;
#pragma unroll
        for (int i = 0; i < L::kRows; i += 2) {
          o0 = fmaf(r[i], st[i][cc], o0);
          o1 = fmaf(r[i + 1], st[i + 1][cc], o1);
          st[i][cc] = fmaf(w[i], st[i][cc], k[i] * v[cc]);
          st[i + 1][cc] = fmaf(w[i + 1], st[i + 1][cc], k[i + 1] * v[cc]);
        }
        o[cc] = o0 + o1;
      }
    };
    for (int tb = 0; tb < n; tb += L::kGroups) {
      // o shares of tokens tb .. tb + kGroups - 1; a whole group of tokens
      // runs without a branch, so the tokens' work interleaves
      float part[L::kGroups][kCols];
      if (tb + L::kGroups <= n) {
#pragma unroll
        for (int tt = 0; tt < L::kGroups; ++tt) step(tb + tt, part[tt]);
      } else {
#pragma unroll
        for (int tt = 0; tt < L::kGroups; ++tt) {
          if (tb + tt < n) {
            step(tb + tt, part[tt]);
          } else {
#pragma unroll
            for (int cc = 0; cc < kCols; ++cc) part[tt][cc] = 0.0f;
          }
        }
      }
      // reduce-scatter over the kGroups lanes of a column group (recursive
      // halving): each step swaps half of the live shares with the lane m
      // away, and the lane ends with the whole o of token tb + grp
#pragma unroll
      for (int s = 1; s <= L::kLogGroups; ++s) {
        const int m = L::kGroups >> s;
        const bool upper = grp & m;
#pragma unroll
        for (int i = 0; i < m; ++i) {
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) {
            const float send = upper ? part[i][cc] : part[i + m][cc];
            const float keep = upper ? part[i + m][cc] : part[i][cc];
            part[i][cc] = keep + __shfl_xor_sync(0xffffffffu, send, m);
          }
        }
      }
      if (tb + grp < n) {
        V* out = reinterpret_cast<V*>(
            op + base + static_cast<int64_t>(t0 + tb + grp) * tok + j0 +
            jl * kCols);
#pragma unroll
        for (int cc = 0; cc < kCols; cc += 2) {
          out[cc / 2] = P::put(part[0][cc], part[0][cc + 1]);
        }
      }
    }
  }
  float* sp = a.state + (static_cast<int64_t>(b) * a.H + h) * HD * HD + j0 +
              jl * kCols;
#pragma unroll
  for (int q = 0; q < L::kPacks; ++q) {
#pragma unroll
    for (int e = 0; e < L::kPack; ++e) {
      const int i = q * L::kPack + e;
      float2* row = reinterpret_cast<float2*>(
          sp + static_cast<int64_t>(row0 + q * L::kGroups * L::kPack + e) * HD);
#pragma unroll
      for (int cc = 0; cc < kCols; cc += 2) {
        row[cc / 2] = make_float2(st[i][cc], st[i][cc + 1]);
      }
    }
  }
}

template <typename T, int HD>
int launch(const Args& a, int batch, cudaStream_t stream) {
  using L = Lanes<HD>;
  const int cols = a.cols;
  const int threads = cols / kCols * L::kGroups;
  if (cols < 8 || HD % cols != 0 || cols % L::kColsPerWarp != 0 ||
      threads > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * buffer_bytes<T, HD>(cols);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned slices = static_cast<unsigned>(HD / cols);
  wkv6_kernel<T, HD><<<dim3(slices * a.H, batch), threads, smem, stream>>>(a);
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
// hd, hd) float32: contiguous device arrays, each 16-byte aligned. `cols` is
// the state columns a block takes (hd / cols slices a head): at least 8, a
// divisor of hd and a multiple of the columns a warp holds (32 / (8 or 16
// lanes a column group) * kCols), with cols / kCols * (8 or 16) <= 256
// threads. Launches on `stream` and returns cudaGetLastError() as an int (0 =
// launched).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, void* o, void* state,
                           int dtype, int batch, int S, int H, int hd,
                           int cols, void* stream) {
  if (batch <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (S < 0 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{r, k, v, static_cast<const float*>(w),
               static_cast<const float*>(u), o, static_cast<float*>(state),
               S, H, cols};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hd<float>(a, hd, batch, st);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(a, hd, batch, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
