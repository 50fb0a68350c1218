// The backward of blockwise (flash) attention on Hopper.
//
// The JAX package has no backward kernel: jax.grad through its Pallas
// flash_attention raises, and repro/kernels/ops.py then differentiates the
// reference repro/kernels/ref.py:16 (ref.attention). This is the gradient of
// that same function, for the forward of csrc/flash_attention.cu: q (B, S, H,
// hd) over k, v (B, T, KV, hd), query head h reading KV head h / (H / KV),
// right-aligned causal mask, float32 softmax. Given dO it returns dQ, dK and
// dV, dK and dV summed over the query heads of each KV head's group. A row
// that sees no key has zero output and zero gradients.
//
// P is rebuilt from the scores and each row's log-sum-exp, which the forward
// writes when asked (lse, in log2 units): P = exp2(s * sm_scale * log2(e) -
// lse). With D_i = dO_i . O_i (over hd), dS = P * (dP - D), dP = dO V^T:
//   dV = P^T dO,  dK = sm_scale dS^T Q,  dQ = sm_scale dS K.
//
// Deterministic, with no floating-point atomics (a resumed run must repeat
// the same bits): two kernels, each owning what it writes.
// * flash_bwd_dq_kernel, one block per (query tile of 64 rows, head, batch),
//   first computes D for its rows (written out for the second kernel), then
//   walks the key tiles the rows can see and sums dQ.
// * flash_bwd_dkdv_kernel, one block per (key tile of 64 keys, KV head,
//   batch), walks every query tile that can see its keys, for every query
//   head of the group in order, and sums dK and dV.
// The score tile is recomputed in both (Q K^T twice): the price of having
// no atomics.
//
// Bound: operations. The function needs 10 flops per (query, key, hd) pair
// seen and head, 2.5 times the forward's 4 (the scores, dP, dV, dQ, dK):
// about 172 GFLOP a layer at Qwen3-1.7B's 4 x 2,048-token training step,
// 0.17 ms on the bf16 tensor cores. These kernels do 14 (the scores and dP
// in both).
//
// Design (a simple one that is right; making it fast is later work): both
// kernels run float32 FMAs on float32 tiles in shared memory, whatever the
// input type (bfloat16 inputs are widened once as they are staged), 256
// threads as 16 x 16, each holding a 4 x 4 block of the 64 x 64 score tile
// and a 4 x hd/16 block of the accumulated output rows, like the forward's
// float32 design (flash_fma_kernel). The tensor cores are not used. hd is
// 16, 32, 64 or 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;  // rows (queries or keys) of a tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLdP = kB + 4;  // row stride of the 64 x 64 P / dS tiles
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, S), log2 units, +inf for a row with no key
  float* delta;      // (B, H, S): D = dO . O, written by the dQ kernel
  void* dq;
  void* dk;
  void* dv;
  int S, T, H, KV, causal;
  float scale;       // sm_scale
  float scale_log2;  // sm_scale * log2(e)
};

template <int HD>
struct Dims {
  static constexpr int kLd = HD + 4;  // row stride of a staged tile (floats)
  static constexpr int kNC = HD / 16;  // output columns a thread
  static constexpr int kVec = kNC >= 4 ? 4 : kNC;
  static constexpr int kNG = kNC / kVec;
  static constexpr size_t kTile = static_cast<size_t>(kB) * kLd;
  // dQ: Q, dO, K, V tiles, the dS tile, lse and D of the rows
  static constexpr size_t kSmemDq =
      sizeof(float) * (4 * kTile + kB * kLdP + 2 * kB);
  // dK dV: K, V, Q, dO tiles, the P^T and dS^T tiles, lse and D
  static constexpr size_t kSmemDkdv =
      sizeof(float) * (4 * kTile + 2 * kB * kLdP + 2 * kB);
};

// four consecutive elements as float32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  // a bf16 is the upper half of its float32
  return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Rows row0 .. row0 + 63 of a (rows x HD) operand whose row r starts at
// base + r * row_stride, as float32 into dst[r * ld + d]; rows at or past
// n_valid (relative to row0) are zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* base,
                                          int64_t row_stride, int row0,
                                          int n_valid) {
  constexpr int kPerRow = HD / 4;
  for (int e = threadIdx.x; e < kB * kPerRow; e += kThreads) {
    const int r = e / kPerRow;
    const int c = (e % kPerRow) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < n_valid) x = load4(base + static_cast<int64_t>(row0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = x;
  }
}

// acc[i][*] += sum over 64 rows kk of w[(ty * 4 + i) * kLdP + kk] *
// x[kk * ld + this thread's columns]: the thread's 4 x kNC block of a
// (64 x 64) (64 x HD) product.
template <int HD>
__device__ __forceinline__ void accumulate(float (&acc)[4][Dims<HD>::kNC],
                                           const float* w, const float* x,
                                           int tx, int ty) {
  using D = Dims<HD>;
#pragma unroll 4
  for (int kk = 0; kk < kB; ++kk) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = w[(ty * 4 + i) * kLdP + kk];
#pragma unroll
    for (int gi = 0; gi < D::kNG; ++gi) {
      const float* row = x + kk * D::kLd + gi * 16 * D::kVec + tx * D::kVec;
      float xv[D::kVec];
      if constexpr (D::kVec == 4) {
        const float4 f = *reinterpret_cast<const float4*>(row);
        xv[0] = f.x, xv[1] = f.y, xv[2] = f.z, xv[3] = f.w;
      } else if constexpr (D::kVec == 2) {
        const float2 f = *reinterpret_cast<const float2*>(row);
        xv[0] = f.x, xv[1] = f.y;
      } else {
        xv[0] = row[0];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < D::kVec; ++c)
          acc[i][gi * D::kVec + c] = fmaf(p[i], xv[c], acc[i][gi * D::kVec + c]);
    }
  }
}

// s[i][j] = A[ty * 4 + i] . B[tx + 16 j] and t[i][j] = C[ty * 4 + i] .
// E[tx + 16 j] over HD, for row-major staged tiles of stride kLd.
template <int HD>
__device__ __forceinline__ void two_dots(float (&s)[4][4], float (&t)[4][4],
                                         const float* A, const float* B,
                                         const float* C, const float* E,
                                         int tx, int ty) {
  using D = Dims<HD>;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = t[i][j] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], b[4], c[4], e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(A + (ty * 4 + i) * D::kLd + d);
      c[i] = *reinterpret_cast<const float4*>(C + (ty * 4 + i) * D::kLd + d);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * D::kLd + d);
      e[j] = *reinterpret_cast<const float4*>(E + (tx + 16 * j) * D::kLd + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j], y = t[i][j];
        x = fmaf(a[i].x, b[j].x, x);
        x = fmaf(a[i].y, b[j].y, x);
        x = fmaf(a[i].z, b[j].z, x);
        x = fmaf(a[i].w, b[j].w, x);
        y = fmaf(c[i].x, e[j].x, y);
        y = fmaf(c[i].y, e[j].y, y);
        y = fmaf(c[i].z, e[j].z, y);
        y = fmaf(c[i].w, e[j].w, y);
        s[i][j] = x;
        t[i][j] = y;
      }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  using D = Dims<HD>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // [kB][kLd] Q rows
  float* dos = qs + D::kTile;  // [kB][kLd] dO rows
  float* ks = dos + D::kTile;  // [kB][kLd] K tile
  float* vs = ks + D::kTile;   // [kB][kLd] V tile
  float* dss = vs + D::kTile;  // [kB][kLdP] dS tile
  float* lse_s = dss + kB * kLdP;
  float* del_s = lse_s + kB;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (a.H / a.KV);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int off = a.T - a.S;  // query s sits at key position s + off
  const int64_t q_stride = static_cast<int64_t>(a.H) * HD;
  const int64_t kv_stride = static_cast<int64_t>(a.KV) * HD;
  const int64_t qoff = (static_cast<int64_t>(b) * a.S * a.H + h) * HD;
  const int64_t kvoff = (static_cast<int64_t>(b) * a.T * a.KV + g) * HD;
  const T* qb = static_cast<const T*>(a.q) + qoff;
  const T* ob = static_cast<const T*>(a.o) + qoff;
  const T* dob = static_cast<const T*>(a.dout) + qoff;
  const T* kb = static_cast<const T*>(a.k) + kvoff;
  const T* vb = static_cast<const T*>(a.v) + kvoff;
  const int64_t rowoff = (static_cast<int64_t>(b) * a.H + h) * a.S;

  load_tile<T, HD>(qs, D::kLd, qb, q_stride, q0, a.S - q0);
  load_tile<T, HD>(dos, D::kLd, dob, q_stride, q0, a.S - q0);
  // D = dO . O of each row, 4 threads a row (a quarter of hd each)
  {
    const int r = threadIdx.x / 4;
    const int part = threadIdx.x % 4;
    const int row = q0 + r;
    float sum = 0.0f;
    if (row < a.S) {
      const T* orow = ob + row * q_stride;
      const T* drow = dob + row * q_stride;
      for (int d = part * 4; d < HD; d += 16) {
        const float4 x = load4(orow + d);
        const float4 y = load4(drow + d);
        sum += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) {
      del_s[r] = sum;
      lse_s[r] = row < a.S ? a.lse[rowoff + row] : INFINITY;
      if (row < a.S) a.delta[rowoff + row] = sum;
    }
  }

  int kend = a.T;
  if (a.causal) kend = min(kend, q0 + kB + off);  // past the last row: masked
  const int n_tiles = kend > 0 ? (kend + kB - 1) / kB : 0;

  float acc[4][D::kNC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D::kNC; ++c) acc[i][c] = 0.0f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // the previous tile's reads of ks, vs and dss are done
    load_tile<T, HD>(ks, D::kLd, kb, kv_stride, k0, a.T - k0);
    load_tile<T, HD>(vs, D::kLd, vb, kv_stride, k0, a.T - k0);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_dots<HD>(s, dp, qs, ks, dos, vs, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qpos = q0 + r + off;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool ok = key < a.T && (!a.causal || key <= qpos);
        const float p = ok ? exp2f(s[i][j] * a.scale_log2 - lse_s[r]) : 0.0f;
        dss[r * kLdP + tx + 16 * j] = p * (dp[i][j] - del_s[r]);
      }
    }
    __syncthreads();
    accumulate<HD>(acc, dss, ks, tx, ty);
  }

  T* dq = static_cast<T*>(a.dq) + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.S) continue;
    T* drow = dq + row * q_stride;
#pragma unroll
    for (int gi = 0; gi < D::kNG; ++gi)
#pragma unroll
      for (int c = 0; c < D::kVec; ++c)
        store(drow + gi * 16 * D::kVec + tx * D::kVec + c,
              acc[i][gi * D::kVec + c] * a.scale);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(Args a) {
  using D = Dims<HD>;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;            // [kB][kLd] K tile (this block's keys)
  float* vs = ks + D::kTile;   // [kB][kLd] V tile
  float* qs = vs + D::kTile;   // [kB][kLd] Q rows
  float* dos = qs + D::kTile;  // [kB][kLd] dO rows
  float* pts = dos + D::kTile;  // [kB][kLdP] P^T: [key][query]
  float* dss = pts + kB * kLdP;  // [kB][kLdP] dS^T
  float* lse_s = dss + kB * kLdP;
  float* del_s = lse_s + kB;

  const int k0 = blockIdx.x * kB;  // the first key tiles see the most queries
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = a.H / a.KV;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int off = a.T - a.S;
  const int64_t q_stride = static_cast<int64_t>(a.H) * HD;
  const int64_t kv_stride = static_cast<int64_t>(a.KV) * HD;
  const int64_t kvoff = (static_cast<int64_t>(b) * a.T * a.KV + g) * HD;
  load_tile<T, HD>(ks, D::kLd, static_cast<const T*>(a.k) + kvoff, kv_stride, k0,
                   a.T - k0);
  load_tile<T, HD>(vs, D::kLd, static_cast<const T*>(a.v) + kvoff, kv_stride, k0,
                   a.T - k0);

  // queries s see key k0 when s + off >= k0
  const int first = a.causal ? max(0, k0 - off) / kB : 0;
  const int n_qtiles = (a.S + kB - 1) / kB;

  float dk[4][D::kNC], dv[4][D::kNC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D::kNC; ++c) dk[i][c] = dv[i][c] = 0.0f;

  for (int h = g * rep; h < (g + 1) * rep; ++h) {
    const int64_t qoff = (static_cast<int64_t>(b) * a.S * a.H + h) * HD;
    const int64_t rowoff = (static_cast<int64_t>(b) * a.H + h) * a.S;
    for (int qt = first; qt < n_qtiles; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();  // the previous tile's reads are done
      load_tile<T, HD>(qs, D::kLd, static_cast<const T*>(a.q) + qoff, q_stride, q0,
                       a.S - q0);
      load_tile<T, HD>(dos, D::kLd, static_cast<const T*>(a.dout) + qoff, q_stride,
                       q0, a.S - q0);
      if (threadIdx.x < kB) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < a.S ? a.lse[rowoff + row] : INFINITY;
        del_s[threadIdx.x] = row < a.S ? a.delta[rowoff + row] : 0.0f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];  // [key][query]
      two_dots<HD>(s, dp, ks, qs, vs, dos, tx, ty);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const int key = k0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const int qrow = q0 + c;
          const bool ok = key < a.T && qrow < a.S && (!a.causal || key <= qrow + off);
          const float p = ok ? exp2f(s[i][j] * a.scale_log2 - lse_s[c]) : 0.0f;
          pts[r * kLdP + c] = p;
          dss[r * kLdP + c] = p * (dp[i][j] - del_s[c]);
        }
      }
      __syncthreads();
      accumulate<HD>(dv, pts, dos, tx, ty);
      accumulate<HD>(dk, dss, qs, tx, ty);
    }
  }

  T* dkb = static_cast<T*>(a.dk) + kvoff;
  T* dvb = static_cast<T*>(a.dv) + kvoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= a.T) continue;
#pragma unroll
    for (int gi = 0; gi < D::kNG; ++gi)
#pragma unroll
      for (int c = 0; c < D::kVec; ++c) {
        const int col = gi * 16 * D::kVec + tx * D::kVec + c;
        store(dkb + key * kv_stride + col, dk[i][gi * D::kVec + c] * a.scale);
        store(dvb + key * kv_stride + col, dv[i][gi * D::kVec + c]);
      }
  }
}

template <typename T, int HD>
int launch(const Args& a, int batch, cudaStream_t stream) {
  using D = Dims<HD>;
  const void* fns[2] = {reinterpret_cast<const void*>(flash_bwd_dq_kernel<T, HD>),
                        reinterpret_cast<const void*>(flash_bwd_dkdv_kernel<T, HD>)};
  const size_t smem[2] = {D::kSmemDq, D::kSmemDkdv};
  for (int i = 0; i < 2; ++i) {
    if (smem[i] > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem[i]));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  // dQ first: it writes D, which the dK dV kernel reads (same stream)
  if (a.S > 0) {
    const dim3 gq((a.S + kB - 1) / kB, a.H, batch);
    flash_bwd_dq_kernel<T, HD><<<gq, kThreads, D::kSmemDq, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (a.T > 0) {
    const dim3 gk((a.T + kB - 1) / kB, a.KV, batch);
    flash_bwd_dkdv_kernel<T, HD><<<gk, kThreads, D::kSmemDkdv, stream>>>(a);
  }
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

// Shared memory the larger of the two kernels needs at head size hd, in
// bytes (0: unsupported).
extern "C" long long flash_attention_bwd_smem_bytes(int hd) {
  switch (hd) {
    case 16: return static_cast<long long>(Dims<16>::kSmemDkdv);
    case 32: return static_cast<long long>(Dims<32>::kSmemDkdv);
    case 64: return static_cast<long long>(Dims<64>::kSmemDkdv);
    case 128: return static_cast<long long>(Dims<128>::kSmemDkdv);
    default: return 0;
  }
}

// q, o, dout, dq (batch, S, H, hd); k, v, dk, dv (batch, T, KV, hd):
// contiguous device arrays of one type (dtype 0 = float32, 1 = bfloat16),
// 16-byte aligned (8 for bfloat16 rows); lse (batch, H, S) float32 from the
// forward (flash_attention_launch), delta (batch, H, S) float32 scratch.
// Every element of dq, dk and dv is written. Launches the two kernels on
// `stream` and returns cudaGetLastError() as an int (0 = launched).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout,
                                          const void* lse, void* delta, void* dq,
                                          void* dk, void* dv, int dtype, int batch,
                                          int S, int T, int H, int KV, int hd,
                                          int causal, float sm_scale, void* stream) {
  if (batch <= 0 || H <= 0 || (S <= 0 && T <= 0)) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || H % KV != 0 || S < 0 || T < 0 || H > 65535 || batch > 65535 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse),
               static_cast<float*>(delta), dq, dk, dv, S, T, H, KV, causal ? 1 : 0,
               sm_scale, sm_scale * kLog2e};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hd<float>(a, hd, batch, st);
  return launch_hd<__nv_bfloat16>(a, hd, batch, st);
}
