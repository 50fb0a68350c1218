// The backward of blockwise (flash) attention on Hopper.
//
// Replaces jax.grad of repro/kernels/ref.py:16 (ref.attention): the JAX
// package has no backward kernel (jax.grad through its Pallas
// flash_attention raises, and repro/kernels/ops.py then differentiates the
// reference). This is the gradient of that same function, for the forward
// of csrc/flash_attention.cu: q (B, S, H, hd) over k, v (B, T, KV, hd),
// query head h reading KV head h / (H / KV), right-aligned causal mask,
// float32 softmax. Given dO it returns dQ, dK and dV, dK and dV summed over
// the query heads of each KV head's group. A row that sees no key has zero
// output and zero gradients.
//
// P is rebuilt from the scores and each row's log-sum-exp, which the forward
// writes when asked (lse, in log2 units): P = exp2(s * sm_scale * log2(e) -
// lse). With D_i = dO_i . O_i (over hd), dS = P * (dP - D), dP = dO V^T:
//   dV = P^T dO,  dK = sm_scale dS^T Q,  dQ = sm_scale dS K.
//
// Deterministic, with no floating-point atomics (a resumed run must repeat
// the same bits): two kernels, each owning what it writes, launched in this
// order on one stream.
// * The dQ kernel, one block per (query tile, head, batch), heaviest causal
//   tiles first, first computes D for its rows (written out for the second
//   kernel), then walks the key tiles its rows can see and sums dQ.
// * The dK dV kernel, one block per (key tile, KV head, batch), the first
//   key tiles (which see the most queries) first, walks every query tile
//   that can see its keys, for every query head of the group in a fixed
//   order, and sums dK and dV.
// The scores and dP are computed in both (the price of having no atomics).
//
// Bound: operations. The function needs 10 flops per (query, key, hd) pair
// seen and head, 2.5 times the forward's 4 (the scores, dP, dV, dQ, dK):
// about 172 GFLOP a layer at Qwen3-1.7B's 4 x 2,048-token training step,
// 0.17 ms on the bf16 tensor cores (989 TFLOP/s). These kernels do 14.
//
// Two designs, chosen by dtype (a dispatch, not a fallback: each dtype has
// exactly one pair of kernels, as in csrc/flash_attention.cu):
//
// bfloat16 (flash_bwd_dq_mma_kernel, flash_bwd_dkdv_mma_kernel; training's
// path): every product on the tensor cores as mma.sync.m16n8k16 bf16 in,
// float32 accumulate, with the forward's fragments (its helpers are copied
// below). Each warp owns 16 rows of the block's tile: query rows in the dQ
// kernel, keys in the dK dV kernel, kDqWarps and kDkdvWarps = 4 warps (64
// rows) a block. The other operand streams in tiles of kTile = 64 rows (K
// and V in the dQ kernel; Q, dO and the rows' lse and D in the dK dV
// kernel) by cp.async into a ring of 2 stages, tile t + 1 in flight while t
// computes, XOR-swizzled so that ldmatrix and ldmatrix.trans read 8 rows
// from 8 bank groups. 8 warps and 128-row tiles timed no faster on an H100
// (tools/flash_bwd_variants.py, which rewrites these constants in a copy).
// * dQ: S = Q K^T and dP = dO V^T (Q and dO fragments by ldmatrix from the
//   block's own rows, K and V as B operands by ldmatrix), kKeySub = 64 keys
//   of a tile at a time, P and dS made in registers, dS rounded to bf16 and
//   fed straight into dQ += dS K as the A operand (a C fragment has an A
//   fragment's layout), K by ldmatrix.trans, exactly as the forward's O +=
//   P V.
// * dK dV: S^T = K Q^T and dP^T = V dO^T, so that the accumulators are laid
//   out [key][query]; P^T and dS^T are made in registers (each query's lse
//   and D read from the stage), rounded to bf16 and fed as A operands of
//   dV += P^T dO and dK += dS^T Q, with dO and Q by ldmatrix.trans. Half a
//   query tile (32 queries) at a time, so that dK and dV's 2 x hd / 2
//   floats a thread (128 at hd 128) and the score fragments fit in
//   registers; K and V fragments are reloaded from shared memory.
// P and dS never touch shared memory; at hd 128 the dK dV kernel holds 255
// registers a thread (dK and dV alone are 128), so 2 blocks of 4 warps
// share an SM. Only diagonal and ragged tiles are masked; a warp whose rows
// see none of a tile skips it. Outputs go through the warp's own rows of
// the Q (dQ) or K and V (dK dV) tiles to 16-byte stores.
//
// float32 (flash_bwd_dq_fma_kernel, flash_bwd_dkdv_fma_kernel): float32
// FMAs on float32 tiles in shared memory, 256 threads as 16 x 16 each
// holding a 4 x 4 block of the 64 x 64 score tile and a 4 x hd/16 block of
// the accumulated rows, like the forward's float32 design. Kept for float32
// because TF32 would not hold the float32 checks (1e-4 of each gradient's
// scale, 1e-3 between CPU and card).
//
// hd is 16, 32, 64 or 128 in both designs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

// ---------------------------------------------------------------- float32

constexpr int kB = 64;         // rows (queries or keys) of a tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLdP = kB + 4;   // row stride of the 64 x 64 P / dS tiles

template <int HD>
struct FmaDims {
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

// Rows row0 .. row0 + 63 of a (rows x HD) operand whose row r starts at
// base + r * row_stride into dst[r * ld + d]; rows at or past n_valid
// (relative to row0) are zeros.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* base,
                                          int64_t row_stride, int row0,
                                          int n_valid) {
  constexpr int kPerRow = HD / 4;
  for (int e = threadIdx.x; e < kB * kPerRow; e += kThreads) {
    const int r = e / kPerRow;
    const int c = (e % kPerRow) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < n_valid) {
      x = *reinterpret_cast<const float4*>(base + static_cast<int64_t>(row0 + r) * row_stride + c);
    }
    *reinterpret_cast<float4*>(dst + r * ld + c) = x;
  }
}

// acc[i][*] += sum over 64 rows kk of w[(ty * 4 + i) * kLdP + kk] *
// x[kk * ld + this thread's columns]: the thread's 4 x kNC block of a
// (64 x 64) (64 x HD) product.
template <int HD>
__device__ __forceinline__ void accumulate(float (&acc)[4][FmaDims<HD>::kNC],
                                           const float* w, const float* x,
                                           int tx, int ty) {
  using D = FmaDims<HD>;
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
  using D = FmaDims<HD>;
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

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_fma_kernel(Args a) {
  using D = FmaDims<HD>;
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
  const float* qb = static_cast<const float*>(a.q) + qoff;
  const float* ob = static_cast<const float*>(a.o) + qoff;
  const float* dob = static_cast<const float*>(a.dout) + qoff;
  const float* kb = static_cast<const float*>(a.k) + kvoff;
  const float* vb = static_cast<const float*>(a.v) + kvoff;
  const int64_t rowoff = (static_cast<int64_t>(b) * a.H + h) * a.S;

  load_tile<HD>(qs, D::kLd, qb, q_stride, q0, a.S - q0);
  load_tile<HD>(dos, D::kLd, dob, q_stride, q0, a.S - q0);
  // D = dO . O of each row, 4 threads a row (a quarter of hd each)
  {
    const int r = threadIdx.x / 4;
    const int part = threadIdx.x % 4;
    const int row = q0 + r;
    float sum = 0.0f;
    if (row < a.S) {
      const float* orow = ob + row * q_stride;
      const float* drow = dob + row * q_stride;
      for (int d = part * 4; d < HD; d += 16) {
        const float4 x = *reinterpret_cast<const float4*>(orow + d);
        const float4 y = *reinterpret_cast<const float4*>(drow + d);
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
    load_tile<HD>(ks, D::kLd, kb, kv_stride, k0, a.T - k0);
    load_tile<HD>(vs, D::kLd, vb, kv_stride, k0, a.T - k0);
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

  float* dq = static_cast<float*>(a.dq) + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.S) continue;
    float* drow = dq + row * q_stride;
#pragma unroll
    for (int gi = 0; gi < D::kNG; ++gi)
#pragma unroll
      for (int c = 0; c < D::kVec; ++c)
        drow[gi * 16 * D::kVec + tx * D::kVec + c] = acc[i][gi * D::kVec + c] * a.scale;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_fma_kernel(Args a) {
  using D = FmaDims<HD>;
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
  load_tile<HD>(ks, D::kLd, static_cast<const float*>(a.k) + kvoff, kv_stride, k0,
                a.T - k0);
  load_tile<HD>(vs, D::kLd, static_cast<const float*>(a.v) + kvoff, kv_stride, k0,
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
      load_tile<HD>(qs, D::kLd, static_cast<const float*>(a.q) + qoff, q_stride, q0,
                    a.S - q0);
      load_tile<HD>(dos, D::kLd, static_cast<const float*>(a.dout) + qoff, q_stride,
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

  float* dkb = static_cast<float*>(a.dk) + kvoff;
  float* dvb = static_cast<float*>(a.dv) + kvoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= a.T) continue;
#pragma unroll
    for (int gi = 0; gi < D::kNG; ++gi)
#pragma unroll
      for (int c = 0; c < D::kVec; ++c) {
        const int col = gi * 16 * D::kVec + tx * D::kVec + c;
        dkb[key * kv_stride + col] = dk[i][gi * D::kVec + c] * a.scale;
        dvb[key * kv_stride + col] = dv[i][gi * D::kVec + c];
      }
  }
}

// --------------------------------------------------------------- bfloat16

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;   // rows of a streamed tile (keys in dQ, queries in dK dV)
constexpr int kStages = 2;  // ring depth
constexpr int kSub = 32;    // queries a dK dV step (half a streamed tile)
constexpr int kKeySub = 64;  // keys a dQ step (kTile / kKeySub steps a tile)
// warps a block, 16 owned rows a warp: 4 and 8 timed within 2.5% of each
// other on an H100 (PERF.md, PR 23)
constexpr int kDqWarps = 4;
constexpr int kDkdvWarps = 4;

template <int HD, int WARPS>
struct MmaDims {
  static constexpr int kThreads = 32 * WARPS;
  static constexpr int kChunks = HD / 8;  // 16-byte chunks a row
  static constexpr int kOwn = 16 * WARPS;  // rows the block owns, 16 a warp
  static constexpr size_t kOwnBytes = sizeof(bf16) * kOwn * HD;
  static constexpr size_t kTileBytes = sizeof(bf16) * kTile * HD;
  // two operands' own rows, then kStages x two streamed tiles
  static constexpr size_t kSmemDq = 2 * kOwnBytes + kStages * 2 * kTileBytes;
  // ... and each stage's lse and D of its 64 query rows
  static constexpr size_t kSmemDkdv = kSmemDq + kStages * 2 * kTile * sizeof(float);
};

// Chunk index of 16-byte chunk c of row r in a tile of rows of C chunks:
// csrc/flash_attention.cu's swizzle. The XOR spreads the 8 rows that one
// ldmatrix phase reads at the same logical chunk over 8 distinct bank
// groups: for C >= 8 chunk c ^ (r % 8); for C = 4 c ^ ((r / 2) % 4); for
// C = 2, c ^ ((r / 4) % 2).
template <int C>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int kDiv = C >= 8 ? 1 : 8 / C;
  constexpr int kMod = C >= 8 ? 8 : C;
  return r * C + (c ^ ((r / kDiv) % kMod));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared; src_bytes 0 writes a zero
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a * b on the tensor cores: a 16 x 16 (row), b 16 x 8 (col), bf16
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// The A fragment of 16 rows x 16 columns (two 8-column C fragments of the
// same 16 rows, f[0] the left and f[1] the right), rounded to bf16.
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4], const float (&l)[4],
                                         const float (&r)[4]) {
  a[0] = pack_bf16(l[0], l[1]);  // row gr, columns 2 tq, 2 tq + 1
  a[1] = pack_bf16(l[2], l[3]);  // row gr + 8
  a[2] = pack_bf16(r[0], r[1]);  // row gr, columns 8 + 2 tq ..
  a[3] = pack_bf16(r[2], r[3]);
}

// sum over 8 bfloat16 pairs (16 bytes each) of x * y, as float32
__device__ __forceinline__ float dot8(uint4 x, uint4 y) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
  const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the upper half of its float32
    s = fmaf(__uint_as_float(xs[i] << 16), __uint_as_float(ys[i] << 16), s);
    s = fmaf(__uint_as_float(xs[i] & 0xffff0000u), __uint_as_float(ys[i] & 0xffff0000u), s);
  }
  return s;
}

// ROWS rows from row0 of a (rows x HD) bf16 operand whose row r starts at
// base + r * row_stride into a swizzled shared tile with cp.async; rows at
// or past n_valid (relative to row0) are zero-filled.
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* base, int64_t row_stride,
                                                int row0, int n_valid) {
  constexpr int C = HD / 8;
  const uint32_t d0 = smem_addr(dst);
  for (int e = threadIdx.x; e < ROWS * C; e += THREADS) {
    const int r = e / C;
    const int c = e % C;
    const bool ok = r < n_valid;
    const bf16* src = base + static_cast<int64_t>(ok ? row0 + r : 0) * row_stride + c * 8;
    cp_async16(d0 + swz<C>(r, c) * 16, src, ok ? 16 : 0);
  }
}

// This warp's 16 rows of accumulators acc (scaled by `mul`) as bf16 into
// its own rows of the swizzled tile `tile`, then 16-byte stores of the
// rows whose index (row0 + r) is below n_rows to out + row * row_stride.
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 8][4], float mul, bf16* tile,
                                           int warp, int lane, bf16* out, int64_t row_stride,
                                           int row0, int n_rows) {
  constexpr int C = HD / 8;
  unsigned char* bytes = reinterpret_cast<unsigned char*>(tile);
  const int gr = lane / 4, tq = lane % 4;
#pragma unroll
  for (int n = 0; n < C; ++n) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + gr + i * 8;
      *reinterpret_cast<uint32_t*>(bytes + swz<C>(r, n) * 16 + tq * 4) =
          pack_bf16(acc[n][2 * i] * mul, acc[n][2 * i + 1] * mul);
    }
  }
  __syncwarp();
  for (int e = lane; e < 16 * C; e += 32) {
    const int r = e / C;
    const int c = e % C;
    const int row = row0 + r;
    if (row >= n_rows) continue;
    *reinterpret_cast<uint4*>(out + row * row_stride + c * 8) =
        *reinterpret_cast<const uint4*>(bytes + swz<C>(warp * 16 + r, c) * 16);
  }
}

template <int HD, int WARPS>
__global__ void __launch_bounds__(32 * WARPS) flash_bwd_dq_mma_kernel(Args a) {
  using D = MmaDims<HD, WARPS>;
  constexpr int C = D::kChunks;
  constexpr int kKSteps = HD / 16;  // 16-wide steps of the hd depth
  constexpr int kDTiles = HD / 8;   // 8-wide output column tiles
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kOwn][HD] Q rows
  bf16* dos = qs + D::kOwn * HD;                 // [kOwn][HD] dO rows
  bf16* ring = dos + D::kOwn * HD;               // stage s: K at 2s, V at 2s + 1

  const int q0 = (gridDim.x - 1 - blockIdx.x) * D::kOwn;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (a.H / a.KV);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;  // fragment row (and row + 8)
  const int tq = lane % 4;  // fragment column pair
  const int off = a.T - a.S;  // query s sits at key position s + off
  const int64_t q_stride = static_cast<int64_t>(a.H) * HD;
  const int64_t kv_stride = static_cast<int64_t>(a.KV) * HD;
  const int64_t qoff = (static_cast<int64_t>(b) * a.S * a.H + h) * HD;
  const int64_t kvoff = (static_cast<int64_t>(b) * a.T * a.KV + g) * HD;
  const bf16* qb = static_cast<const bf16*>(a.q) + qoff;
  const bf16* ob = static_cast<const bf16*>(a.o) + qoff;
  const bf16* dob = static_cast<const bf16*>(a.dout) + qoff;
  const bf16* kb = static_cast<const bf16*>(a.k) + kvoff;
  const bf16* vb = static_cast<const bf16*>(a.v) + kvoff;
  const int64_t rowoff = (static_cast<int64_t>(b) * a.H + h) * a.S;

  int kend = a.T;
  if (a.causal) kend = min(kend, q0 + D::kOwn + off);  // past the last row: masked
  const int n_tiles = kend > 0 ? (kend + kTile - 1) / kTile : 0;

  // prologue: Q and dO rows (group 0), then K/V tile 0 (group 1)
  load_rows_async<HD, D::kOwn, D::kThreads>(qs, qb, q_stride, q0, a.S - q0);
  load_rows_async<HD, D::kOwn, D::kThreads>(dos, dob, q_stride, q0, a.S - q0);
  cp_async_commit();
  if (n_tiles > 0) {
    load_rows_async<HD, kTile, D::kThreads>(ring, kb, kv_stride, 0, a.T);
    load_rows_async<HD, kTile, D::kThreads>(ring + kTile * HD, vb, kv_stride, 0, a.T);
  }
  cp_async_commit();

  // D = dO . O of this warp's 16 rows, two lanes a row (alternate chunks),
  // while the copies fly; then each thread's rows gr and gr + 8
  float dsum = 0.0f;
  {
    const int row = q0 + warp * 16 + lane / 2;
    if (row < a.S) {
      const bf16* orow = ob + row * q_stride;
      const bf16* drow = dob + row * q_stride;
#pragma unroll
      for (int c = lane % 2; c < C; c += 2) {
        dsum += dot8(*reinterpret_cast<const uint4*>(orow + c * 8),
                     *reinterpret_cast<const uint4*>(drow + c * 8));
      }
    }
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
    if (lane % 2 == 0 && row < a.S) a.delta[rowoff + row] = dsum;
  }
  float del[2], lse[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    del[i] = __shfl_sync(0xffffffffu, dsum, (gr + 8 * i) * 2);
    const int row = q0 + warp * 16 + gr + 8 * i;
    lse[i] = row < a.S ? a.lse[rowoff + row] : INFINITY;
  }

  float dq[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.0f;
  const uint32_t qaddr = smem_addr(qs);
  const uint32_t doaddr = smem_addr(dos);
  const int arow = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8;  // ldmatrix row, A
  const int wq0 = q0 + warp * 16;  // this warp's first row
  const int qmin = wq0 + off;      // the key position of that row
  const int qlast = min(wq0 + 16, a.S) - 1 + off;  // ... of its last valid row

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    if (kt + 1 < n_tiles) {  // tile kt + 1 into the other stage
      bf16* st = ring + ((kt + 1) % kStages) * 2 * kTile * HD;
      load_rows_async<HD, kTile, D::kThreads>(st, kb, kv_stride, k0 + kTile, a.T - k0 - kTile);
      load_rows_async<HD, kTile, D::kThreads>(st + kTile * HD, vb, kv_stride, k0 + kTile,
                                              a.T - k0 - kTile);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile kt (and the prologue's rows) have landed
    __syncthreads();
    const bf16* ks = ring + (kt % kStages) * 2 * kTile * HD;
    const uint32_t kaddr = smem_addr(ks);
    const uint32_t vaddr = smem_addr(ks + kTile * HD);

    // kKeySub keys at a time; a warp whose valid rows see none of them skips them
#pragma unroll
    for (int sub = 0; sub < kTile / kKeySub; ++sub) {
      const int ks0 = k0 + sub * kKeySub;  // the step's first key
      if (wq0 >= a.S || ks0 >= a.T || (a.causal && ks0 > qlast)) continue;
      // S = Q K^T and dP = dO V^T: 8 column tiles of 8 keys each
      float s[8][4], dp[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.0f;
      }
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t qa[4], da[4];
        ldmatrix_x4(qa, qaddr + swz<C>(arow, kk * 2 + lane / 16) * 16);
        ldmatrix_x4(da, doaddr + swz<C>(arow, kk * 2 + lane / 16) * 16);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          const int key = sub * kKeySub + jp * 16 + (lane % 8) + (lane / 16) * 8;
          const int chunk = kk * 2 + (lane / 8) % 2;
          uint32_t bk[4];
          ldmatrix_x4(bk, kaddr + swz<C>(key, chunk) * 16);
          mma_bf16(s[2 * jp], qa, bk[0], bk[1]);
          mma_bf16(s[2 * jp + 1], qa, bk[2], bk[3]);
          ldmatrix_x4(bk, vaddr + swz<C>(key, chunk) * 16);
          mma_bf16(dp[2 * jp], da, bk[0], bk[1]);
          mma_bf16(dp[2 * jp + 1], da, bk[2], bk[3]);
        }
      }
      // P = exp2(S * c - lse), masked only on diagonal and ragged steps;
      // dS = P (dP - D), kept in s
      const bool need_mask = ks0 + kKeySub > a.T || (a.causal && ks0 + kKeySub - 1 > qmin);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(s[j][e] * a.scale_log2 - lse[e / 2]);
          if (need_mask) {
            const int key = ks0 + j * 8 + tq * 2 + (e & 1);
            const int qpos = qmin + gr + (e / 2) * 8;
            if (key >= a.T || (a.causal && key > qpos)) p = 0.0f;
          }
          s[j][e] = p * (dp[j][e] - del[e / 2]);
        }
      }
      // dQ += dS K, 16 keys a step, K by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < kKeySub / 16; ++kk) {
        uint32_t pa[4];
        a_from_c(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < kDTiles / 2; ++np) {
          const int key = sub * kKeySub + kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
          uint32_t bk[4];
          ldmatrix_x4_trans(bk, kaddr + swz<C>(key, np * 2 + lane / 16) * 16);
          mma_bf16(dq[2 * np], pa, bk[0], bk[1]);
          mma_bf16(dq[2 * np + 1], pa, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }
  cp_async_wait<0>();
  __syncthreads();  // with no key tile, the prologue's rows may still be landing

  // dQ = sm_scale dS K through this warp's own Q rows (only it reads them)
  store_rows<HD>(dq, a.scale, qs, warp, lane, static_cast<bf16*>(a.dq) + qoff, q_stride, wq0,
                 a.S);
}

template <int HD, int WARPS>
__global__ void __launch_bounds__(32 * WARPS) flash_bwd_dkdv_mma_kernel(Args a) {
  using D = MmaDims<HD, WARPS>;
  constexpr int C = D::kChunks;
  constexpr int kKSteps = HD / 16;
  constexpr int kDTiles = HD / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kOwn][HD] this block's keys
  bf16* vs = ks + D::kOwn * HD;                  // [kOwn][HD]
  bf16* ring = vs + D::kOwn * HD;                // stage s: Q at 2s, dO at 2s + 1
  float* rowvals = reinterpret_cast<float*>(ring + kStages * 2 * kTile * HD);
  // stage s: lse of the 64 query rows at [2s][*], D at [2s + 1][*]

  const int k0 = blockIdx.x * D::kOwn;  // the first key tiles see the most queries
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = a.H / a.KV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;
  const int tq = lane % 4;
  const int off = a.T - a.S;
  const int64_t q_stride = static_cast<int64_t>(a.H) * HD;
  const int64_t kv_stride = static_cast<int64_t>(a.KV) * HD;
  const int64_t kvoff = (static_cast<int64_t>(b) * a.T * a.KV + g) * HD;

  // query tiles first .. n_q - 1 of each head of the group, head by head
  const int first = a.causal ? max(0, k0 - off) / kTile : 0;  // s + off >= k0
  const int n_q = (a.S + kTile - 1) / kTile;
  const int per_head = max(0, n_q - first);
  const int n_items = rep * per_head;
  auto load_item = [&](int it, int stage) {
    const int h = g * rep + it / per_head;
    const int q0 = (first + it % per_head) * kTile;
    const int64_t qoff = (static_cast<int64_t>(b) * a.S * a.H + h) * HD;
    const int64_t rowoff = (static_cast<int64_t>(b) * a.H + h) * a.S;
    bf16* st = ring + stage * 2 * kTile * HD;
    load_rows_async<HD, kTile, D::kThreads>(st, static_cast<const bf16*>(a.q) + qoff, q_stride,
                                            q0, a.S - q0);
    load_rows_async<HD, kTile, D::kThreads>(st + kTile * HD,
                                            static_cast<const bf16*>(a.dout) + qoff, q_stride,
                                            q0, a.S - q0);
    float* rv = rowvals + stage * 2 * kTile;
    for (int e = threadIdx.x; e < 2 * kTile; e += D::kThreads) {
      const int row = q0 + e % kTile;
      const float* src = (e < kTile ? a.lse : a.delta) + rowoff + row;
      cp_async4(smem_addr(rv + e), row < a.S ? src : a.lse, row < a.S ? 4 : 0);
    }
  };

  // prologue: this block's K and V rows (group 0), then item 0 (group 1)
  load_rows_async<HD, D::kOwn, D::kThreads>(ks, static_cast<const bf16*>(a.k) + kvoff,
                                            kv_stride, k0, a.T - k0);
  load_rows_async<HD, D::kOwn, D::kThreads>(vs, static_cast<const bf16*>(a.v) + kvoff,
                                            kv_stride, k0, a.T - k0);
  cp_async_commit();
  if (n_items > 0) load_item(0, 0);
  cp_async_commit();

  float dk[kDTiles][4], dv[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.0f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.0f;
  }
  const uint32_t kaddr = smem_addr(ks);
  const uint32_t vaddr = smem_addr(vs);
  const int arow = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8;  // ldmatrix row, A
  const int kw0 = k0 + warp * 16;  // this warp's first key

  for (int it = 0; it < n_items; ++it) {
    if (it + 1 < n_items) load_item(it + 1, (it + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();  // item it (and the prologue's rows) have landed
    __syncthreads();
    const int q0 = (first + it % per_head) * kTile;
    const bf16* st = ring + (it % kStages) * 2 * kTile * HD;
    const uint32_t qaddr = smem_addr(st);
    const uint32_t doaddr = smem_addr(st + kTile * HD);
    const float* lse_t = rowvals + (it % kStages) * 2 * kTile;
    const float* del_t = lse_t + kTile;
    const int qlast = min(q0 + kTile, a.S) - 1 + off;  // key position of the last valid query

    // a warp whose keys no valid query of this tile sees skips it
    if (kw0 < a.T && (!a.causal || kw0 <= qlast)) {
      const bool need_mask =
          kw0 + 16 > a.T || q0 + kTile > a.S || (a.causal && kw0 + 15 > q0 + off);
#pragma unroll
      for (int half = 0; half < kTile / kSub; ++half) {
        // S^T = K Q^T and dP^T = V dO^T: [16 keys][32 queries]
        float s[4][4], dp[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
          dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.0f;
        }
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk) {
          uint32_t ka[4], va[4];
          ldmatrix_x4(ka, kaddr + swz<C>(arow, kk * 2 + lane / 16) * 16);
          ldmatrix_x4(va, vaddr + swz<C>(arow, kk * 2 + lane / 16) * 16);
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            const int qr = half * kSub + jp * 16 + (lane % 8) + (lane / 16) * 8;
            const int chunk = kk * 2 + (lane / 8) % 2;
            uint32_t bq[4];
            ldmatrix_x4(bq, qaddr + swz<C>(qr, chunk) * 16);
            mma_bf16(s[2 * jp], ka, bq[0], bq[1]);
            mma_bf16(s[2 * jp + 1], ka, bq[2], bq[3]);
            ldmatrix_x4(bq, doaddr + swz<C>(qr, chunk) * 16);
            mma_bf16(dp[2 * jp], va, bq[0], bq[1]);
            mma_bf16(dp[2 * jp + 1], va, bq[2], bq[3]);
          }
        }
        // P^T = exp2(S^T c - lse[query]) and dS^T = P^T (dP^T - D[query]),
        // P^T kept in s and dS^T in dp
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ql = half * kSub + j * 8 + tq * 2;  // local query of e & 1 == 0
          const float2 l2 = *reinterpret_cast<const float2*>(lse_t + ql);
          const float2 d2 = *reinterpret_cast<const float2*>(del_t + ql);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2f(s[j][e] * a.scale_log2 - ((e & 1) ? l2.y : l2.x));
            if (need_mask) {
              const int key = kw0 + gr + (e / 2) * 8;
              const int q = q0 + ql + (e & 1);
              if (key >= a.T || q >= a.S || (a.causal && key > q + off)) p = 0.0f;
            }
            s[j][e] = p;
            dp[j][e] = p * (dp[j][e] - ((e & 1) ? d2.y : d2.x));
          }
        }
        // dV += P^T dO and dK += dS^T Q, 16 queries a step, dO and Q by
        // ldmatrix.trans
#pragma unroll
        for (int kk = 0; kk < kSub / 16; ++kk) {
          uint32_t pa[4], sa[4];
          a_from_c(pa, s[2 * kk], s[2 * kk + 1]);
          a_from_c(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
          for (int np = 0; np < kDTiles / 2; ++np) {
            const int qr = half * kSub + kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
            const int chunk = np * 2 + lane / 16;
            uint32_t bq[4];
            ldmatrix_x4_trans(bq, doaddr + swz<C>(qr, chunk) * 16);
            mma_bf16(dv[2 * np], pa, bq[0], bq[1]);
            mma_bf16(dv[2 * np + 1], pa, bq[2], bq[3]);
            ldmatrix_x4_trans(bq, qaddr + swz<C>(qr, chunk) * 16);
            mma_bf16(dk[2 * np], sa, bq[0], bq[1]);
            mma_bf16(dk[2 * np + 1], sa, bq[2], bq[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }
  cp_async_wait<0>();
  __syncthreads();  // with no query tile, the prologue's rows may still be landing

  // dK = sm_scale dS^T Q and dV through this warp's own K and V rows
  store_rows<HD>(dk, a.scale, ks, warp, lane, static_cast<bf16*>(a.dk) + kvoff, kv_stride, kw0,
                 a.T);
  store_rows<HD>(dv, 1.0f, vs, warp, lane, static_cast<bf16*>(a.dv) + kvoff, kv_stride, kw0,
                 a.T);
}

// ------------------------------------------------------------------ launch

template <int HD>
size_t smem_bytes(int dtype, int which) {
  if (dtype == 0) return which == 0 ? FmaDims<HD>::kSmemDq : FmaDims<HD>::kSmemDkdv;
  return which == 0 ? MmaDims<HD, kDqWarps>::kSmemDq : MmaDims<HD, kDkdvWarps>::kSmemDkdv;
}

int set_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem)));
}

// Kernels launched, by dtype (0 = float32, 1 = bfloat16) and kernel (0 = dQ,
// 1 = dK dV): what kernels/flash_attention.py reads to show which pair a
// dtype runs.
long long g_launched[2][2] = {};

template <int HD>
int launch(const Args& a, int dtype, int batch, cudaStream_t stream) {
  const void* fns[2];
  int threads[2], rows[2];
  if (dtype == 0) {
    fns[0] = reinterpret_cast<const void*>(flash_bwd_dq_fma_kernel<HD>);
    fns[1] = reinterpret_cast<const void*>(flash_bwd_dkdv_fma_kernel<HD>);
    threads[0] = threads[1] = kThreads;
    rows[0] = rows[1] = kB;
  } else {
    fns[0] = reinterpret_cast<const void*>(flash_bwd_dq_mma_kernel<HD, kDqWarps>);
    fns[1] = reinterpret_cast<const void*>(flash_bwd_dkdv_mma_kernel<HD, kDkdvWarps>);
    threads[0] = 32 * kDqWarps;
    threads[1] = 32 * kDkdvWarps;
    rows[0] = 16 * kDqWarps;
    rows[1] = 16 * kDkdvWarps;
  }
  size_t smem[2];
  for (int i = 0; i < 2; ++i) {
    smem[i] = smem_bytes<HD>(dtype, i);
    const int err = set_smem(fns[i], smem[i]);
    if (err != 0) return err;
  }
  // dQ first: it writes D, which the dK dV kernel reads (same stream)
  void* args[] = {const_cast<Args*>(&a)};
  if (a.S > 0) {
    const dim3 grid((a.S + rows[0] - 1) / rows[0], a.H, batch);
    const cudaError_t err = cudaLaunchKernel(fns[0], grid, dim3(threads[0]), args, smem[0], stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    ++g_launched[dtype][0];
  }
  if (a.T > 0) {
    const dim3 grid((a.T + rows[1] - 1) / rows[1], a.KV, batch);
    const cudaError_t err = cudaLaunchKernel(fns[1], grid, dim3(threads[1]), args, smem[1], stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    ++g_launched[dtype][1];
  }
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
long long smem_max(int dtype) {
  const size_t x = smem_bytes<HD>(dtype, 0);
  const size_t y = smem_bytes<HD>(dtype, 1);
  return static_cast<long long>(x > y ? x : y);
}

}  // namespace

// The bfloat16 kernels' geometry, which kernels/flash_attention.py mirrors
// (flash_bwd_walk) and checks: rows of a streamed tile, keys a dQ step,
// warps a dQ block and warps a dK dV block (16 owned rows a warp).
extern "C" int flash_attention_bwd_tile() { return kTile; }
extern "C" int flash_attention_bwd_key_step() { return kKeySub; }
extern "C" int flash_attention_bwd_dq_warps() { return kDqWarps; }
extern "C" int flash_attention_bwd_dkdv_warps() { return kDkdvWarps; }

// Launches of kernel `which` (0 = dQ, 1 = dK dV) of dtype's pair (0 =
// float32 FMA, 1 = bfloat16 tensor cores) since the library was loaded.
extern "C" long long flash_attention_bwd_kernel_launches(int dtype, int which) {
  if (dtype < 0 || dtype > 1 || which < 0 || which > 1) return -1;
  return g_launched[dtype][which];
}

// Shared memory the larger of the two kernels needs for dtype (0 = float32,
// 1 = bfloat16) and head size hd, in bytes (0: unsupported).
extern "C" long long flash_attention_bwd_smem_bytes(int dtype, int hd) {
  if (dtype != 0 && dtype != 1) return 0;
  switch (hd) {
    case 16: return smem_max<16>(dtype);
    case 32: return smem_max<32>(dtype);
    case 64: return smem_max<64>(dtype);
    case 128: return smem_max<128>(dtype);
    default: return 0;
  }
}

// q, o, dout, dq (batch, S, H, hd); k, v, dk, dv (batch, T, KV, hd):
// contiguous device arrays of one type (dtype 0 = float32, FMA kernels; 1 =
// bfloat16, tensor-core kernels), 16-byte aligned; lse (batch, H, S) float32
// from the forward (flash_attention_launch), delta (batch, H, S) float32
// scratch. Every element of dq, dk and dv is written. Launches the two
// kernels on `stream` and returns the CUDA error as an int (0 = launched).
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
  switch (hd) {
    case 16: return launch<16>(a, dtype, batch, st);
    case 32: return launch<32>(a, dtype, batch, st);
    case 64: return launch<64>(a, dtype, batch, st);
    case 128: return launch<128>(a, dtype, batch, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
