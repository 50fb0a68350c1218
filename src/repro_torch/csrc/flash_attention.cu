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
// Two designs, chosen by the wrapper from the dtype (a dispatch, not a
// fallback: each dtype has exactly one kernel):
//
// bfloat16 (flash_mma_kernel, the model's path): FlashAttention-2 on
// mma.sync. One block of 4 warps per (query tile of 64 rows, head, batch),
// heaviest causal tiles launched first. Each warp owns 16 query rows; its Q
// fragments are loaded once with ldmatrix and stay in registers for the
// whole key loop. S = Q K^T and O += P V run on the tensor cores as
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (bf16 in, float32
// accumulate). sm_scale * log2(e) is folded into the scores and the
// softmax uses exp2f. The online softmax runs on the accumulator fragments:
// row max across the four threads of a quad by __shfl_xor_sync, the output
// fragments rescaled in registers, the row sum kept per thread and reduced
// once at the end. P is converted to bf16 in registers and fed straight
// into P V as the A operand (an m16n8k16 C fragment has the layout of an A
// fragment), so it never touches shared memory. K and V tiles of 64 keys
// are loaded with cp.async (16 bytes a thread, zero-filled past T) into a
// ring of 2 stages, tile t + 1 in flight while tile t computes. Shared
// tiles are stored with an XOR swizzle of their 16-byte chunks, so that
// ldmatrix (Q, K) and ldmatrix.trans (V) read 8 rows of one chunk from 8
// distinct bank groups. Only diagonal and ragged tiles are masked; causal
// tiles past the diagonal are skipped. The output goes through the warp's
// own rows of the Q tile in shared memory to 16-byte stores.
//
// float32 (flash_fma_kernel): float32 FMAs on float32 tiles, no tensor
// cores, kept because TF32 would not hold the float32 checks (2e-4 against
// the plain version, 1e-3 between CPU and card at full width). One block of
// 256 threads per (query tile of 64 rows, head, batch); the query tile,
// pre-scaled by sm_scale * log2(e), and K and V tiles of 64 keys are staged
// in shared memory; each thread holds a 4 x 4 block of the score tile and a
// 4 x hd/16 block of the output; probabilities pass through shared memory.
//
// hd is 16, 32, 64 or 128 in both designs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;  // query rows a block
constexpr int kBK = 64;  // keys a tile
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;  // (batch, H, S) log-sum-exp in log2 units, or null (serving)
  int S, T, H, KV, causal;
  float scale_log2;  // sm_scale * log2(e)
};

// Row `row` of head h, batch b: the log2-unit log-sum-exp of its scaled
// scores, m + log2(l), which the backward (csrc/flash_attention_bwd.cu)
// reads to rebuild P; +inf for a row that sees no key (its P is all zeros).
__device__ __forceinline__ void store_lse(const Args& a, int b, int h, int row,
                                          float m, float l) {
  a.lse[(static_cast<int64_t>(b) * a.H + h) * a.S + row] =
      l > 0.0f ? m + log2f(l) : INFINITY;
}

// ---------------------------------------------------------------- float32

constexpr int kFmaThreads = 256;  // 16 x 16
constexpr int kLdP = kBK + 4;     // probability row stride in shared memory

template <int HD>
struct FmaDims {
  static constexpr int kLd = HD + 4;  // Q and K row stride (floats)
  static constexpr int kNC = HD / 16;  // output columns a thread
  static constexpr int kVec = kNC >= 4 ? 4 : kNC;
  static constexpr int kNG = kNC / kVec;
  static constexpr size_t kSmem =
      sizeof(float) * (static_cast<size_t>(kBQ) * kLd + kBK * kLd +
                       kBK * HD + kBQ * kLdP);
};

// Rows row0 .. row0 + 63 of a (rows x HD) float32 operand whose row r
// starts at base + r * row_stride, into dst[r * ld + d] times `mul`; rows
// at or past `n_valid` (relative to row0) are zeros.
template <int HD>
__device__ __forceinline__ void load_tile_f32(float* dst, int ld,
                                              const float* base,
                                              int64_t row_stride, int row0,
                                              int n_valid, float mul) {
  constexpr int kPerRow = HD / 4;
  for (int e = threadIdx.x; e < 64 * kPerRow; e += kFmaThreads) {
    const int r = e / kPerRow;
    const int c = (e % kPerRow) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < n_valid) {
      x = *reinterpret_cast<const float4*>(
          base + static_cast<int64_t>(row0 + r) * row_stride + c);
    }
    *reinterpret_cast<float4*>(dst + r * ld + c) =
        make_float4(x.x * mul, x.y * mul, x.z * mul, x.w * mul);
  }
}

template <int HD>
__global__ void __launch_bounds__(kFmaThreads) flash_fma_kernel(Args a) {
  using D = FmaDims<HD>;
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

  const float* qb = static_cast<const float*>(a.q) +
                    (static_cast<int64_t>(b) * a.S * a.H + h) * HD;
  const float* kb = static_cast<const float*>(a.k) +
                    (static_cast<int64_t>(b) * a.T * a.KV + g) * HD;
  const float* vb = static_cast<const float*>(a.v) +
                    (static_cast<int64_t>(b) * a.T * a.KV + g) * HD;
  const int64_t kv_stride = static_cast<int64_t>(a.KV) * HD;
  load_tile_f32<HD>(qs, D::kLd, qb, static_cast<int64_t>(a.H) * HD, q0,
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
    load_tile_f32<HD>(ks, D::kLd, kb, kv_stride, k0, a.T - k0, 1.0f);
    load_tile_f32<HD>(vs, HD, vb, kv_stride, k0, a.T - k0, 1.0f);
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

  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.S) continue;
    if (a.lse != nullptr && tx == 0) store_lse(a, b, h, row, m[i], l[i]);
    const float inv = l[i] > 0.0f ? 1.0f / l[i] : 0.0f;
    float* orow = out + ((static_cast<int64_t>(b) * a.S + row) * a.H + h) * HD;
#pragma unroll
    for (int gi = 0; gi < D::kNG; ++gi)
#pragma unroll
      for (int c = 0; c < D::kVec; ++c)
        orow[gi * 16 * D::kVec + tx * D::kVec + c] = acc[i][gi * D::kVec + c] * inv;
  }
}

// --------------------------------------------------------------- bfloat16

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows
constexpr int kStages = 2;        // K/V ring depth

template <int HD>
struct MmaDims {
  static constexpr int kChunks = HD / 8;  // 16-byte chunks a row
  static constexpr int kTile = kBQ * HD;  // bf16 elements of a 64-row tile
  // Q tile, then kStages x (K tile, V tile)
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) * static_cast<size_t>(kTile) * (1 + 2 * kStages);
};

// Chunk index of 16-byte chunk c of row r in a tile of rows of C chunks.
// The XOR spreads the 8 rows that one ldmatrix phase reads at the same
// logical chunk over 8 distinct bank groups (16 bytes each): for C >= 8
// chunk c ^ (r % 8); for C = 4 (two rows share 128 bytes) c ^ ((r / 2) % 4);
// for C = 2, c ^ ((r / 4) % 2).
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
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a * b on the tensor cores: a 16 x 16 (row), b 16 x 8 (col), bf16
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
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

// Rows row0 .. row0 + 63 of a (rows x HD) bf16 operand whose row r starts
// at base + r * row_stride into a swizzled shared tile with cp.async; rows
// at or past n_valid (relative to row0) are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* base,
                                                int64_t row_stride, int row0,
                                                int n_valid) {
  constexpr int C = MmaDims<HD>::kChunks;
  static_assert(kBQ * C % kMmaThreads == 0, "whole chunks a thread");
  const uint32_t d0 = smem_addr(dst);
#pragma unroll
  for (int i = 0; i < kBQ * C / kMmaThreads; ++i) {
    const int e = threadIdx.x + i * kMmaThreads;
    const int r = e / C;
    const int c = e % C;
    const bool ok = r < n_valid;
    const __nv_bfloat16* src =
        base + static_cast<int64_t>(ok ? row0 + r : 0) * row_stride + c * 8;
    cp_async16(d0 + swz<C>(r, c) * 16, src, ok ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads) flash_mma_kernel(Args a) {
  using D = MmaDims<HD>;
  constexpr int C = D::kChunks;
  constexpr int kKSteps = HD / 16;  // 16-wide steps of the Q K^T depth
  constexpr int kDTiles = HD / 8;   // 8-wide output column tiles
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ring = qs + D::kTile;  // stage s: K at 2s, V at 2s + 1

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (a.H / a.KV);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;  // fragment row (and row + 8)
  const int tq = lane % 4;  // fragment column pair
  const int off = a.T - a.S;  // query s sits at key position s + off

  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) +
                            (static_cast<int64_t>(b) * a.S * a.H + h) * HD;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) +
                            (static_cast<int64_t>(b) * a.T * a.KV + g) * HD;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) +
                            (static_cast<int64_t>(b) * a.T * a.KV + g) * HD;
  const int64_t q_stride = static_cast<int64_t>(a.H) * HD;
  const int64_t kv_stride = static_cast<int64_t>(a.KV) * HD;

  int kend = a.T;
  if (a.causal) kend = min(kend, q0 + kBQ + off);  // past the last row: masked
  const int n_tiles = kend > 0 ? (kend + kBK - 1) / kBK : 0;

  // prologue: Q (group 0), then K/V tile 0 (group 1)
  load_tile_async<HD>(qs, qb, q_stride, q0, a.S - q0);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile_async<HD>(ring, kb, kv_stride, 0, a.T);
    load_tile_async<HD>(ring + D::kTile, vb, kv_stride, 0, a.T);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // this warp's 16 query rows as A fragments, for the whole key loop
  uint32_t qf[kKSteps][4];
  {
    const int r = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
    const uint32_t base = smem_addr(qs);
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
      ldmatrix_x4(qf[kk], base + swz<C>(r, kk * 2 + lane / 16) * 16);
  }

  float o[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};  // rows gr and gr + 8, log2 units
  float l[2] = {0.0f, 0.0f};            // this thread's share of the row sums
  const int qpos0 = q0 + warp * 16 + gr + off;  // key position of row gr

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    if (kt + 1 < n_tiles) {  // tile kt + 1 into the other stage
      __nv_bfloat16* st = ring + ((kt + 1) % kStages) * 2 * D::kTile;
      load_tile_async<HD>(st, kb, kv_stride, k0 + kBK, a.T - k0 - kBK);
      load_tile_async<HD>(st + D::kTile, vb, kv_stride, k0 + kBK,
                          a.T - k0 - kBK);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile kt has landed
    __syncthreads();
    const __nv_bfloat16* ks = ring + (kt % kStages) * 2 * D::kTile;
    const uint32_t kaddr = smem_addr(ks);
    const uint32_t vaddr = smem_addr(ks + D::kTile);

    // S = Q K^T: 8 column tiles of 8 keys, loaded two at a time
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bk[4];
        const int key = jp * 16 + (lane % 8) + (lane / 16) * 8;
        ldmatrix_x4(bk, kaddr + swz<C>(key, kk * 2 + (lane / 8) % 2) * 16);
        mma_bf16(s[2 * jp], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // scale, mask diagonal and ragged tiles, fold into the running max
    const bool need_mask =
        k0 + kBK > a.T || (a.causal && k0 + kBK - 1 > q0 + off);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * a.scale_log2;
        if (need_mask) {
          const int key = k0 + j * 8 + tq * 2 + (e & 1);
          const int qpos = qpos0 + (e / 2) * 8;
          if (key >= a.T || (a.causal && key > qpos)) x = -INFINITY;
        }
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      // a row with no visible key so far keeps p = 0 and its zeros
      m_use[i] = m_new == -INFINITY ? 0.0f : m_new;
      alpha[i] = exp2f(m[i] - m_use[i]);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // P = exp2(S - m), in registers; O += P V, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * kk + half;
        const float p0 = exp2f(s[j][0] - m_use[0]);
        const float p1 = exp2f(s[j][1] - m_use[0]);
        const float p2 = exp2f(s[j][2] - m_use[1]);
        const float p3 = exp2f(s[j][3] - m_use[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        pa[2 * half] = pack_bf16(p0, p1);      // row gr
        pa[2 * half + 1] = pack_bf16(p2, p3);  // row gr + 8
      }
#pragma unroll
      for (int np = 0; np < kDTiles / 2; ++np) {
        uint32_t bv[4];
        const int key = kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
        ldmatrix_x4_trans(bv, vaddr + swz<C>(key, np * 2 + lane / 16) * 16);
        mma_bf16(o[2 * np], pa, bv[0], bv[1]);
        mma_bf16(o[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }

  // row sums across the quad, normalise, and write through this warp's rows
  // of the Q tile (no other warp reads them after the prologue)
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = l[i] > 0.0f ? 1.0f / l[i] : 0.0f;
    const int row = q0 + warp * 16 + gr + i * 8;
    if (a.lse != nullptr && tq == 0 && row < a.S) store_lse(a, b, h, row, m[i], l[i]);
  }
  unsigned char* qbytes = reinterpret_cast<unsigned char*>(qs);
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + gr + i * 8;
      *reinterpret_cast<uint32_t*>(qbytes + swz<C>(r, n) * 16 + tq * 4) =
          pack_bf16(o[n][2 * i] * inv[i], o[n][2 * i + 1] * inv[i]);
    }
  }
  __syncwarp();
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  for (int e = lane; e < 16 * C; e += 32) {
    const int r = e / C;
    const int c = e % C;
    const int row = q0 + warp * 16 + r;
    if (row >= a.S) continue;
    const uint4 x =
        *reinterpret_cast<const uint4*>(qbytes + swz<C>(warp * 16 + r, c) * 16);
    *reinterpret_cast<uint4*>(
        out + ((static_cast<int64_t>(b) * a.S + row) * a.H + h) * HD + c * 8) = x;
  }
}

// ------------------------------------------------------------------ launch

template <int HD>
size_t smem_bytes(int dtype) {
  return dtype == 0 ? FmaDims<HD>::kSmem : MmaDims<HD>::kSmem;
}

template <int HD>
int launch(const Args& a, int dtype, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>(dtype);
  const void* fn = dtype == 0 ? reinterpret_cast<const void*>(flash_fma_kernel<HD>)
                              : reinterpret_cast<const void*>(flash_mma_kernel<HD>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.H, batch);
  if (dtype == 0) {
    flash_fma_kernel<HD><<<grid, kFmaThreads, smem, stream>>>(a);
  } else {
    flash_mma_kernel<HD><<<grid, kMmaThreads, smem, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory a block needs for dtype (0 = float32, 1 = bfloat16) and
// head size hd, in bytes (0: unsupported).
extern "C" long long flash_attention_smem_bytes(int dtype, int hd) {
  if (dtype != 0 && dtype != 1) return 0;
  switch (hd) {
    case 16: return static_cast<long long>(smem_bytes<16>(dtype));
    case 32: return static_cast<long long>(smem_bytes<32>(dtype));
    case 64: return static_cast<long long>(smem_bytes<64>(dtype));
    case 128: return static_cast<long long>(smem_bytes<128>(dtype));
    default: return 0;
  }
}

// q (batch, S, H, hd), k and v (batch, T, KV, hd), out like q: contiguous
// device arrays of one type, 16-byte aligned; dtype 0 = float32 (FMA
// kernel), 1 = bfloat16 (tensor-core kernel). lse, when not null, receives
// each row's log-sum-exp (batch, H, S) float32 in log2 units (see
// store_lse), for the backward. Launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int dtype,
                                      int batch, int S, int T, int H, int KV,
                                      int hd, int causal, float sm_scale,
                                      void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || H % KV != 0 || T < 0 || H > 65535 || batch > 65535 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, out, static_cast<float*>(lse), S, T, H, KV, causal ? 1 : 0,
               sm_scale * kLog2e};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(a, dtype, batch, st);
    case 32: return launch<32>(a, dtype, batch, st);
    case 64: return launch<64>(a, dtype, batch, st);
    case 128: return launch<128>(a, dtype, batch, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
