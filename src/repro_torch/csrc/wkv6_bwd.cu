// The backward of the RWKV6 (Finch) WKV recurrence on Hopper.
//
// The JAX package has no backward kernel: jax.grad through its Pallas
// wkv6_chunked raises, and repro/kernels/ops.py then differentiates the
// reference repro/kernels/ref.py:91 (ref.wkv6). This is the gradient of that
// same function, for the forward of csrc/wkv6.cu. Per (batch, head), from a
// zero state, S_t = diag(w_t) S_{t-1} + k_t v_t^T and o_t = r_t (S_{t-1} +
// diag(u) k_t v_t^T). Given dO and the gradient of the final state (or
// none: zeros), with G_t the gradient of S_t (G of the last token is the
// final state's), walking the tokens backward:
//   dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
//   dk_t[i] = sum_j (G_t[i,j] + r_t[i] u[i] do_t[j]) v_t[j]
//   dv_t[j] = sum_i (G_t[i,j] + r_t[i] u[i] do_t[j]) k_t[i]
//   dr_t[i] = sum_j do_t[j] (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
//   du[i]   = sum over batch and t of r_t[i] k_t[i] (do_t . v_t)
//   G_{t-1} = diag(w_t) G_t + r_t do_t^T
//
// S_{t-1} is never recovered by dividing by w_t: the decays go to ~0. The
// kernel walks the tokens forward once, keeping the state at the start of
// every chunk of kChunk tokens (a checkpoint in device memory) and dr,
// which needs only forward quantities; then it walks the chunks backward,
// rebuilding each chunk's states forward from its checkpoint into shared
// memory before walking the chunk backward with G.
//
// Columns j are independent in S and in G, so one block takes a slice of
// kSlice columns of one (batch, head), and one thread a row i of that slice:
// the sums over j of a row (dr, dk, dw) are the thread's own, over its
// slice; the sum over i of a column (dv) is a reduce-scatter across the
// warp's lanes by __shfl_xor_sync, then across the warps through shared
// memory, in a fixed order. The slices' partial row sums go to a scratch
// array, and wkv6_bwd_reduce_kernel adds them slice by slice in a fixed
// order (with du over batch and slice): no floating-point atomics, so every
// run gives the same bits.
//
// Bound: operations. The function needs about 14 flops per (token, i, j):
// the state rebuilt (3), G (3), dw, dk, dv, dr (2 each, the bonus terms
// folded in), at the card's float32 rate outside the tensor cores: about
// 19 GFLOP a layer at RWKV6-3B's 4 x 2,048-token step (40 heads of 64),
// 0.28 ms at 67 TFLOP/s; the kernel also runs the forward a second time
// (the checkpoints). A simple design that is right: making it fast is later
// work. r, k, v, dO and dr, dk, dv are bfloat16 or float32 (one type), w, u,
// dw, du and the state's gradient float32; hd is 16, 32, 64 or 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;  // tokens between checkpoints (and staged at once)
constexpr int kSlice = 16;  // state columns a block (hd / kSlice slices a head)

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const void* dout;
  const float* dstate;  // (B, H, hd, hd) or null
  float* ckpt;          // (B, H, slices, chunks, kSlice, hd) scratch
  float* part;          // (3, slices, B * S * H * hd): dr, dk, dw partials
  float* du_part;       // (slices, B, H, hd)
  void* dv;             // (B, S, H, hd)
  int B, S, H;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int HD>
struct Dims {
  static constexpr int kSlices = HD / kSlice;
  static constexpr int kLanes = HD < 32 ? HD : 32;  // lanes of a warp in use
  static constexpr int kWarps = (HD + 31) / 32;
  static constexpr unsigned kMask = kLanes == 32 ? 0xffffffffu : 0xffffu;
  // floats of shared memory: the chunk's states [kChunk][kSlice][HD], its
  // r, k, w [3][kChunk][HD], its v, dO slices [2][kChunk][kSlice], and the
  // warps' column sums [kWarps][kChunk][kSlice]
  static constexpr size_t kHist = static_cast<size_t>(kChunk) * kSlice * HD;
  static constexpr size_t kFloats =
      kHist + 3 * kChunk * HD + 2 * kChunk * kSlice + kWarps * kChunk * kSlice;
};

template <typename T, int HD>
__global__ void __launch_bounds__(128) wkv6_bwd_kernel(const __grid_constant__ Args a) {
  using D = Dims<HD>;
  extern __shared__ __align__(16) float smem[];
  float* hist = smem;                      // [kChunk][kSlice][HD]
  float* rs = hist + D::kHist;             // [kChunk][HD]
  float* ks = rs + kChunk * HD;
  float* ws = ks + kChunk * HD;
  float* vs = ws + kChunk * HD;            // [kChunk][kSlice]
  float* ds = vs + kChunk * kSlice;
  float* red = ds + kChunk * kSlice;       // [kWarps][kChunk][kSlice]

  const int slice = blockIdx.x % D::kSlices;
  const int h = blockIdx.x / D::kSlices;
  const int b = blockIdx.y;
  const int j0 = slice * kSlice;
  const int i = threadIdx.x;  // the state row this thread holds
  const int lane = i % 32;
  const int warp = i / 32;
  const int64_t tok = static_cast<int64_t>(a.H) * HD;  // elements a token
  const int64_t base = static_cast<int64_t>(b) * a.S * tok + static_cast<int64_t>(h) * HD;
  const int64_t n = static_cast<int64_t>(a.B) * a.S * tok;
  const int n_chunks = (a.S + kChunk - 1) / kChunk;
  float* ckpt = a.ckpt + ((static_cast<int64_t>(b) * a.H + h) * D::kSlices + slice) *
                             n_chunks * kSlice * HD;
  float* part_dr = a.part + slice * n;
  float* part_dk = a.part + (D::kSlices + slice) * n;
  float* part_dw = a.part + (2 * D::kSlices + slice) * n;
  const T* rp = static_cast<const T*>(a.r);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  const T* dp = static_cast<const T*>(a.dout);
  const float uu = a.u[h * HD + i];

  // tokens c * kChunk .. into shared memory: r, k, w of every row, v and dO
  // of this slice's columns
  auto stage = [&](int c) {
    const int t0 = c * kChunk;
    const int cnt = min(kChunk, a.S - t0);
    for (int tt = 0; tt < cnt; ++tt) {
      const int64_t at = base + (t0 + tt) * tok + i;
      rs[tt * HD + i] = to_f32(rp[at]);
      ks[tt * HD + i] = to_f32(kp[at]);
      ws[tt * HD + i] = a.w[at];
    }
    for (int e = i; e < cnt * kSlice; e += HD) {
      const int tt = e / kSlice, jj = e % kSlice;
      const int64_t at = base + (t0 + tt) * tok + j0 + jj;
      vs[e] = to_f32(vp[at]);
      ds[e] = to_f32(dp[at]);
    }
    return cnt;
  };

  // ---- forward: checkpoints and dr
  float st[kSlice];
#pragma unroll
  for (int jj = 0; jj < kSlice; ++jj) st[jj] = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // every thread is done with the previous chunk's stage
    const int cnt = stage(c);
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < kSlice; ++jj) ckpt[(c * kSlice + jj) * HD + i] = st[jj];
    for (int tt = 0; tt < cnt; ++tt) {
      const float kt = ks[tt * HD + i], wt = ws[tt * HD + i];
      const float ukt = uu * kt;
      float acc = 0.0f;
#pragma unroll
      for (int jj = 0; jj < kSlice; ++jj) {
        const float vj = vs[tt * kSlice + jj], dj = ds[tt * kSlice + jj];
        acc = fmaf(dj, fmaf(ukt, vj, st[jj]), acc);
        st[jj] = fmaf(wt, st[jj], kt * vj);
      }
      part_dr[base + (c * kChunk + tt) * tok + i] = acc;
    }
  }

  // ---- backward, chunk by chunk from the last
  float g[kSlice];
#pragma unroll
  for (int jj = 0; jj < kSlice; ++jj) {
    g[jj] = a.dstate == nullptr
                ? 0.0f
                : a.dstate[((static_cast<int64_t>(b) * a.H + h) * HD + i) * HD + j0 + jj];
  }
  float du = 0.0f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    __syncthreads();  // the previous chunk's reads of the stage and red are done
    const int cnt = stage(c);
    __syncthreads();
    // the chunk's states S_{t-1}, rebuilt from its checkpoint
#pragma unroll
    for (int jj = 0; jj < kSlice; ++jj) st[jj] = ckpt[(c * kSlice + jj) * HD + i];
    for (int tt = 0; tt < cnt; ++tt) {
      const float kt = ks[tt * HD + i], wt = ws[tt * HD + i];
#pragma unroll
      for (int jj = 0; jj < kSlice; ++jj) {
        hist[(tt * kSlice + jj) * HD + i] = st[jj];
        st[jj] = fmaf(wt, st[jj], kt * vs[tt * kSlice + jj]);
      }
    }
    for (int tt = cnt - 1; tt >= 0; --tt) {
      const float rt = rs[tt * HD + i], kt = ks[tt * HD + i], wt = ws[tt * HD + i];
      const float ruk = rt * uu;
      float dw = 0.0f, dk = 0.0f, dov = 0.0f, col[kSlice];
#pragma unroll
      for (int jj = 0; jj < kSlice; ++jj) {
        const float vj = vs[tt * kSlice + jj], dj = ds[tt * kSlice + jj];
        dw = fmaf(g[jj], hist[(tt * kSlice + jj) * HD + i], dw);
        const float gb = fmaf(ruk, dj, g[jj]);
        dk = fmaf(gb, vj, dk);
        col[jj] = gb * kt;
        dov = fmaf(dj, vj, dov);
        g[jj] = fmaf(wt, g[jj], rt * dj);
      }
      du = fmaf(rt * kt, dov, du);
      const int64_t at = base + (c * kChunk + tt) * tok + i;
      part_dk[at] = dk;
      part_dw[at] = dw;
      // dv: sum col over the rows. Reduce-scatter over the warp's lanes
      // (recursive halving), leaving lane l with column `cj` summed over
      // the warp's rows
      int count = kSlice, cj = 0;
#pragma unroll
      for (int o = D::kLanes / 2; o >= 1; o /= 2) {
        if (count > 1) {
          const int half = count / 2;
          const bool upper = lane & o;
#pragma unroll
          for (int m = 0; m < kSlice / 2; ++m) {
            if (m < half) {
              const float send = upper ? col[m] : col[m + half];
              const float keep = upper ? col[m + half] : col[m];
              col[m] = keep + __shfl_xor_sync(D::kMask, send, o);
            }
          }
          cj += upper ? half : 0;
          count = half;
        } else {
          col[0] += __shfl_xor_sync(D::kMask, col[0], o);
        }
      }
      // with 32 lanes, lanes 2m and 2m + 1 hold the same column
      if (D::kLanes == 16 || (lane & 1) == 0) red[(warp * kChunk + tt) * kSlice + cj] = col[0];
    }
    __syncthreads();
    T* dv = static_cast<T*>(a.dv);
    for (int e = i; e < cnt * kSlice; e += HD) {
      const int tt = e / kSlice, jj = e % kSlice;
      float sum = 0.0f;
#pragma unroll
      for (int wi = 0; wi < D::kWarps; ++wi) sum += red[(wi * kChunk + tt) * kSlice + jj];
      store(dv + base + (c * kChunk + tt) * tok + j0 + jj, sum);
    }
  }
  a.du_part[((static_cast<int64_t>(slice) * a.B + b) * a.H + h) * HD + i] = du;
}

// dr, dk (type T) and dw (float32) of every element from the slices'
// partial sums, slice by slice; du (H, hd) from the (slice, batch) partials,
// batch by batch and slice by slice.
template <typename T>
__global__ void wkv6_bwd_reduce_kernel(const float* part, const float* du_part, T* dr,
                                       T* dk, float* dw, float* du, int64_t n, int slices,
                                       int B, int hh) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e < n) {
    float x = 0.0f, y = 0.0f, z = 0.0f;
    for (int s = 0; s < slices; ++s) {
      x += part[s * n + e];
      y += part[(slices + s) * n + e];
      z += part[(2 * slices + s) * n + e];
    }
    store(dr + e, x);
    store(dk + e, y);
    dw[e] = z;
  }
  if (e < hh) {
    float x = 0.0f;
    for (int b = 0; b < B; ++b)
      for (int s = 0; s < slices; ++s) x += du_part[(static_cast<int64_t>(s) * B + b) * hh + e];
    du[e] = x;
  }
}

template <typename T, int HD>
int launch(const Args& a, void* dr, void* dk, float* dw, float* du, cudaStream_t stream) {
  using D = Dims<HD>;
  const size_t smem = sizeof(float) * D::kFloats;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_bwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  wkv6_bwd_kernel<T, HD><<<dim3(D::kSlices * a.H, a.B), HD, smem, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(a.B) * a.S * a.H * HD;
  const int hh = a.H * HD;
  const int64_t work = n > hh ? n : hh;
  const unsigned blocks = static_cast<unsigned>((work + 255) / 256);
  wkv6_bwd_reduce_kernel<T><<<blocks, 256, 0, stream>>>(
      a.part, a.du_part, static_cast<T*>(dr), static_cast<T*>(dk), dw, du, n, D::kSlices,
      a.B, hh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const Args& a, int hd, void* dr, void* dk, float* dw, float* du,
              cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(a, dr, dk, dw, du, stream);
    case 32: return launch<T, 32>(a, dr, dk, dw, du, stream);
    case 64: return launch<T, 64>(a, dr, dk, dw, du, stream);
    case 128: return launch<T, 128>(a, dr, dk, dw, du, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Tokens between checkpoints and state columns a block: the wrapper sizes
// the scratch arrays with them.
extern "C" int wkv6_bwd_chunk() { return kChunk; }
extern "C" int wkv6_bwd_slice() { return kSlice; }

// r, k, v, dout, dr, dk, dv (batch, S, H, hd) of one type (dtype 0 =
// float32, 1 = bfloat16); w, dw (batch, S, H, hd), u, du (H, hd) and dstate
// (batch, H, hd, hd; null for zeros) float32; scratch ckpt (batch * H *
// slices * chunks * kSlice * hd), part (3 * slices * batch * S * H * hd) and
// du_part (slices * batch * H * hd) float32, with slices = hd / kSlice and
// chunks = ceil(S / kChunk): contiguous device arrays. Launches the two
// kernels on `stream` and returns cudaGetLastError() as an int (0 =
// launched).
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* dout,
                               const void* dstate, void* ckpt, void* part, void* du_part,
                               void* dr, void* dk, void* dv, void* dw, void* du,
                               int dtype, int batch, int S, int H, int hd, void* stream) {
  if (batch <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (S < 0 || batch > 65535 || H * (hd / kSlice) > 2147483647 / 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{r, k, v, static_cast<const float*>(w), static_cast<const float*>(u), dout,
               static_cast<const float*>(dstate), static_cast<float*>(ckpt),
               static_cast<float*>(part), static_cast<float*>(du_part), dv, batch, S, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dwf = static_cast<float*>(dw);
  float* duf = static_cast<float*>(du);
  if (dtype == 0) return launch_hd<float>(a, hd, dr, dk, dwf, duf, st);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(a, hd, dr, dk, dwf, duf, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
