// The timing engine's event replay, every interval of a run in one call.
//
// No TPU counterpart: it replaces the JAX package's numpy replay loop,
// repro/timing/engine.py, AddressTimingEngine._replay (the loop at
// engine.py:218-247). Replay r owns events ev_off[r]..ev_off[r+1] of the
// flat streams (page index, tier, channel occupancy, latency), windows of
// w_slots[r] events and the two channels' preload chan[2r], chan[2r+1]. In
// each window every event becomes ready at max(page_done[page], t_open);
// per tier the events serialize through the channel by the single-server
// queue identity
//   c += occ;  base = max(base, ready - (c - occ));
//   finish = max(base, chan) + c;  done = finish + lat
// with chan the channel at the window's start; the channel then moves to
// the tier's last finish, page_done takes each event's done (the last
// write to a page wins), t_open becomes the window's earliest done and the
// makespan the latest done or channel. t_app[r] (float64) is the makespan.
//
// Bound: the float64 chain. Only t_open and the channels carry from one
// window to the next. On the straight path below, a one-event window puts
// 3 dependent steps on it: + c, a max with a term formed beside the chain,
// + lat (its t - dm is exact and dropped: dm is +0.0 there). A wider
// window adds t - dm and log2(lanes) shuffle steps for its earliest done. chain_latency_ns times the one-event window
// (window_chain_ns); bytes (21 an event read) and the float64 rate are far
// below the chain.
//
// Design. Rounding is monotone, so fl(max(a, b) - d) == max(fl(a - d),
// fl(b - d)): with d = c - occ, base is max(t_open - min(d), max of
// page_done - d), every max exact and in any order. So:
// - a pre-pass, parallel over every event of every replay, builds what
//   does not depend on the chain: each event's writer (the last event of
//   its replay and page in an earlier window, from a stable sort by
//   (replay, page) and a binary search; -1 for none) and each window's
//   per-tier prefix sums c (__dadd_rn in event order, as np.cumsum), d =
//   c - occ and dm, the prefix min of d;
// - the walker runs one warp a replay (one block each, no __syncthreads).
//   done is kept per event, so an event reads done[writer] and no address
//   is written twice: the loads of writers more than two chunks of 32
//   behind are issued two chunks ahead (event inputs three ahead, L2
//   prefetches 512 events ahead), and writers in the two chunks before come
//   from the lanes' registers by shuffle.
// - One-event windows run a straight path in chunks of 32 windows. By
//   monotone rounding a finish is max(t + c, q + c, chs + c); with c and
//   lat >= 0 every finish is at most the next open time, so a tier's
//   channel decides nothing once an event of the chunk (or of the fast
//   chunk before) has set it. So the next chunk is staged while this one
//   runs: writer terms q from the loads issued ahead and the chunk
//   before's done times, and one term m = max(q + c, chs + c) or q + c an
//   event, into a double-buffered shared-memory slot. The chain then reads
//   c, lat and m by broadcast, loaded ahead of it, and does + c, max,
//   + lat a window in every lane, so the warp never diverges. A
//   writer in the running chunk is patched in by one shuffle after its
//   chain; a chunk with a writer inside it, a short one, a non-zero dm or
//   inputs that are negative or not finite takes the chain window by
//   window, with both channels, from a per-lane copy of its done times.
// - Wider windows spread over the lanes in chunks of 32: the writer terms'
//   prefix max by shuffles (carried from chunk to chunk; with no writer in
//   the chunk, -dm: 0.0 - d is -d exactly), then one chain step a lane,
//   each tier's last finish by ballot, and the window's earliest done by
//   shuffles when it closes. Both paths keep each lane's latest done and
//   reduce it once, at the replay's end.
// Unlike one block a replay with ready times through a shared-memory ring,
// nothing but the float64 chain is serial: ready times are never formed,
// and no done load waits on the chain unless its writer is near.
//
// Adds and subtracts are __dadd_rn / __dsub_rn, which the compiler never
// contracts, and max is numpy's (a >= b ? a : b), so the result equals the
// plain version bit for bit. The wrapper allocates every buffer; the
// kernels allocate nothing.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPassThreads = 256;
constexpr int kPassBlocksPerSm = 16;
constexpr long long kL2Ahead = 512;          // events the walker prefetches ahead

__device__ __forceinline__ double np_max(double a, double b) {
  return a >= b ? a : b;
}

__device__ __forceinline__ double np_min(double a, double b) {
  return b < a ? b : a;
}

// The last r in [0, n) with off[r] <= i (off rises from off[0] = 0).
__device__ __forceinline__ long long owner(const long long* __restrict__ off,
                                           long long n, long long i) {
  long long lo = 0, hi = n - 1;
  while (lo < hi) {
    const long long mid = (lo + hi + 1) >> 1;
    if (off[mid] <= i) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The chain step of one event: the tier's finish from the window's open
// time t less the event's prefix min dm, its writer term q and the tier's
// channel, then + c. Maxima are exact, so max(q, chs) can be taken beside
// the chain.
__device__ __forceinline__ double finish_time(double t, double q, double dm,
                                              double c, double chs) {
  return __dadd_rn(np_max(__dsub_rn(t, dm), np_max(q, chs)), c);
}

// A one-event window: its done, which is the next window's open time; the
// event's tier channel moves to its finish.
__device__ __forceinline__ double one_event_window(double t, double q, double dm,
                                                   double c, double lat, bool t1,
                                                   double& ch0, double& ch1) {
  const double f = finish_time(t, q, dm, c, t1 ? ch1 : ch0);
  if (t1) ch1 = f; else ch0 = f;
  return __dadd_rn(f, lat);
}

// Finite with the sign bit clear: +0.0 up to the largest double. Sums of
// such values are never -0.0 or NaN, so over them every max is exact in
// any order and equal values have equal bits.
__device__ __forceinline__ bool clean(double x) {
  return static_cast<unsigned long long>(__double_as_longlong(x)) < 0x7ff0000000000000ull;
}

// One window of the fast chain, on clean inputs: the finish max(t + c, m)
// with m formed beside the chain, then the done. Returns the finish.
__device__ __forceinline__ double fast_window(double& t, double m, double c, double lat) {
  const double f = np_max(__dadd_rn(t, c), m);
  t = __dadd_rn(f, lat);
  return f;
}

// ------------------------------------------------------------- pre-pass

// key[j] = the first slot of j's replay + page[j]: unique per (replay, page).
__global__ void replay_key_kernel(const int32_t* __restrict__ page,
                                  const long long* __restrict__ ev_off,
                                  const long long* __restrict__ pd_off,
                                  long long n_rep, long long n_ev,
                                  long long* __restrict__ key) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       j < n_ev; j += stride)
    key[j] = pd_off[owner(ev_off, n_rep, j)] + page[j];
}

// writer[j] for the event at each sorted position s. Within a key the
// events are in order, so the entries of j's key in j's window end at s
// and start at most j - (window start) before it; the entry before them,
// if of the same key, is the last earlier-window event of j's page.
__global__ void writer_kernel(const long long* __restrict__ skey,
                              const long long* __restrict__ order,
                              const long long* __restrict__ ev_off,
                              const long long* __restrict__ w_slots,
                              long long n_rep, long long n_ev,
                              int32_t* __restrict__ writer) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long s = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       s < n_ev; s += stride) {
    const long long j = order[s], key = skey[s];
    const long long r = owner(ev_off, n_rep, j);
    const long long e0 = ev_off[r], w = w_slots[r];
    const long long ws = e0 + (j - e0) / w * w;
    long long lo = s - (j - ws) > 0 ? s - (j - ws) : 0, hi = s;
    while (lo < hi) {  // the first entry of j's key at or after ws
      const long long mid = (lo + hi) >> 1;
      if (skey[mid] == key && order[mid] >= ws) hi = mid; else lo = mid + 1;
    }
    writer[j] = lo > 0 && skey[lo - 1] == key ? static_cast<int32_t>(order[lo - 1]) : -1;
  }
}

// One thread a window: each tier's prefix sum c in event order (from -0.0,
// so the first sum is occ itself, as np.cumsum's), d = c - occ and the
// prefix min dm of d.
__global__ void window_prefix_kernel(const int8_t* __restrict__ tier,
                                     const double* __restrict__ occ,
                                     const long long* __restrict__ ev_off,
                                     const long long* __restrict__ w_slots,
                                     const long long* __restrict__ win_off,
                                     long long n_rep, long long n_win,
                                     double* __restrict__ c,
                                     double* __restrict__ d,
                                     double* __restrict__ dm) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       g < n_win; g += stride) {
    const long long r = owner(win_off, n_rep, g);
    const long long w = w_slots[r];
    const long long k0 = ev_off[r] + (g - win_off[r]) * w;
    const long long k1 = k0 + w < ev_off[r + 1] ? k0 + w : ev_off[r + 1];
    double c0 = -0.0, c1 = -0.0, m0 = CUDART_INF, m1 = CUDART_INF;
    for (long long j = k0; j < k1; ++j) {
      const double o = occ[j];
      if (tier[j] == 0) {
        c0 = __dadd_rn(c0, o);
        const double dj = __dsub_rn(c0, o);
        m0 = np_min(m0, dj);
        c[j] = c0; d[j] = dj; dm[j] = m0;
      } else {
        c1 = __dadd_rn(c1, o);
        const double dj = __dsub_rn(c1, o);
        m1 = np_min(m1, dj);
        c[j] = c1; d[j] = dj; dm[j] = m1;
      }
    }
  }
}

// --------------------------------------------------------------- walker

// Up to 32 events of one window (of the whole replay on the straight path).
struct Chunk {
  long long cs;    // first event
  long long wend;  // end of its window
  int len;         // events, 0 past the replay's end
};

__device__ __forceinline__ Chunk next_chunk(const Chunk& k, long long w, long long e1) {
  Chunk n;
  n.cs = k.cs + k.len;
  n.wend = n.cs < k.wend ? k.wend : (n.cs + w < e1 ? n.cs + w : e1);
  n.len = n.cs < e1 ? static_cast<int>(n.wend - n.cs < kWarp ? n.wend - n.cs : kWarp) : 0;
  return n;
}

// One lane's event of a chunk.
struct Event {
  double d, dm, c, lat;
  int tier, wr;
};

struct Streams {
  const int8_t* __restrict__ tier;
  const double* __restrict__ lat;
  const int32_t* __restrict__ writer;
  const double* __restrict__ c;
  const double* __restrict__ d;
  const double* __restrict__ dm;
};

// Every lane loads at an index inside the replay (e1 > its first event);
// a lane past the chunk takes an empty event.
__device__ __forceinline__ Event load_event(const Streams& in, const Chunk& k, int lane,
                                            long long e1) {
  const long long j = k.cs + lane < e1 ? k.cs + lane : e1 - 1;
  const bool in_chunk = lane < k.len;
  return Event{in_chunk ? in.d[j] : 0.0,    in_chunk ? in.dm[j] : 0.0,
               in_chunk ? in.c[j] : 0.0,    in_chunk ? in.lat[j] : 0.0,
               in_chunk ? in.tier[j] : 0,   in_chunk ? in.writer[j] : -1};
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// One lane's event of a straight-path chunk, staged for its chain: the
// writer term q (done[writer] - d; d itself while the writer's done is
// still to come), qc = q + c, c, lat and dm; tag bit 0 its tier, bit 1 a writer in
// the same chunk (its lane from bit 2); fix a writer in the chunk whose
// chain runs while this one is staged.
struct Staged {
  double q, qc, c, lat, dm;
  int tag;
  bool fix;
};

// Stages this lane's event e of chunk k while the chunk at `cur` runs its
// chain: a writer before `prev` takes `far` (its load issued ahead, 0.0
// without a writer), one in the chunk at `prev` that chunk's done times
// (one a lane), one at `cur` is fixed after cur's chain, one in k itself
// is resolved on the chain.
__device__ __forceinline__ Staged stage(const Event& e, const Chunk& k, double far,
                                        double prev_done, long long prev, long long cur) {
  Staged s{e.d, 0.0, e.c, e.lat, e.dm, e.tier != 0 ? 1 : 0, false};
  const double v = __shfl_sync(kFull, prev_done, static_cast<int>(e.wr - prev) & (kWarp - 1));
  if (e.wr >= k.cs) s.tag |= 2 | static_cast<int>(e.wr - k.cs) << 2;
  else if (e.wr >= cur) s.fix = true;
  else s.q = __dsub_rn(e.wr >= prev ? v : far, e.d);
  s.qc = __dadd_rn(s.q, e.c);
  return s;
}

// Whether a staged chunk may take the straight path's fast chain: 32
// events, no writer among them, every dm +0.0 (bit for bit) and q, c and
// lat clean. The chain's state must be clean too, which the caller checks.
__device__ __forceinline__ bool fast_chunk(const Staged& s, const Chunk& k) {
  return k.len == kWarp && !__any_sync(kFull, s.tag & 2) &&
         __all_sync(kFull, __double_as_longlong(s.dm) == 0 && clean(s.q) && clean(s.c) &&
                               clean(s.lat));
}

// The term m of a staged event beside t + c on the fast chain. A finish is
// fl(max(t - dm, q, chs) + c) with dm +0.0 (as the pre-pass makes it for
// every finite occ of a one-event window), which by monotone rounding is
// max(t + c, q + c, chs + c) on clean values. In a fast chunk, c >= 0 and
// lat >= 0 make every finish at most the next open time, so a tier's
// channel, once an event of the chunk has set it, decides nothing: only
// the first event of each tier takes chs + c, and not even that where
// `keep` for its tier is false (the chunk before was fast and held an
// event of that tier).
__device__ __forceinline__ double chunk_term(const Staged& s, unsigned tiers, int lane,
                                             double ch0, double ch1, bool keep0, bool keep1) {
  const bool t1 = s.tag & 1;
  const bool first = ((t1 ? tiers : ~tiers) & ((1u << lane) - 1u)) == 0u;
  return first && (t1 ? keep1 : keep0) ? np_max(s.qc, __dadd_rn(t1 ? ch1 : ch0, s.c)) : s.qc;
}

// The fast chain of a chunk whose c, lat (cl) and m lie in shared memory:
// every lane runs its 32 windows, the inputs broadcast from shared memory
// ahead of the chain (nothing is stored in the loop, so every load may
// issue early), and returns its own event's finish.
__device__ __forceinline__ double fast_chain(const double2* __restrict__ cl,
                                             const double* __restrict__ m, int lane,
                                             double& t) {
  double mine = 0.0;
#pragma unroll
  for (int i = 0; i < kWarp; ++i) {
    const double2 x = cl[i];
    const double f = fast_window(t, m[i], x.x, x.y);
    mine = lane == i ? f : mine;
  }
  return mine;
}

// Any other staged chunk, window by window: a writer in the chunk reads
// its done from this lane's copy of the chunk's done times.
__device__ __forceinline__ double slow_chain(const Staged& s, int len, int lane, double& t,
                                             double& ch0, double& ch1) {
  double chunk_done[kWarp];
  double mine = 0.0;
  for (int i = 0; i < len; ++i) {
    const int tag = __shfl_sync(kFull, s.tag, i);
    double q = __shfl_sync(kFull, s.q, i);
    const double dm = __shfl_sync(kFull, s.dm, i);
    const double c = __shfl_sync(kFull, s.c, i);
    const double lat = __shfl_sync(kFull, s.lat, i);
    if (tag & 2) q = __dsub_rn(chunk_done[tag >> 2], q);
    t = one_event_window(t, q, dm, c, lat, tag & 1, ch0, ch1);
    chunk_done[i] = t;
    if (lane == i) mine = t;
  }
  return mine;
}

// One warp a replay (one block each). done [events] (float64) takes every
// event's done time; t_app [R] the makespans.
__global__ void __launch_bounds__(kWarp) replay_walk_kernel(
    Streams in, const long long* __restrict__ ev_off,
    const long long* __restrict__ w_slots, const double* __restrict__ chan_in,
    double* done, double* __restrict__ t_app) {
  const long long r = blockIdx.x;
  const int lane = threadIdx.x;
  const long long e0 = ev_off[r], e1 = ev_off[r + 1], w = w_slots[r];
  const bool straight = w == 1;
  // the straight path cuts the replay into chunks of 32 across windows
  const long long cw = straight ? (e1 > e0 ? e1 - e0 : 1) : w;
  double ch0 = chan_in[2 * r], ch1 = chan_in[2 * r + 1];
  const double preload = np_max(ch0, ch1);
  double t = 0.0;
  // each lane's latest done in the replay; wider windows: the open
  // window's writer-term carries, each lane's earliest done in it, each
  // tier's last finish in it
  double q0 = -CUDART_INF, q1 = -CUDART_INF, lane_lo = CUDART_INF, lane_hi = -CUDART_INF;
  double lf0 = 0.0, lf1 = 0.0;
  bool has0 = false, has1 = false;

  Chunk k0{e0, e0 + cw < e1 ? e0 + cw : e1, 0};
  k0.len = e0 < e1 ? static_cast<int>(k0.wend - e0 < kWarp ? k0.wend - e0 : kWarp) : 0;
  Chunk k1 = next_chunk(k0, cw, e1), k2 = next_chunk(k1, cw, e1);
  const Event none{0.0, 0.0, 0.0, 0.0, 0, -1};
  Event a = none, b = none, c = none;
  if (e1 > e0) {
    a = load_event(in, k0, lane, e1);
    b = load_event(in, k1, lane, e1);
    c = load_event(in, k2, lane, e1);
  }
  double pd_a = 0.0, pd_b = 0.0;  // no writer lies before the replay
  long long cs1 = e0, cs2 = e0;   // first events of the two chunks before
  double done1 = 0.0, done2 = 0.0;  // their done times, one a lane
  // the straight path: the staged chunk k0 (its writers can only lie in
  // it), its tiers, and its fast chain's inputs in slot sl of s_cl and s_m
  __shared__ double2 s_cl[2][kWarp];
  __shared__ double s_m[2][kWarp];
  int sl = 0;
  Staged cur = stage(a, k0, 0.0, 0.0, e0, e0);
  bool cur_fast = fast_chunk(cur, k0);
  unsigned cur_tiers = __ballot_sync(kFull, cur.tag & 1);
  s_cl[0][lane] = make_double2(cur.c, cur.lat);
  s_m[0][lane] = chunk_term(cur, cur_tiers, lane, ch0, ch1, true, true);
  __syncwarp();

  while (k0.len > 0) {
    const Chunk k3 = next_chunk(k2, cw, e1);
    Event next;
    double pd_c;
    // chunk k3's inputs, chunk k2's far writers (every event before k0 is
    // stored) and the L2 prefetch ahead, issued inside each path after its
    // branch, which timed faster than before it (PERF.md)
    const auto issue_loads = [&]() {
      next = load_event(in, k3, lane, e1);
      pd_c = c.wr >= 0 && c.wr < k0.cs ? done[c.wr] : 0.0;
      const long long jp = k0.cs + kL2Ahead + lane < e1 ? k0.cs + kL2Ahead + lane : e1 - 1;
      prefetch_l2(in.d + jp); prefetch_l2(in.dm + jp); prefetch_l2(in.c + jp);
      prefetch_l2(in.lat + jp); prefetch_l2(in.tier + jp); prefetch_l2(in.writer + jp);
    };
    double mine;
    if (straight) {
      // k1 is staged beside k0's chain: its shuffles and adds are formed
      // before the chain, its shared stores follow it
      Staged nx;
      unsigned nt;
      bool keep0 = true, keep1 = true;
      if (cur_fast && clean(t) && clean(ch0) && clean(ch1)) {
        issue_loads();
        nx = stage(b, k1, pd_b, done1, cs1, k0.cs);
        nt = __ballot_sync(kFull, nx.tag & 1);
        keep0 = cur_tiers == kFull;  // k0 holds no event of tier 0
        keep1 = cur_tiers == 0u;
        const double term = chunk_term(nx, nt, lane, ch0, ch1, keep0, keep1);
        const double fin = fast_chain(s_cl[sl], s_m[sl], lane, t);
        // stored after the chain, so no chain load waits behind them
        s_cl[sl ^ 1][lane] = make_double2(nx.c, nx.lat);
        s_m[sl ^ 1][lane] = term;
        mine = __dadd_rn(fin, cur.lat);  // as the chain added it
        // each tier's channel: its last finish in k0
        const double l0 = __shfl_sync(kFull, fin, 31 - __clz(~cur_tiers | 1u));
        const double l1 = __shfl_sync(kFull, fin, 31 - __clz(cur_tiers | 1u));
        if (!keep0) ch0 = l0;
        if (!keep1) ch1 = l1;
      } else {
        issue_loads();
        nx = stage(b, k1, pd_b, done1, cs1, k0.cs);
        nt = __ballot_sync(kFull, nx.tag & 1);
        mine = slow_chain(cur, k0.len, lane, t, ch0, ch1);
        s_cl[sl ^ 1][lane] = make_double2(nx.c, nx.lat);
        s_m[sl ^ 1][lane] = chunk_term(nx, nt, lane, ch0, ch1, true, true);
      }
      if (__any_sync(kFull, nx.fix)) {  // k1's writers in k0
        const double v = __shfl_sync(kFull, mine, static_cast<int>(b.wr - k0.cs) & (kWarp - 1));
        if (nx.fix) {
          nx.q = __dsub_rn(v, nx.q);
          nx.qc = __dadd_rn(nx.q, nx.c);
          s_m[sl ^ 1][lane] = chunk_term(nx, nt, lane, ch0, ch1, keep0, keep1);
        }
      }
      cur_fast = fast_chunk(nx, k1);
      cur_tiers = nt;
      cur = nx;
      sl ^= 1;
    } else {
      issue_loads();
      // this lane's writer: far (prefetched) or in one of the two chunks
      // before (their lanes' registers)
      const double v1 = __shfl_sync(kFull, done1, static_cast<int>(a.wr - cs1) & (kWarp - 1));
      const double v2 = __shfl_sync(kFull, done2, static_cast<int>(a.wr - cs2) & (kWarp - 1));
      const double pd = a.wr < 0 ? 0.0 : a.wr < cs2 ? pd_a : a.wr < cs1 ? v2 : v1;
      const bool valid = lane < k0.len;
      const bool t1 = a.tier != 0;
      const unsigned b0 = __ballot_sync(kFull, valid && !t1);
      const unsigned b1 = __ballot_sync(kFull, valid && t1);
      // this lane's tier's writer terms, max over the window up to it
      double x;
      if (__any_sync(kFull, valid && a.wr >= 0)) {
        const double v = __dsub_rn(pd, a.d);
        double x0 = valid && !t1 ? v : -CUDART_INF;
        double x1 = valid && t1 ? v : -CUDART_INF;
#pragma unroll
        for (int off = 1; off < kWarp; off <<= 1) {
          const double u0 = __shfl_up_sync(kFull, x0, off);
          const double u1 = __shfl_up_sync(kFull, x1, off);
          if (lane >= off) {
            x0 = np_max(x0, u0);
            x1 = np_max(x1, u1);
          }
        }
        x0 = np_max(x0, q0);
        x1 = np_max(x1, q1);
        q0 = __shfl_sync(kFull, x0, kWarp - 1);
        q1 = __shfl_sync(kFull, x1, kWarp - 1);
        x = t1 ? x1 : x0;
      } else {
        // no writer: each term is 0.0 - d = -d, whose running max is -dm
        x = np_max(-a.dm, t1 ? q1 : q0);
        const double l0 = __shfl_sync(kFull, x, b0 ? 31 - __clz(b0) : 0);
        const double l1 = __shfl_sync(kFull, x, b1 ? 31 - __clz(b1) : 0);
        if (b0) q0 = l0;
        if (b1) q1 = l1;
      }
      const double f = finish_time(t, x, a.dm, a.c, t1 ? ch1 : ch0);
      mine = __dadd_rn(f, a.lat);
      if (valid) lane_lo = np_min(lane_lo, mine);
      const double f0 = __shfl_sync(kFull, f, b0 ? 31 - __clz(b0) : 0);
      const double f1 = __shfl_sync(kFull, f, b1 ? 31 - __clz(b1) : 0);
      if (b0) { lf0 = f0; has0 = true; }
      if (b1) { lf1 = f1; has1 = true; }
      if (k0.cs + k0.len == k0.wend) {  // the window closes at its earliest done
#pragma unroll
        for (int off = kWarp / 2; off > 0; off >>= 1)
          lane_lo = np_min(lane_lo, __shfl_xor_sync(kFull, lane_lo, off));
        t = lane_lo;
        if (has0) ch0 = lf0;
        if (has1) ch1 = lf1;
        q0 = q1 = -CUDART_INF;
        lane_lo = CUDART_INF;
        has0 = has1 = false;
      }
    }
    if (lane < k0.len) {
      done[k0.cs + lane] = mine;
      lane_hi = np_max(lane_hi, mine);  // the makespan's max, reduced at the end
    }
    __syncwarp();  // the stores before any lane's next loads
    done2 = done1; done1 = mine; cs2 = cs1; cs1 = k0.cs;
    k0 = k1; k1 = k2; k2 = k3;
    a = b; b = c; c = next;
    pd_a = pd_b; pd_b = pd_c;
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    lane_hi = np_max(lane_hi, __shfl_xor_sync(kFull, lane_hi, off));
  if (lane == 0) t_app[r] = np_max(np_max(preload, lane_hi), np_max(ch0, ch1));
}

// ---------------------------------------------------------- chain probe

constexpr int kProbeLoads = 0;
constexpr int kProbeAdds = 1;
constexpr int kProbeWindow = 2;
constexpr int kProbeShuffle = 3;

// The links of the replay's serial chain, for its bound. Lane 0 follows
// `steps` dependent loads through `next` (a random cycle over a buffer the
// size of a replay's page_done), takes `steps` dependent float64 adds, or
// runs `steps` one-event windows as the walker's fast chain does
// (fast_window: + c, a max with a value formed beside the chain, + lat);
// or the warp takes `steps` dependent shuffle-and-min steps. The caller
// times two step counts and takes the difference. `mask` is unused.
__global__ void chain_probe_kernel(const long long* __restrict__ next,
                                   long long steps, int mode, double step,
                                   unsigned long long mask,
                                   double* __restrict__ out) {
  if (mode == kProbeShuffle) {
    double x = __dadd_rn(out[0], static_cast<double>(threadIdx.x));
    for (long long s = 0; s < steps; s += 5) {
#pragma unroll
      for (int off = 1; off < kWarp; off <<= 1) x = np_min(x, __shfl_xor_sync(kFull, x, off));
    }
    if (threadIdx.x == 0) out[0] = x;
    return;
  }
  if (threadIdx.x != 0) return;
  if (mode == kProbeAdds) {
    double x = out[0];
    for (long long s = 0; s < steps; ++s) x = __dadd_rn(x, step);
    out[0] = x;
  } else if (mode == kProbeWindow) {
    double t = out[0], f = 0.0;
    const double m = out[1], c = step, lat = step;
    for (long long s = 0; s < steps; ++s) f = fast_window(t, m, c, lat);
    out[0] = __dadd_rn(t, f);
  } else if (mode == kProbeLoads) {
    long long i = 0;
    for (long long s = 0; s < steps; ++s) i = next[i];
    out[0] = static_cast<double>(i);
  }
}

// Grid-stride passes: at most kPassBlocksPerSm blocks on each of the
// current device's SMs.
unsigned int pass_blocks(long long n) {
  int dev = 0, sms = 1;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 1;
  const long long cap = static_cast<long long>(kPassBlocksPerSm) * (sms > 0 ? sms : 1);
  const long long b = (n + kPassThreads - 1) / kPassThreads;
  return static_cast<unsigned int>(b < cap ? b : cap);
}

}  // namespace

// All pointers are device pointers. Pre-pass, first launch: key [n_ev]
// (int64) from page (int32), ev_off [R+1] and pd_off [R+1] (int64, the
// exclusive prefix sum of n_pages). Returns cudaGetLastError() as an int.
extern "C" int timing_replay_keys_launch(const void* page, const void* ev_off,
                                         const void* pd_off, long long n_rep,
                                         long long n_ev, void* key, void* stream) {
  if (n_ev <= 0) return static_cast<int>(cudaSuccess);
  replay_key_kernel<<<pass_blocks(n_ev), kPassThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(page), static_cast<const long long*>(ev_off),
      static_cast<const long long*>(pd_off), n_rep, n_ev, static_cast<long long*>(key));
  return static_cast<int>(cudaGetLastError());
}

// Pre-pass, second launch: from skey and order (int64 [n_ev], the keys
// sorted stably and their event indices), tier (int8), occ (float64),
// ev_off, w_slots (int64 [R]) and win_off (int64 [R+1], the exclusive prefix
// sum of each replay's window count, n_win in all) writes writer (int32
// [n_ev]) and c, d, dm (float64 [n_ev]).
extern "C" int timing_replay_prepass_launch(
    const void* skey, const void* order, const void* tier, const void* occ,
    const void* ev_off, const void* w_slots, const void* win_off, long long n_rep,
    long long n_ev, long long n_win, void* writer, void* c, void* d, void* dm,
    void* stream) {
  if (n_ev <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  writer_kernel<<<pass_blocks(n_ev), kPassThreads, 0, st>>>(
      static_cast<const long long*>(skey), static_cast<const long long*>(order),
      static_cast<const long long*>(ev_off), static_cast<const long long*>(w_slots),
      n_rep, n_ev, static_cast<int32_t*>(writer));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  window_prefix_kernel<<<pass_blocks(n_win), kPassThreads, 0, st>>>(
      static_cast<const int8_t*>(tier), static_cast<const double*>(occ),
      static_cast<const long long*>(ev_off), static_cast<const long long*>(w_slots),
      static_cast<const long long*>(win_off), n_rep, n_win, static_cast<double*>(c),
      static_cast<double*>(d), static_cast<double*>(dm));
  return static_cast<int>(cudaGetLastError());
}

// The walker: one warp a replay over the pre-pass's writer (int32), c, d,
// dm (float64) and tier (int8), lat (float64), ev_off, w_slots (int64) and
// chan [R, 2] (float64); done [n_ev] (float64) is its scratch, t_app [R]
// (float64) its output.
extern "C" int timing_replay_walk_launch(const void* tier, const void* lat,
                                         const void* writer, const void* c,
                                         const void* d, const void* dm,
                                         const void* ev_off, const void* w_slots,
                                         const void* chan, void* done, void* t_app,
                                         long long n_rep, void* stream) {
  if (n_rep <= 0) return static_cast<int>(cudaSuccess);
  if (n_rep > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  const Streams in{static_cast<const int8_t*>(tier), static_cast<const double*>(lat),
                   static_cast<const int32_t*>(writer), static_cast<const double*>(c),
                   static_cast<const double*>(d), static_cast<const double*>(dm)};
  replay_walk_kernel<<<static_cast<unsigned int>(n_rep), kWarp, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const long long*>(ev_off), static_cast<const long long*>(w_slots),
      static_cast<const double*>(chan), static_cast<double*>(done),
      static_cast<double*>(t_app));
  return static_cast<int>(cudaGetLastError());
}

// One warp of chain_probe_kernel on `stream` (`mode`: 0 loads through
// `next`, device int64, a cycle starting at 0; 1 adds of `step`; 2 one-event
// windows; 3 shuffle steps; `steps` a multiple of 5 for mode 3). out[0..1]
// (device float64) seed the chain and take its result. Returns
// cudaGetLastError() as an int.
extern "C" int timing_chain_probe_launch(const void* next, long long steps,
                                         int mode, double step,
                                         unsigned long long mask, void* out,
                                         void* stream) {
  chain_probe_kernel<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(next), steps, mode, step, mask,
      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
