// The timing engine's event replay, every interval of a run in one launch.
//
// No TPU counterpart: it stands for the JAX package's numpy replay loop,
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
// the tier's last finish, page_done takes each event's done in event order
// (the last write to a page wins, as numpy's fancy assignment), t_open
// becomes the window's earliest done and the makespan the latest done or
// channel. The kernel writes t_app[r] (float64).
//
// Bound: the serial chain, not bytes. A replay is one dependent sequence:
// a window waits on the previous window's t_open and on its pages'
// page_done loads (26 MB a replay at 3.25 M pages: an L2 or device-memory
// load latency a window), and each event adds a few dependent float64
// add/max steps. The bytes, about 26 read and 8 written an event, would take
// far less time at 3.35 TB/s than the chain.
//
// Design (the first, simple one): one thread owns one replay and walks its
// windows in order. Pass one reads every ready time of the window into the
// replay's scratch row (page_done must be read before the window writes
// it); pass two runs both tiers' recurrences in event order (they are
// independent, so one pass keeps each tier's order), writes page_done and
// tracks the window's min and max done. Adds and subtracts are __dadd_rn /
// __dsub_rn, which the compiler never contracts, and max is numpy's
// (a >= b ? a : b), so the result equals the plain version bit for bit.
// The wrapper zeroes page_done (n_pages doubles a replay) and allocates the
// ready rows (min(w_slots, events) doubles a replay); the kernel allocates
// nothing.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ double np_max(double a, double b) {
  return a >= b ? a : b;
}

__global__ void timing_replay_kernel(
    const int32_t* __restrict__ page, const int8_t* __restrict__ tier,
    const double* __restrict__ occ, const double* __restrict__ lat,
    const long long* __restrict__ ev_off, const long long* __restrict__ w_slots,
    const double* __restrict__ chan_in, const long long* __restrict__ pd_off,
    double* page_done_all, const long long* __restrict__ rd_off,
    double* ready_all, double* __restrict__ t_app, long long n_replays) {
  const long long r = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (r >= n_replays) return;
  const long long e0 = ev_off[r];
  const long long e1 = ev_off[r + 1];
  const long long w = w_slots[r];
  double* page_done = page_done_all + pd_off[r];
  double* ready = ready_all + rd_off[r];
  double chan0 = chan_in[2 * r];
  double chan1 = chan_in[2 * r + 1];
  double end = np_max(chan0, chan1);
  double t_open = 0.0;
  for (long long k = e0; k < e1; k += w) {
    const long long kend = k + w < e1 ? k + w : e1;
    for (long long j = k; j < kend; ++j)
      ready[j - k] = np_max(page_done[page[j]], t_open);
    double c0 = 0.0, c1 = 0.0;
    double base0 = -CUDART_INF, base1 = -CUDART_INF;
    double last0 = chan0, last1 = chan1;
    double dmin = CUDART_INF, dmax = -CUDART_INF;
    for (long long j = k; j < kend; ++j) {
      const double srv = occ[j];
      double finish;
      if (tier[j] == 0) {
        c0 = __dadd_rn(c0, srv);
        base0 = np_max(base0, __dsub_rn(ready[j - k], __dsub_rn(c0, srv)));
        finish = __dadd_rn(np_max(base0, chan0), c0);
        last0 = finish;
      } else {
        c1 = __dadd_rn(c1, srv);
        base1 = np_max(base1, __dsub_rn(ready[j - k], __dsub_rn(c1, srv)));
        finish = __dadd_rn(np_max(base1, chan1), c1);
        last1 = finish;
      }
      const double done = __dadd_rn(finish, lat[j]);
      page_done[page[j]] = done;
      dmin = done < dmin ? done : dmin;
      dmax = np_max(dmax, done);
    }
    chan0 = last0;
    chan1 = last1;
    t_open = dmin;
    end = np_max(end, dmax);
  }
  t_app[r] = np_max(end, np_max(chan0, chan1));
}

// The two links of the replay's serial chain, for its bound: one thread
// follows `steps` dependent loads through `next` (a random cycle over a
// buffer the size of a replay's page_done), or takes `steps` dependent
// float64 adds. The caller times two step counts and takes the difference.
__global__ void chain_probe_kernel(const long long* __restrict__ next,
                                   long long steps, int adds, double step,
                                   double* __restrict__ out) {
  if (adds) {
    double x = out[0];
    for (long long s = 0; s < steps; ++s) x = __dadd_rn(x, step);
    out[0] = x;
  } else {
    long long i = 0;
    for (long long s = 0; s < steps; ++s) i = next[i];
    out[0] = static_cast<double>(i);
  }
}

}  // namespace

// All pointers are device pointers: page (int32), tier (int8), occ and lat
// (float64) are the flat event streams; ev_off [R+1], w_slots [R], pd_off
// [R+1] and rd_off [R+1] (int64) the per-replay event ranges, window sizes
// and scratch offsets; chan [R, 2] (float64) the preloads; page_done (zeroed)
// and ready the scratch; t_app [R] the output. Launches on `stream` and
// returns cudaGetLastError() as an int (0 = launched).
extern "C" int timing_replay_launch(const void* page, const void* tier,
                                    const void* occ, const void* lat,
                                    const void* ev_off, const void* w_slots,
                                    const void* chan, const void* pd_off,
                                    void* page_done, const void* rd_off,
                                    void* ready, void* t_app,
                                    long long n_replays, void* stream) {
  if (n_replays <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n_replays + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  timing_replay_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(page), static_cast<const int8_t*>(tier),
      static_cast<const double*>(occ), static_cast<const double*>(lat),
      static_cast<const long long*>(ev_off),
      static_cast<const long long*>(w_slots),
      static_cast<const double*>(chan), static_cast<const long long*>(pd_off),
      static_cast<double*>(page_done), static_cast<const long long*>(rd_off),
      static_cast<double*>(ready), static_cast<double*>(t_app), n_replays);
  return static_cast<int>(cudaGetLastError());
}

// One thread of chain_probe_kernel on `stream`: `adds` = 0 chases `next`
// (device int64, a cycle starting at 0) for `steps` loads, otherwise adds
// `step` to out[0] `steps` times. Returns cudaGetLastError() as an int.
extern "C" int timing_chain_probe_launch(const void* next, long long steps,
                                         int adds, double step, void* out,
                                         void* stream) {
  chain_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(next), steps, adds, step,
      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
