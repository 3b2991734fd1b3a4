// Measurement harness: warmup -> estimate runs -> timed runs -> record.
//
// Reproduces the reference's skeleton (reference
// cpp/data_parallel/dp.cpp:234-264): barrier, warm-up loop (default 3),
// optional run-count estimation from warm-up times to hit a minimum total
// execution time (`-m`, reference cpp/utils.hpp:121-135 — intent kept,
// its divide-by-warmup-count bug fixed, SURVEY.md §7.4), timer reset,
// timed runs (default 5), and the infinite `PROXY_LOOP` congestor mode
// (dp.cpp:251-256).  Compute is simulated per the proxy schedule with a
// scaled sleep, the host-side analogue of the reference's `usleep`
// (dp.cpp:93) — the JAX tier replaces this with calibrated on-device burn
// kernels; the nccl fabric burns the card with a CUDA kernel in the
// same slot (csrc/burn.cu).
#pragma once

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstring>
#include <functional>
#include <string>
#include <thread>
#include <unistd.h>
#include <vector>

#include "dlnb/communicator.hpp"
#include "dlnb/energy.hpp"
#include "dlnb/timers.hpp"

namespace dlnb {

struct HarnessConfig {
  int warmup = 3;              // reference dp.cpp:65
  int runs = 5;                // reference dp.cpp:66
  double min_exectime_s = 0;   // reference -m flag
  bool loop = false;           // reference PROXY_LOOP
  double time_scale = 1.0;     // shrink simulated compute for dev boxes
  double size_scale = 1.0;     // shrink buffers for dev boxes
};

// True on a rank's thread while run_measured times its runs: a device
// fabric counts any host<->device copy made then (there should be none —
// twins are made in the warm-up).
inline bool& timed_window() {
  thread_local bool open = false;
  return open;
}

// Simulated compute for `us` microseconds, pre-scaled by the harness
// time_scale (reference usleep(t), dp.cpp:93).
inline void burn_us(double us, double time_scale = 1.0) {
  double scaled = us * time_scale;
  if (scaled <= 0) return;
  std::this_thread::sleep_for(
      std::chrono::duration<double, std::micro>(scaled));
}

// Scale an element count for dev boxes, keeping it positive.
inline std::int64_t scale_count(std::int64_t count, double size_scale) {
  if (size_scale >= 1.0) return count;
  auto scaled = static_cast<std::int64_t>(count * size_scale);
  return scaled > 0 ? scaled : 1;
}

// Runs needed so total measured time reaches min_exectime, from the mean
// warm-up time excluding the first `skip` iterations (reference
// utils.hpp:121-135 semantics, corrected mean).
inline int estimate_runs(const std::vector<double>& warmup_us,
                         double min_exectime_s, int skip = 2) {
  std::vector<double> usable(
      warmup_us.begin() +
          std::min<std::size_t>(skip, warmup_us.empty() ? 0
                                                        : warmup_us.size() - 1),
      warmup_us.end());
  if (usable.empty()) return 1;
  double sum = 0;
  for (double t : usable) sum += t;
  double mean_s = sum / usable.size() / 1e6;
  if (mean_s <= 0) return 1;
  return std::max(1, static_cast<int>(std::ceil(min_exectime_s / mean_s)));
}

// Per-rank measurement driver.  `step(timers)` runs one full iteration of
// the proxy schedule, instrumenting its collectives into `timers`; the
// whole iteration is timed as "runtimes".  `sync_comm` is the world (or
// widest) communicator used for the startup barrier and the cross-rank
// agreement on the estimated run count (reference allreduces warm-up means
// and broadcasts rank 0's decision, utils.hpp:121-135).
struct RankRun {
  std::vector<double> warmup_us;
  int runs = 0;
};

inline RankRun run_measured(
    const HarnessConfig& cfg, ProxyCommunicator& sync_comm, TimerSet& timers,
    const std::function<void(TimerSet&)>& step) {
  RankRun out;
  sync_comm.Barrier();

  for (int w = 0; w < std::max(cfg.warmup, 1); ++w) {
    auto t0 = Clock::now();
    step(timers);
    out.warmup_us.push_back(us_since(t0));
  }

  out.runs = cfg.runs;
  if (cfg.min_exectime_s > 0) {
    // agree across ranks: allreduce the local estimate, take the mean
    int local = estimate_runs(out.warmup_us, cfg.min_exectime_s);
    float in = static_cast<float>(local), sum = 0;
    // dtype-independent 1-element agreement via p2p-free allreduce: use
    // a dedicated f32 side channel through the same rendezvous
    std::vector<float> tmp_in(1, in), tmp_out(1, 0);
    if (sync_comm.dtype() == DType::F32) {
      sync_comm.Allreduce(tmp_in.data(), tmp_out.data(), 1);
      sum = tmp_out[0];
    } else {
      // narrow dtypes round-trip small integers exactly (bf16 up to 256,
      // fp8 up to 16) — convert through the comm dtype honestly.  Plain
      // vectors, not Tensors: a device fabric copies an unregistered
      // buffer back to the host after a blocking op.
      std::vector<unsigned char> a(4), b(4);
      store_element(a.data(), 0, sync_comm.dtype(), in);
      sync_comm.Allreduce(a.data(), b.data(), 1);
      sum = load_element(b.data(), 0, sync_comm.dtype());
    }
    out.runs = std::max(1, static_cast<int>(
                               std::lround(sum / sync_comm.size())));
  }

  if (cfg.loop) {  // reference PROXY_LOOP congestor mode
    while (true) step(timers);
  }

  timers.clear();  // reference clears timer vectors pre-measurement
  timed_window() = true;
  struct Close {
    ~Close() { timed_window() = false; }
  } close_window;

  // Per-run energy brackets (reference per-rank energy_consumed arrays,
  // plots/parser.py:172): energy is a HOST counter, so only the process's
  // designated rank records it — proxies pass the world communicator
  // here, whose rank() is the global rank proxy_runner designated.
  auto& meter = energy::Meter::instance();
  bool record_energy =
      meter.available() && meter.recording_rank.load() == sync_comm.rank();
  auto& ring = TelemetryRing::instance();
  for (int r = 0; r < out.runs; ++r) {
    double e0 = record_energy ? meter.read_joules() : 0.0;
    auto t0 = Clock::now();
    step(timers);
    double wall_us = us_since(t0);
    timers.record("runtimes", wall_us);
    if (record_energy)
      timers.record("energy_consumed",
                    std::max(0.0, meter.read_joules() - e0));
    // continuous telemetry: per-step flight ring, step
    // index in fault-plan units (warmup included) — the per-rank step
    // series analysis/critical_path.py merges into blame
    if (ring.enabled())
      ring.record(sync_comm.rank(), std::max(cfg.warmup, 1) + r,
                  wall_us);
  }
  if (record_energy) meter.relax();
  return out;
}

inline std::string local_hostname() {
  char buf[256] = {0};
  if (gethostname(buf, sizeof buf - 1) != 0) std::strcpy(buf, "localhost");
  return buf;
}

}  // namespace dlnb
