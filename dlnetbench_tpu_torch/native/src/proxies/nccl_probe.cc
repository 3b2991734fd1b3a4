// What the nccl backend would run on: the NCCL library and its version,
// the cards and their peer access, and the burn kernel's calibration —
// one JSON line.  `available: false` with a reason when something is
// missing (no card, no loadable libnccl.so.2, a CPU-flavour build).
//
//   nccl_probe                      the report
//   nccl_probe --burn-check N --seed S --out F
//                                   write the seeded check state
//                                   (check_state) and the state after N
//                                   iterations (bf16, raw, 256 x 256
//                                   each) to F
//   nccl_probe --burn-ms T,T,...    request burns of T ms after calibrating,
//                                   as the fabric queues them (the chain
//                                   stopped on the device timer, then the
//                                   spin to the time asked), and time them
//                                   with CUDA events and the burn's clock
//   nccl_probe --time-iters N       one burn of N iterations, timed with
//                                   CUDA events (8 back to back, behind a
//                                   device spin)
//   nccl_probe --gaps 0,1,10,100    time a chain kGapReps times after idle
//                                   gaps of those many ms (the burn's two
//                                   speed levels)
//   nccl_probe --hold-sms 32,100    the burn's start delay beside work
//                                   that holds that many SMs for
//                                   kHoldMs (one spinning block an SM, on
//                                   a second stream): us from the
//                                   holders' start to the burn's, and to
//                                   the end of the kernel it queued
//                                   behind (which waits for them all)
#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <iostream>
#include <string>
#include <thread>
#include <vector>

#include "dlnb/args.hpp"
#include "dlnb/json.hpp"
#include "dlnb/nccl_fabric.hpp"
#include "dlnb/topology.hpp"

using namespace dlnb;

constexpr int kGapReps = 8;  // chains timed after each --gaps gap
constexpr double kHoldMs = 1.0;  // --hold-sms: how long the SMs are held
constexpr int kHoldIters = 64;   // --hold-sms: the burn queued behind

// bf16 bits of `f`, rounded to nearest even
std::uint16_t to_bf16(float f) {
  std::uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return static_cast<std::uint16_t>(u >> 16);
}

double unit(std::uint64_t seed, std::uint64_t i) {  // [0, 1), as burn.cu's
  std::uint64_t x = seed * 0x100000001b3ULL + i + 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  x ^= x >> 31;
  return static_cast<double>(x >> 40) / static_cast<double>(1ULL << 24);
}

// The burn check's state, 3 r_i c_j with r and c uniform in (0.25, 1)
// from the seed.  The sup norm m of any chain falls as m <- tanh(m^2)
// once below 1, and a state of mixed signs cancels in its sums and
// reaches 0 within 8 iterations.  This one is positive and rank one: its
// chain keeps a row profile r and a column profile c (a transposed
// operand swaps them), stays a normal bf16 number (about 1e-16) after 8
// iterations, and its first product is of order one, so tanh bends it.
std::vector<std::uint16_t> check_state(std::uint64_t seed) {
  std::vector<double> r(256), c(256);
  for (int i = 0; i < 256; ++i) {
    r[i] = 0.25 + 0.75 * unit(seed, i);
    c[i] = 0.25 + 0.75 * unit(seed, 256 + i);
  }
  std::vector<std::uint16_t> out(256 * 256);
  for (int i = 0; i < 256; ++i)
    for (int j = 0; j < 256; ++j)
      out[i * 256 + j] = to_bf16(static_cast<float>(3.0 * r[i] * c[j]));
  return out;
}

int main(int argc, char** argv) {
  Args args("nccl_probe — the nccl backend's library, cards and burn");
  args.optional_str("nccl_impl", "real", "real | host")
      .optional_int("device", 0, "card for the burn")
      .optional_int("burn-check", 0, "iterations of the seeded burn check")
      .optional_int("seed", 0, "the burn check's seed")
      .optional_str("out", "", "the burn check's output file")
      .optional_str("burn-ms", "", "requested burns to time, in ms")
      .optional_int("time-iters", 0, "a burn of this many iterations to time")
      .optional_str("gaps", "", "idle gaps before timed chains, in ms")
      .optional_str("hold-sms", "",
                    "SMs held beside a burn, for its start delay");
  args.parse(argc, argv);
  Json rep = Json::object();
  std::string impl = args.str("nccl_impl");
  rep["nccl_impl"] = impl;
  try {
    auto dev = nccl::make_device(impl);
    int n = dev->count();
    if (impl != "host" && n == 0)
      throw std::runtime_error("no CUDA device is visible");
    nccl::Api api = nccl::load(impl);
    rep["nccl_library"] = api.library;
    rep["nccl_version"] = api.version_string();
    rep["device_count"] = n;
    Json cards = Json::array();
    for (int i = 0; i < n; ++i) {
      Json c = Json::object();
      c["index"] = i;
      c["name"] = dev->name(i);
      Json peers = Json::array();
      for (int j = 0; j < n; ++j)
        if (j != i && dev->peer_access(i, j)) peers.push_back(j);
      c["peers"] = peers;
      cards.push_back(c);
    }
    rep["cards"] = cards;
    rep["available"] = true;
    if (dev->can_burn()) {
      int d = static_cast<int>(args.integer("device"));
      dev->set(d);
      nccl::Stream s = dev->stream();
      void* state = dev->alloc(kBurnStateBytes);
      Json burn = Json::object();
      burn["width"] = 256;
      int cluster = 0, smem = 0, clusters = 0;
      dev->burn_shape(cluster, smem, clusters);
      burn["cluster"] = cluster;
      burn["smem_bytes"] = smem;
      burn["max_active_clusters"] = clusters;
      long long check = args.integer("burn-check");
      if (check > 0) {
        auto init = check_state(
            static_cast<std::uint64_t>(args.integer("seed")));
        std::vector<char> fin(kBurnStateBytes);
        dev->h2d(state, init.data(), kBurnStateBytes);
        long launches = dev->burn(state, check, s);
        dev->sync(s);
        dev->d2h(fin.data(), state, kBurnStateBytes);
        std::ofstream f(args.str("out"), std::ios::binary);
        f.write(reinterpret_cast<const char*>(init.data()), kBurnStateBytes);
        f.write(fin.data(), fin.size());
        if (!f) throw std::runtime_error("cannot write " + args.str("out"));
        burn["check_iters"] = check;
        burn["check_launches"] = static_cast<std::int64_t>(launches);
        burn["check_out"] = args.str("out");
      }
      dev->burn_init(state, 1, s);
      burn["timer_tick_ns"] = static_cast<std::int64_t>(dev->timer_tick_ns());
      auto t0 = std::chrono::steady_clock::now();
      BurnFit fit = calibrate_burn(*dev, state, s);
      burn["calibration_s"] = std::chrono::duration<double>(
                                  std::chrono::steady_clock::now() - t0)
                                  .count();
      burn["ns_per_iter"] = fit.ns_per_iter;
      burn["fixed_ns"] = fit.fixed_ns;
      std::string want = args.str("burn-ms");
      if (!want.empty()) {
        // each request timed three times by CUDA events around `reps`
        // burns back to back (as many as make 20 ms), and by the clock
        void* clock = dev->alloc(dev->burn_clock_bytes());
        Json rows = Json::array();
        for (const auto& w : split_csv(want, ',')) {
          double want_ms = std::stod(w);
          auto want_ns = std::llround(want_ms * 1e6);
          int reps = static_cast<int>(
              std::clamp(20.0 / want_ms, 1.0, 10000.0));
          std::uint64_t spent0, iters0, spent1, iters1;
          dev->burn_clock_read(clock, spent0, iters0);
          Json got = Json::array();
          for (int i = 0; i < 3; ++i)
            got.push_back(dev->timed_ms(
                [&] { queue_burn(*dev, state, clock, want_ns, fit, s); },
                reps, s));
          dev->burn_clock_read(clock, spent1, iters1);
          double clock_ms =
              static_cast<double>(spent1 - spent0) / 1e6 / (3.0 * reps);
          Json row = Json::object();
          row["requested_ms"] = want_ms;
          row["iters"] = static_cast<double>(iters1 - iters0) / (3.0 * reps);
          row["reps"] = reps;
          row["measured_ms"] = got;
          row["clock_ms"] = clock_ms;
          rows.push_back(row);
        }
        burn["requests"] = rows;
      }
      long long tn = args.integer("time-iters");
      if (tn > 0) {
        burn["time_iters"] = tn;
        burn["time_ms"] = dev->timed_burn_ms(state, tn, 8, s);
      }
      std::string gaps = args.str("gaps");
      if (!gaps.empty()) {
        Json rows = Json::array();
        for (const auto& g : split_csv(gaps, ',')) {
          double gap_ms = std::stod(g);
          Json per = Json::array();
          for (int r = 0; r < kGapReps; ++r) {
            dev->sync(s);
            std::this_thread::sleep_for(
                std::chrono::duration<double, std::milli>(gap_ms));
            // no device spin first: the gap is the point
            auto tt = std::chrono::steady_clock::now();
            dev->burn(state, BurnCal::kLong, s);
            dev->sync(s);
            double ms = std::chrono::duration<double, std::milli>(
                            std::chrono::steady_clock::now() - tt)
                            .count();
            per.push_back(ms * 1e6 / BurnCal::kLong);
          }
          Json row = Json::object();
          row["gap_ms"] = gap_ms;
          row["ns_per_iter"] = per;
          rows.push_back(row);
        }
        burn["gaps"] = rows;
      }
      std::string holds = args.str("hold-sms");
      if (!holds.empty()) {
        Json rows = Json::array();
        for (const auto& h : split_csv(holds, ',')) {
          int sms = std::stoi(h);
          auto p = dev->burn_start_delay(
              state, sms, std::llround(kHoldMs * 1e6), kHoldIters, s);
          Json row = Json::object();
          row["sms"] = sms;
          row["hold_us"] = kHoldMs * 1e3;
          row["started"] = p.started;
          row["start_delay_us"] = p.delay_ns / 1e3;
          row["wait_end_us"] = p.wait_ns / 1e3;
          rows.push_back(row);
        }
        burn["holds"] = rows;
      }
      rep["burn"] = burn;
    }
    std::cout << rep.dump() << std::endl;
    return 0;
  } catch (const std::exception& e) {
    rep["available"] = false;
    rep["reason"] = std::string(e.what());
    std::cout << rep.dump() << std::endl;
    return 1;
  }
}
