// Host-side energy sampling for the native tier — the reference's
// power_profiler role.
//
// The reference optionally links a vendor power profiler into its native
// proxies (-DPROXY_ENERGY_PROFILING -lpower_profiler, reference
// Makefile.flags.mk:119-124) sampling at POWER_SAMPLING_RATE_MS 5
// (dp.cpp:67), and its parser ingests per-rank `energy_consumed` arrays
// (plots/parser.py:172) feeding the runtime-energy Pareto analysis.
//
// This is the C++ port of the rebuild's Python sampling chain
// (dlnetbench_tpu_torch/metrics/energy.py — selection and wraparound logic kept
// identical so both tiers attribute energy the same way):
//
//   * RAPL   — Linux cumulative counters
//              (/sys/class/powercap/intel-rapl:*/energy_uj), top-level
//              zones only (subzones are included in their parent), psys
//              preferred over summed packages, wraparound-safe via
//              max_energy_range_uj.
//   * hwmon  — /sys/class/hwmon/*/power*_input (uW) from ONE device
//              (DLNB_HWMON_DEVICE selects by name substring; otherwise
//              CPU-package-like names are preferred over the
//              alphabetically-first device, which could be a battery or
//              NVMe sensor), integrated by a 5 ms background thread.
//   * none   — energy is absent from the record, as when the reference
//              is built without the profiler.
//
// Scope: energy is a HOST counter, so exactly one rank per process — the
// process's first local rank, set by proxy_runner — brackets its runs
// and records the per-run joule deltas; records stamp
// `energy_scope: "process"`.  In one-rank-per-process fabrics (tcp,
// nccl --procs) this reproduces the reference's per-rank channel exactly.
//
// Roots are overridable (DLNB_RAPL_ROOT / DLNB_HWMON_ROOT) so tests can
// point the chain at a fake sysfs tree on rigs with no counters.
#pragma once

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdlib>
#include <filesystem>
#include <fstream>
#include <iostream>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace dlnb {
namespace energy {

constexpr int kSamplingRateMs = 5;  // reference dp.cpp:67

inline bool read_number(const std::filesystem::path& p, double& out) {
  std::ifstream f(p);
  return static_cast<bool>(f) && static_cast<bool>(f >> out);
}

inline std::string read_word(const std::filesystem::path& p) {
  std::ifstream f(p);
  std::string s;
  f >> s;
  return s;
}

// Cumulative joules from Linux RAPL package domains (energy.py:35-87).
class RaplReader {
 public:
  explicit RaplReader(const std::string& root) {
    namespace fs = std::filesystem;
    std::error_code ec;
    std::vector<fs::path> zones;
    for (fs::directory_iterator it(root, ec), end; !ec && it != end; ++it) {
      std::string name = it->path().filename().string();
      // top-level zones only: intel-rapl:0, not intel-rapl:0:0
      if (name.rfind("intel-rapl:", 0) == 0 &&
          std::count(name.begin(), name.end(), ':') == 1)
        zones.push_back(it->path());
    }
    std::sort(zones.begin(), zones.end());
    std::vector<Domain> packages, psys;
    for (const auto& z : zones) {
      Domain d;
      if (!read_number(z / "energy_uj", d.last)) continue;
      d.path = (z / "energy_uj").string();
      if (!read_number(z / "max_energy_range_uj", d.range))
        d.range = 0.0;  // unknown range: drop wrapped samples
      // psys already contains the packages — never sum both
      (read_word(z / "name") == "psys" ? psys : packages).push_back(d);
    }
    domains_ = psys.empty() ? packages : psys;
  }

  bool available() const { return !domains_.empty(); }

  // Monotonic cumulative joules across domains (wraparound-safe).
  double read_joules() {
    for (auto& d : domains_) {
      double cur;
      if (!read_number(d.path, cur)) continue;
      double delta = cur - d.last;
      if (delta < 0) delta = d.range > 0 ? delta + d.range : 0.0;
      acc_ += delta;
      d.last = cur;
    }
    return acc_ / 1e6;
  }

 private:
  struct Domain {
    std::string path;
    double range = 0.0;
    double last = 0.0;
  };
  std::vector<Domain> domains_;
  double acc_ = 0.0;
};

// Integrate instantaneous hwmon power (uW) in a background thread at the
// reference's 5 ms period (energy.py:90-184).
class HwmonReader {
 public:
  explicit HwmonReader(const std::string& root) {
    namespace fs = std::filesystem;
    std::error_code ec;
    // channels from ONE device only — summing across devices
    // double-counts when aggregate and component sensors coexist
    std::vector<std::vector<std::string>> inputs_by_dev;
    std::vector<std::string> names;
    std::vector<fs::path> devdirs;
    for (fs::directory_iterator it(root, ec), end; !ec && it != end; ++it)
      if (it->path().filename().string().rfind("hwmon", 0) == 0)
        devdirs.push_back(it->path());
    std::sort(devdirs.begin(), devdirs.end());
    for (const auto& dd : devdirs) {
      std::vector<std::string> ins;
      for (fs::directory_iterator jt(dd, ec), end; !ec && jt != end; ++jt) {
        std::string f = jt->path().filename().string();
        double v;
        if (f.rfind("power", 0) == 0 &&
            f.size() > 6 && f.substr(f.size() - 6) == "_input" &&
            read_number(jt->path(), v))
          ins.push_back(jt->path().string());
      }
      if (ins.empty()) continue;
      inputs_by_dev.push_back(std::move(ins));
      std::string n = read_word(dd / "name");
      names.push_back(n.empty() ? dd.filename().string() : n);
    }
    int chosen = -1;
    const char* want = std::getenv("DLNB_HWMON_DEVICE");
    if (want && *want) {
      // explicit selection: no match means unavailable, never a silent
      // fallback to some other sensor
      for (std::size_t i = 0; i < names.size(); ++i)
        if (names[i].find(want) != std::string::npos) {
          chosen = static_cast<int>(i);
          break;
        }
      if (chosen < 0 && !names.empty())
        std::cerr << "[energy] DLNB_HWMON_DEVICE=" << want
                  << " matches no hwmon device; sampling disabled\n";
    } else {
      // prefer CPU-package-like sensors over battery/NVMe/wifi
      static const char* kPreferred[] = {"cpu", "package", "core", "soc",
                                         "rapl"};
      for (std::size_t i = 0; i < names.size() && chosen < 0; ++i) {
        std::string low = names[i];
        std::transform(low.begin(), low.end(), low.begin(), ::tolower);
        for (const char* p : kPreferred)
          if (low.find(p) != std::string::npos) {
            chosen = static_cast<int>(i);
            break;
          }
      }
      if (chosen < 0 && !names.empty()) chosen = 0;
    }
    if (chosen >= 0) {
      inputs_ = inputs_by_dev[static_cast<std::size_t>(chosen)];
      source_ = "hwmon:" + names[static_cast<std::size_t>(chosen)];
    }
  }

  ~HwmonReader() { stop(); }

  bool available() const { return !inputs_.empty(); }
  const std::string& source() const { return source_; }

  double read_joules() {
    ensure_running();
    std::lock_guard<std::mutex> lk(m_);
    return joules_;
  }

  // Stop the poller between measured phases; the next read restarts it.
  void stop() {
    stop_.store(true, std::memory_order_release);
    if (thread_.joinable()) thread_.join();
  }

 private:
  void ensure_running() {
    if (inputs_.empty()) return;
    std::lock_guard<std::mutex> lk(start_m_);
    if (thread_.joinable() && !stop_.load(std::memory_order_acquire)) return;
    if (thread_.joinable()) thread_.join();
    stop_.store(false, std::memory_order_release);
    thread_ = std::thread([this] { loop(); });
  }

  void loop() {
    auto prev = std::chrono::steady_clock::now();
    while (!stop_.load(std::memory_order_acquire)) {
      std::this_thread::sleep_for(
          std::chrono::milliseconds(kSamplingRateMs));
      auto now = std::chrono::steady_clock::now();
      double watts = 0.0;
      for (const auto& p : inputs_) {
        double uw;
        if (read_number(p, uw)) watts += uw / 1e6;
      }
      double dt = std::chrono::duration<double>(now - prev).count();
      {
        std::lock_guard<std::mutex> lk(m_);
        joules_ += watts * dt;
      }
      prev = now;
    }
  }

  std::vector<std::string> inputs_;
  std::string source_;
  double joules_ = 0.0;
  std::mutex m_;
  std::mutex start_m_;
  std::atomic<bool> stop_{false};
  std::thread thread_;
};

// Best available host energy source, one per process (energy.py
// detect_sampler role).  Thread-safe reads; `recording_rank` names the
// ONE global rank whose harness loop brackets runs (set by
// proxy_runner, -1 = disabled).
class Meter {
 public:
  static Meter& instance() {
    static Meter m;
    return m;
  }

  bool available() const { return kind_ != Kind::None; }

  std::string source() const {
    if (kind_ == Kind::Rapl) return "rapl";
    if (kind_ == Kind::Hwmon) return hwmon_->source();
    return "";
  }

  double read_joules() {
    std::lock_guard<std::mutex> lk(m_);
    if (kind_ == Kind::Rapl) return rapl_->read_joules();
    if (kind_ == Kind::Hwmon) return hwmon_->read_joules();
    return 0.0;
  }

  // Release background polling after a measured phase (restartable).
  void relax() {
    if (kind_ == Kind::Hwmon) hwmon_->stop();
  }

  std::atomic<int> recording_rank{-1};

 private:
  Meter() {
    const char* rr = std::getenv("DLNB_RAPL_ROOT");
    rapl_.reset(new RaplReader(rr && *rr ? rr : "/sys/class/powercap"));
    if (rapl_->available()) {
      kind_ = Kind::Rapl;
      return;
    }
    rapl_.reset();
    const char* hr = std::getenv("DLNB_HWMON_ROOT");
    hwmon_.reset(new HwmonReader(hr && *hr ? hr : "/sys/class/hwmon"));
    if (hwmon_->available())
      kind_ = Kind::Hwmon;
    else
      hwmon_.reset();
  }

  enum class Kind { None, Rapl, Hwmon };
  Kind kind_ = Kind::None;
  std::unique_ptr<RaplReader> rapl_;
  std::unique_ptr<HwmonReader> hwmon_;
  std::mutex m_;
};

}  // namespace energy
}  // namespace dlnb
