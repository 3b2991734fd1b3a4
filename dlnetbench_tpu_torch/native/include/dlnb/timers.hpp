// Interval timers + structured section emission — the ccutils equivalent.
//
// The reference leans on the external ccutils header library for
// `CCUTILS_MPI_TIMER_DEF` (a per-rank std::vector<float> of interval
// timings), `CCUTILS_MPI_SECTION_*` named output sections, and
// `CCUTILS_*_JSON_PUT` key/value emission (reference
// cpp/data_parallel/dp.cpp:28-30, 69-70, 275-295; SURVEY.md §1
// "out-of-repo dependencies").  The rebuild owns this layer: a TimerSet
// holds named per-iteration microsecond vectors per rank, and
// `make_record` assembles the same JSON schema the Python tier's
// metrics.emit writes, so dlnetbench_tpu_torch.metrics.parser ingests native
// runs unchanged.
#pragma once

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <map>
#include <mutex>
#include <string>
#include <vector>

#include "dlnb/json.hpp"

namespace dlnb {

using Clock = std::chrono::steady_clock;

inline double us_since(Clock::time_point t0) {
  return std::chrono::duration<double, std::micro>(Clock::now() - t0).count();
}

// Named per-iteration timer vectors for one rank.  Equivalent of ccutils
// `__timer_vals_<name>` declared by CCUTILS_MPI_TIMER_DEF; `clear()` is the
// reference's pre-measured-run timer reset (dp.cpp:258, fsdp.cpp:384-389).
class TimerSet {
 public:
  void record(const std::string& name, double us) { vals_[name].push_back(us); }

  // Scoped START/STOP (CCUTILS_MPI_TIMER_START/STOP equivalent).
  class Scoped {
   public:
    Scoped(TimerSet& ts, std::string name)
        : ts_(ts), name_(std::move(name)), t0_(Clock::now()) {}
    ~Scoped() { ts_.record(name_, us_since(t0_)); }

   private:
    TimerSet& ts_;
    std::string name_;
    Clock::time_point t0_;
  };
  Scoped scoped(std::string name) { return Scoped(*this, std::move(name)); }

  const std::vector<double>& values(const std::string& name) const {
    static const std::vector<double> kEmpty;
    auto it = vals_.find(name);
    return it == vals_.end() ? kEmpty : it->second;
  }
  const std::map<std::string, std::vector<double>>& all() const {
    return vals_;
  }
  void clear() { vals_.clear(); }

  // Snapshot/rollback for retried step attempts (fault_session.hpp):
  // a step abandoned mid-flight leaves partial scoped-timer entries
  // behind; rolling back to the pre-attempt snapshot keeps every timer
  // array per-iteration aligned when the step is re-run.
  std::map<std::string, std::size_t> sizes() const {
    std::map<std::string, std::size_t> out;
    for (const auto& [name, v] : vals_) out[name] = v.size();
    return out;
  }
  void truncate(const std::map<std::string, std::size_t>& snapshot) {
    for (auto& [name, v] : vals_) {
      auto it = snapshot.find(name);
      std::size_t keep = it == snapshot.end() ? 0 : it->second;
      if (v.size() > keep) v.resize(keep);
    }
  }

  // Merge raw per-hop entries into per-iteration totals of `group` entries
  // each — the reference's middle-stage PP timer merge
  // (hybrid_2d.cpp:416-439 collapses recv+send entries per microbatch).
  void merge_entries(const std::string& name, std::size_t group) {
    auto it = vals_.find(name);
    if (it == vals_.end() || group <= 1) return;
    std::vector<double>& v = it->second;
    std::vector<double> merged;
    merged.reserve(v.size() / group + 1);
    for (std::size_t i = 0; i < v.size(); i += group) {
      double s = 0;
      for (std::size_t j = i; j < std::min(i + group, v.size()); ++j) s += v[j];
      merged.push_back(s);
    }
    v = std::move(merged);
  }

 private:
  std::map<std::string, std::vector<double>> vals_;
};

// Continuous telemetry — the native twin of the Python
// tier's metrics/telemetry.py FlightRecorder: a fixed-capacity ring of
// per-step samples {rank, step, t_s, step_wall_us}, fed by the
// measured loop (harness.hpp run_measured) when DLNB_TELEMETRY is set
// and emitted as the record's "telemetry" global (a per-process
// measurement: metrics/merge.py treats the block as volatile, and
// analysis/critical_path.matrix_from_flights merges the per-rank
// samples into the blame engine's step matrix).  Off by default: the
// disabled path is one atomic-free bool test per step.
class TelemetryRing {
 public:
  static TelemetryRing& instance() {
    static TelemetryRing ring;
    return ring;
  }

  bool enabled() const { return enabled_; }

  void record(int rank, int step, double wall_us) {
    if (!enabled_) return;
    std::lock_guard<std::mutex> lock(mu_);
    Sample s;
    s.rank = rank;
    s.step = step;
    s.t_s = std::chrono::duration<double>(Clock::now() - origin_).count();
    s.wall_us = wall_us;
    buf_[recorded_ % buf_.size()] = s;
    ++recorded_;
  }

  // The record's "telemetry" global, schema-matched to the Python
  // tier's FlightRecorder.telemetry_block (plus full resident samples
  // — the native tier has no separate flight-dump channel, the record
  // IS the artifact).
  Json to_json() const {
    std::lock_guard<std::mutex> lock(mu_);
    Json block = Json::object();
    block["capacity"] = static_cast<std::int64_t>(buf_.size());
    block["recorded"] = static_cast<std::int64_t>(recorded_);
    block["dropped"] = static_cast<std::int64_t>(
        recorded_ > buf_.size() ? recorded_ - buf_.size() : 0);
    Json arr = Json::array();
    const std::size_t n = std::min(recorded_, buf_.size());
    const std::size_t head = recorded_ > buf_.size()
                                 ? recorded_ % buf_.size()
                                 : 0;
    for (std::size_t i = 0; i < n; ++i) {
      const Sample& s = buf_[(head + i) % buf_.size()];
      Json j = Json::object();
      j["rank"] = s.rank;
      j["step"] = s.step;
      j["t_s"] = s.t_s;
      j["step_wall_us"] = s.wall_us;
      arr.push_back(j);
    }
    block["samples"] = arr;
    return block;
  }

 private:
  TelemetryRing() : origin_(Clock::now()) {
    const char* on = std::getenv("DLNB_TELEMETRY");
    enabled_ = on && *on && std::string(on) != "0";
    std::size_t cap = 512;
    if (const char* c = std::getenv("DLNB_TELEMETRY_CAPACITY"); c && *c) {
      long v = std::atol(c);
      if (v > 0) cap = static_cast<std::size_t>(v);
    }
    buf_.resize(cap);
  }

  struct Sample {
    int rank = 0;
    int step = 0;
    double t_s = 0;
    double wall_us = 0;
  };

  bool enabled_ = false;
  Clock::time_point origin_;
  std::vector<Sample> buf_;
  std::size_t recorded_ = 0;
  mutable std::mutex mu_;
};

// One per-rank output row: identity + this rank's timers.
struct RankReport {
  int rank = 0;
  int device_id = 0;
  int process_index = 0;
  std::string hostname;
  Json extra = Json::object();  // stage_id / dp_id / tp_id etc.
  const TimerSet* timers = nullptr;
};

// Band summary of one timer array — the Python tier's
// metrics.stats.summarize mirrored exactly ({value: median, best: min,
// band: [lo, hi], n}), so records from both tiers self-describe their
// statistics the same way (schema v2).
inline Json band_summary(const std::vector<double>& vals) {
  Json s = Json::object();
  if (vals.empty()) {
    s["value"] = 0.0;
    s["best"] = 0.0;
    Json band = Json::array();
    band.push_back(0.0);
    band.push_back(0.0);
    s["band"] = band;
    s["n"] = std::int64_t{0};
    return s;
  }
  std::vector<double> v(vals);
  std::sort(v.begin(), v.end());
  const std::size_t n = v.size();
  s["value"] = n % 2 ? v[n / 2] : (v[n / 2 - 1] + v[n / 2]) / 2.0;
  s["best"] = v.front();
  Json band = Json::array();
  band.push_back(v.front());
  band.push_back(v.back());
  s["band"] = band;
  s["n"] = static_cast<std::int64_t>(n);
  return s;
}

// Assemble the run record in the exact schema of the Python tier's
// metrics.emit.result_to_record (section/version/global/mesh/num_runs/
// warmup_times/ranks) so one parser serves both tiers.
inline Json make_record(const std::string& section, const Json& global_meta,
                        const Json& mesh_meta, int num_runs,
                        const std::vector<double>& warmup_us,
                        const std::vector<RankReport>& ranks) {
  Json rec = Json::object();
  rec["section"] = section;
  rec["version"] = 2;
  rec["global"] = global_meta;
  rec["mesh"] = mesh_meta;
  rec["num_runs"] = num_runs;
  Json warm = Json::array();
  for (double w : warmup_us) warm.push_back(w);
  rec["warmup_times"] = warm;
  Json rows = Json::array();
  for (const auto& r : ranks) {
    Json row = Json::object();
    row["rank"] = r.rank;
    row["device_id"] = r.device_id;
    row["process_index"] = r.process_index;
    row["hostname"] = r.hostname;
    if (r.extra.is_object())
      for (const auto& [k, v] : r.extra.fields()) row[k] = v;
    if (r.timers) {
      Json summary = Json::object();
      for (const auto& [name, vals] : r.timers->all()) {
        Json arr = Json::array();
        for (double v : vals) arr.push_back(v);
        row[name] = arr;
        summary[name] = band_summary(vals);
      }
      row["summary"] = summary;  // schema v2: stats ride the record
    }
    rows.push_back(row);
  }
  rec["ranks"] = rows;
  return rec;
}

}  // namespace dlnb
