// Shared native-proxy skeleton: args, data discovery, fabric launch,
// measurement, record emission.
//
// Counterpart of the reference's per-binary main() skeleton (reference
// cpp/data_parallel/dp.cpp:127-302, traced in SURVEY.md §3.0): parse args,
// locate the repo data, load the model stats (+card for hybrids), print
// the fabric topology, build communicators, run warmup + measured runs per
// rank, and emit one structured JSON record that
// dlnetbench_tpu_torch.metrics.parser ingests directly.
//
// Build-time DLNB_PROXY_LOOP produces the `_loop` congestor binaries
// (reference -DPROXY_LOOP, Makefile.common:96-109); at runtime --loop does
// the same.
#pragma once

#include <algorithm>
#include <cctype>
#include <fstream>
#include <functional>
#include <set>
#include <iostream>
#include <string>
#include <sys/stat.h>
#include <vector>

#include "dlnb/args.hpp"
#include "dlnb/fabric.hpp"
#include "dlnb/fault_session.hpp"
#include "dlnb/harness.hpp"
#include "dlnb/model_data.hpp"
#include "dlnb/nccl_fabric.hpp"
#include "dlnb/shm_backend.hpp"
#include "dlnb/tcp_backend.hpp"
#include "dlnb/timers.hpp"
#include "dlnb/topology.hpp"

namespace dlnb {

inline bool path_exists(const std::string& p) {
  struct stat st;
  return ::stat(p.c_str(), &st) == 0;
}

// Locate the repo data dir (reference get_dnnproxy_base_path,
// cpp/utils.hpp:44-59): --base_path flag, DLNB_BASE_PATH env, else walk up
// from cwd looking for dlnetbench_tpu_torch/data.
inline std::string find_base_path(const std::string& flag_value) {
  if (!flag_value.empty()) return flag_value;
  if (const char* env = std::getenv("DLNB_BASE_PATH"); env && *env)
    return env;
  std::string prefix = ".";
  for (int depth = 0; depth < 6; ++depth) {
    if (path_exists(prefix + "/dlnetbench_tpu_torch/data/model_stats"))
      return prefix;
    prefix += "/..";
  }
  throw std::runtime_error(
      "cannot locate dlnetbench_tpu_torch/data — pass --base_path or set "
      "DLNB_BASE_PATH to the repo root");
}

struct ProxyEnv {
  HarnessConfig cfg;
  ModelStats stats;
  std::string base_path;
  int world = 0;
  DType dtype = DType::BF16;
  std::string model_name;
  std::string out_path;  // empty -> stdout
  bool no_topology = false;
  std::string backend = "shm";      // shm | tcp | nccl
  std::string nccl_impl = "real";   // nccl: real | host (the test double)
  std::vector<int> devices;         // --devices list (reference -d)
  std::string coordinator;          // tcp/nccl: process 0's host:port
  int proc_rank = 0;                // tcp/nccl: this process's rank
  int procs = 1;                    // nccl: OS processes
};

// "0,2,3" -> {0,2,3} (reference parse_devices, cpp/utils.hpp:62-71).
// Every token must be a plain decimal number — std::stoi's silent prefix
// parsing would turn a "0-3" range typo into {0}.
inline std::vector<int> parse_device_list(const std::string& s) {
  std::vector<int> out;
  std::string num;
  auto flush = [&] {
    if (num.empty()) return;
    for (char c : num)
      if (c < '0' || c > '9')
        throw std::runtime_error("--devices: bad device index '" + num +
                                 "' (expected e.g. 0,2,3)");
    out.push_back(std::stoi(num));
    num.clear();
  };
  for (char c : s) {
    if (c == ',')
      flush();
    else if (c != ' ')
      num += c;
  }
  flush();
  return out;
}

inline void add_common_args(Args& args) {
  args.required_str("model", "stats-file name, e.g. gpt2_l_16_bfloat16")
      .required_int("world", "number of ranks (threads) to run")
      .optional_int("warmup", 3, "warm-up iterations")
      .optional_int("runs", 5, "measured iterations")
      .optional_double("min_exectime", 0.0,
                       "seconds; when >0, runs are estimated from warmup")
      .optional_double("time_scale", 1.0, "scale simulated compute durations")
      .optional_double("size_scale", 1.0, "scale communication buffer sizes")
      .optional_str("base_path", "",
                    "repo root containing dlnetbench_tpu_torch/data")
      .optional_str("out", "", "append the JSON record here instead of stdout")
      .optional_str("backend", "shm",
                    "rank fabric: shm (threaded fake), tcp (one rank a "
                    "process) or nccl (NCCL on the cards)")
      .optional_str("nccl_impl", "real",
                    "nccl backend: real (dlopen libnccl.so.2, or "
                    "$DLNB_NCCL_LIB) or host (the in-process test double)")
      .optional_str("devices", "",
                    "card-index list for the nccl backend, e.g. 0,2,3 "
                    "(reference -d)")
      .optional_str("coordinator", "",
                    "tcp/multi-process nccl: process 0's listen address "
                    "host:port (the ncclUniqueId bootstrap role, "
                    "dp.cpp:183-188)")
      .optional_int("rank", 0, "tcp/multi-process nccl: this process's rank")
      .optional_int("procs", 1,
                    "nccl backend: number of OS processes, each running "
                    "its balanced share of the ranks — the reference's "
                    "multi-node NCCL mode, dp.cpp:166-189")
      .optional_str("fault", "",
                    "JSON fault plan (fault_plan.hpp schema: delay/"
                    "jitter/drop/crash/partition events with rank "
                    "targets and iteration triggers); also honored "
                    "from $DLNB_FAULT_PLAN")
      .optional_str("fault_policy", "",
                    "degradation policy on a detected failure: "
                    "fail_fast (default — every survivor raises), "
                    "retry (dropped frames re-sent with exponential "
                    "backoff), shrink (survivors regroup without the "
                    "dead rank(s) and finish the run degraded)")
      .flag("loop", "run the schedule forever (congestor mode)")
      .flag("no_topology", "skip the startup fabric-topology graph");
}

inline ProxyEnv make_env(const Args& args) {
  ProxyEnv env;
  env.model_name = args.str("model");
  env.world = static_cast<int>(args.integer("world"));
  env.cfg.warmup = static_cast<int>(args.integer("warmup"));
  env.cfg.runs = static_cast<int>(args.integer("runs"));
  env.cfg.min_exectime_s = args.number("min_exectime");
  env.cfg.time_scale = args.number("time_scale");
  env.cfg.size_scale = args.number("size_scale");
  env.cfg.loop = args.flag_set("loop");
#ifdef DLNB_PROXY_LOOP
  env.cfg.loop = true;
#endif
  env.base_path = find_base_path(args.str("base_path"));
  env.stats = load_model_stats(env.base_path + "/dlnetbench_tpu_torch/data/" +
                                   "model_stats/" + env.model_name + ".txt",
                               env.model_name);
  env.dtype = dtype_from_name(env.stats.dtype);
  env.out_path = args.str("out");
  env.no_topology = args.flag_set("no_topology");
  env.backend = args.str("backend");
  env.nccl_impl = args.str("nccl_impl");
  env.devices = parse_device_list(args.str("devices"));
  env.coordinator = args.str("coordinator");
  env.proc_rank = static_cast<int>(args.integer("rank"));
  env.procs = static_cast<int>(args.integer("procs"));
  if (env.backend == "pjrt")
    throw std::runtime_error(
        "--backend pjrt is the JAX package's TPU fabric and is not built "
        "here — on the cards use --backend nccl");
  if (env.backend != "shm" && env.backend != "nccl" &&
      env.backend != "tcp")
    throw std::runtime_error("unknown --backend '" + env.backend +
                             "' (shm | tcp | nccl)");
  if (env.nccl_impl != "real" && env.nccl_impl != "host")
    throw std::runtime_error("unknown --nccl_impl '" + env.nccl_impl +
                             "' (real | host)");
  if (env.backend == "tcp" && env.world > 1 && env.coordinator.empty())
    throw std::runtime_error(
        "--backend tcp needs --coordinator host:port (rank 0 listens "
        "there) and --rank");
  if (env.world <= 0) throw std::runtime_error("--world must be positive");
  if (env.procs < 1) throw std::runtime_error("--procs must be >= 1");
  if (env.procs > 1) {
    if (env.backend != "nccl")
      throw std::runtime_error(
          "--procs > 1 requires --backend nccl (several processes of "
          "cards; the tcp backend is one-rank-per-process already)");
    if (env.world < env.procs)
      throw std::runtime_error(
          "--world must be >= --procs (every process hosts at least one "
          "rank; uneven worlds take the balanced layout)");
    if (env.coordinator.empty())
      throw std::runtime_error(
          "--procs > 1 needs --coordinator host:port and --rank");
    if (env.proc_rank < 0 || env.proc_rank >= env.procs)
      throw std::runtime_error("--rank must be in [0, --procs)");
  }
  // fault plan: --fault wins over the env channel; either way the plan
  // (and its policy) must be IDENTICAL on every process of a run —
  // it is part of the protocol, like the ring threshold
  {
    std::string plan_text = args.str("fault");
    std::string policy = args.str("fault_policy");
    if (plan_text.empty())
      if (const char* e = std::getenv("DLNB_FAULT_PLAN"); e && *e)
        plan_text = e;
    if (policy.empty())
      if (const char* e = std::getenv("DLNB_FAULT_POLICY"); e && *e)
        policy = e;
    fault::Plan::instance().load(plan_text, policy, env.world);
  }
  // with multiple processes, each process drives its balanced share of
  // the world (uneven when world does not divide procs)
  int local_world = static_cast<int>(
      balanced_local(env.world, env.procs, env.proc_rank));
  if (!env.devices.empty()) {
    if (env.backend != "nccl")
      throw std::runtime_error(
          "--devices only applies to --backend nccl (the shm fabric has no "
          "devices)");
    if (static_cast<int>(env.devices.size()) < local_world)
      throw std::runtime_error("--devices lists " +
                               std::to_string(env.devices.size()) +
                               " device(s) for local world " +
                               std::to_string(local_world));
    std::set<int> uniq(env.devices.begin(), env.devices.end());
    if (uniq.size() != env.devices.size())
      throw std::runtime_error(
          "--devices has duplicate indices (NCCL gives each rank its own "
          "card)");
  }
  return env;
}

inline std::unique_ptr<Fabric> make_fabric(const ProxyEnv& env) {
  if (env.backend == "nccl")
    // this process's share of the balanced layout — uneven when world
    // does not divide procs
    return std::make_unique<NcclFabric>(env.world, env.dtype, env.nccl_impl,
                                        env.devices, env.procs,
                                        env.coordinator, env.proc_rank);
  if (env.backend == "tcp")
    return std::make_unique<TcpFabric>(env.coordinator, env.world,
                                       env.proc_rank, env.dtype);
  return std::make_unique<ShmFabric>(env.world, env.dtype);
}

// One component of a timer's communication model (analysis/bandwidth.py
// schema: the bytes a timed region moves per iteration, with the group
// size for the busbw correction factor).  Declared only on BLOCKING
// timers — wait-tail timers (dp's barrier, fsdp's allgather waits)
// measure exposure, not transfer time, and would misreport bandwidth.
inline Json comm_component(const std::string& kind,
                           std::int64_t group, std::int64_t bytes,
                           const std::string& bound = "",
                           std::int64_t ops = 1,
                           std::int64_t span = 0) {
  Json c = Json::object();
  c["kind"] = kind;
  c["group"] = group;
  c["bytes"] = bytes;
  // "lower" marks a deliberately conservative declaration (e.g. middle
  // pipeline stages timing recv+send against one direction's bytes);
  // analysis/bandwidth.py surfaces it as a table column
  if (!bound.empty()) c["bound"] = bound;
  // how many same-size operations the bytes aggregate over — the
  // per-MESSAGE size (bytes/ops) is what algorithm-selection thresholds
  // compare against, not the per-iteration total
  c["ops"] = ops;
  // span > 0: the max OS processes any group of this split spans on the
  // multi-process nccl fabric (axis_span_procs) — the network mesh width the full-mesh
  // refusal should key on; 0 = single-process fabric, field omitted
  if (span > 0) c["span"] = span;
  return c;
}

inline Json comm_timer(const Json& first) {
  Json arr = Json::array();
  arr.push_back(first);
  return arr;
}

inline ModelCard load_card_for(const ProxyEnv& env) {
  std::string arch = arch_name_from_stats_name(env.model_name);
  return load_model_card(
      env.base_path + "/dlnetbench_tpu_torch/data/models/" + arch + ".json",
      arch);
}

// Per-rank body: receives (rank, fabric, timers) and returns the rank's
// extra identity fields (stage_id/dp_id/... as a Json object).  It must
// call run_measured itself so proxies control communicator setup.
using RankBody = std::function<Json(int rank, Fabric& fab, TimerSet& ts,
                                    RankRun& run_out)>;

inline int run_proxy_main(const std::string& section, const ProxyEnv& env,
                          const Json& global_meta, const RankBody& body) {
  if (!env.no_topology)
    print_topology(env.world, std::cerr,
                   env.backend + "-rank[" + dtype_name(env.dtype) + "]");

  std::unique_ptr<Fabric> fab_ptr = make_fabric(env);
  Fabric& fab = *fab_ptr;
  // host energy channel: the process's first local rank brackets its
  // runs (reference PROXY_ENERGY_PROFILING role; see energy.hpp scope)
  auto& meter = energy::Meter::instance();
  if (meter.available())
    meter.recording_rank.store(fab.local_ranks().front());
  std::vector<TimerSet> timers(env.world);
  std::vector<RankRun> runs(env.world);
  std::vector<Json> extras(env.world);
  auto& plan = fault::Plan::instance();
  bool degraded = false;
  try {
    fab.launch([&](int r) { extras[r] = body(r, fab, timers[r], runs[r]); });
  } catch (const fault::RankFailure& e) {
    // A scripted crash surfaced from launch.  Under `shrink` the
    // in-process survivors finished the run degraded (their threads
    // completed on the survivor group); the victim's death is DATA —
    // emit the survivors' record with degraded_world instead of dying.
    // Any other policy, or a process owning no survivor (the tcp
    // victim process), dies like a real crash: record-less, nonzero.
    if (plan.policy() != "shrink") throw;
    auto surv = plan.survivors();
    bool any_local_survivor = false;
    for (int r : fab.local_ranks())
      if (std::find(surv.begin(), surv.end(), r) != surv.end())
        any_local_survivor = true;
    if (!any_local_survivor) throw;
    (void)e;
    degraded = true;
  }

  // emit only the ranks THIS process measured (cross-process fabrics own
  // one rank each; dlnetbench_tpu_torch.metrics.merge reassembles the run)
  std::vector<int> local = fab.local_ranks();
  if (plan.active() && plan.policy() == "shrink" &&
      !plan.crash_victims().empty()) {
    // crash victims emit no rows — they died; parser/merge accept the
    // shrunken rank set through the degraded_world pathway
    auto surv = plan.survivors();
    std::vector<int> kept;
    for (int r : local)
      if (std::find(surv.begin(), surv.end(), r) != surv.end())
        kept.push_back(r);
    local = kept;
    degraded = true;
  }
  if (plan.active() && plan.policy() == "shrink" && plan.has_preempt()) {
    // an eviction that never grew back degrades the run to its end:
    // the drained evictee's rows are local replay (no fabric work) —
    // drop them and declare survivor membership below, mirroring the
    // python tier's preempt-without-rejoin record.  A fired rejoin
    // (every live rank's report says so) keeps full coverage instead.
    bool rejoined_any = false;
    for (int r : fab.local_ranks())
      rejoined_any = rejoined_any || plan.report(r).rejoined.load();
    if (!rejoined_any) {
      auto ev = plan.preempt_victims();
      std::vector<int> kept;
      for (int r : local)
        if (std::find(ev.begin(), ev.end(), r) == ev.end())
          kept.push_back(r);
      local = kept;
      degraded = true;
    }
  }
  if (local.empty())
    // every locally-owned rank drained out of the run (the tcp evictee
    // process of an unrejoined preempt): alive, exit 0, no record —
    // merge's degraded pathway tolerates the absent process
    return 0;
  std::string host = local_hostname();
  if (plan.active())
    for (int r : local)
      // per-rank injected latency as a scalar row field (straggler
      // post-mortems want WHERE the delay landed), stamped before the
      // reports copy the extras
      extras[r]["fault_injected_delay_us"] =
          plan.report(r).injected_delay_us.load();
  std::vector<RankReport> reports;
  for (int r : local) {
    RankReport rep;
    rep.rank = r;
    rep.device_id = r;
    rep.process_index = fab.process_index();
    rep.hostname = host;
    rep.extra = extras[r];
    rep.timers = &timers[r];
    reports.push_back(rep);
  }

  Json meta = global_meta;
  meta["model"] = env.model_name;
  meta["world_size"] = env.world;
  meta["dtype"] = dtype_name(env.dtype);
  // external-launcher job variables (the reference's sbatchman
  // job.variables role, plots/parser.py:221-237): scheduler identity
  // env + DLNB_TAG_<name>=<value> sweep axes, mirrored from the Python
  // tier's metrics.emit.scheduler_variables so both tiers' records
  // carry the same columns
  {
    Json vars = Json::object();
    for (char** e = ::environ; e && *e; ++e) {  // unistd.h via harness.hpp
      std::string kv(*e);
      auto eq = kv.find('=');
      if (eq == std::string::npos) continue;
      std::string k = kv.substr(0, eq), v = kv.substr(eq + 1);
      if (v.empty()) continue;
      if (k.rfind("DLNB_TAG_", 0) == 0) {
        std::string name = k.substr(9);
        for (char& c : name) c = static_cast<char>(::tolower(c));
        vars[name] = v;
      }
    }
    for (const char* k : {"SLURM_JOB_ID", "SLURM_PROCID", "SLURM_NNODES",
                          "JOB_COMPLETION_INDEX", "TPU_WORKER_ID",
                          "MEGASCALE_SLICE_ID"}) {
      if (const char* v = std::getenv(k); v && *v) {
        std::string name(k);
        for (char& c : name) c = static_cast<char>(::tolower(c));
        vars[name] = std::string(v);
      }
    }
    if (!vars.fields().empty()) meta["variables"] = vars;
  }
  if (meter.available()) {
    // which sensor produced energy_consumed — misattribution must be
    // visible in the record, not silent (energy.py run_proxy parity)
    meta["energy_source"] = meter.source();
    meta["energy_scope"] = "process";
  }
  meta["time_scale"] = env.cfg.time_scale;
  meta["size_scale"] = env.cfg.size_scale;
  if (plan.active()) {
    // fault provenance: the plan itself + run-wide drop/retry counters
    plan.describe(meta);
    double inj = 0, det = 0, rec = 0, rej = 0;
    bool shrunk = false, rejoined = false;
    for (int r : local) {
      auto& rep = plan.report(r);
      inj += rep.injected_delay_us.load();
      det = std::max(det, rep.detection_us.load());
      rec = std::max(rec, rep.recovery_us.load());
      rej = std::max(rej, rep.rejoin_us.load());
      shrunk = shrunk || rep.shrunk.load();
      rejoined = rejoined || rep.rejoined.load();
    }
    meta["fault_injected_delay_us"] = inj;
    if (degraded && !rejoined) {
      // a rejoined run ended FULL world: degraded_world stays CLEARED
      // (preempt victims are alive and emit rows, so the record covers
      // range(world) again).  elastic_survivors: crash victims are
      // gone forever AND an unrejoined evictee drained out for good.
      Json dw = Json::array();
      for (int r : plan.elastic_survivors()) dw.push_back(r);
      meta["degraded_world"] = dw;
    }
    if (shrunk) {
      meta["detection_ms"] = det / 1e3;
      meta["recovery_ms"] = rec / 1e3;
    }
    if (rejoined) {
      meta["fault_rejoin_step"] =
          static_cast<std::int64_t>(plan.rejoin_iteration());
      meta["rejoin_ms"] = rej / 1e3;
    }
  }
  Json mesh = Json::object();
  fab.describe(meta, mesh);  // backend/platform identity + cache stats
  // continuous telemetry: the per-step flight ring as a
  // record section — schema-matched to the Python tier's telemetry
  // block (volatile at merge; each process emits its own ring)
  if (TelemetryRing::instance().enabled())
    meta["telemetry"] = TelemetryRing::instance().to_json();

  int rep_rank = local.at(0);  // the rank whose harness counters we hold
  Json rec = make_record(section, meta, mesh, runs[rep_rank].runs,
                         runs[rep_rank].warmup_us, reports);
  rec["process"] = fab.process_index();
  if (!env.out_path.empty()) {
    std::ofstream f(env.out_path, std::ios::app);
    f << rec.dump() << "\n";
  } else {
    std::cout << rec.dump() << std::endl;
  }
  return 0;
}

}  // namespace dlnb
