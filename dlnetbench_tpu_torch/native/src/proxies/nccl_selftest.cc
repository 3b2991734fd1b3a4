// Correctness proof for --backend nccl: every collective and p2p
// operation, at every dtype, over the world and a split communicator,
// held exactly against a host reference.  Runs under either NCCL
// implementation (`--nccl_impl real` on the cards, `host` in CI), and
// in any of the fabric's layouts:
//
//   nccl_selftest --world 4 [--nccl_impl host]
//   nccl_selftest --world 4 --procs 4 --coordinator 127.0.0.1:P --rank p
//   nccl_selftest --world 4 --backend shm     (the same ops on shm)
//
// Inputs are small integers so every partial sum is exact in bf16 and
// e4m3 whatever order NCCL adds in; results are fetched from the device
// twins.  Prints one JSON line, with a digest of every result (equal
// across backends when their values are); exit 0 when every check
// passed.
#include <cstdio>
#include <iostream>
#include <mutex>
#include <string>
#include <vector>

#include "dlnb/args.hpp"
#include "dlnb/json.hpp"
#include "dlnb/nccl_fabric.hpp"
#include "dlnb/shm_backend.hpp"
#include "dlnb/tensor.hpp"
#include "dlnb/topology.hpp"

using namespace dlnb;

namespace {

struct Tally {
  std::mutex m;
  long checks = 0;
  std::vector<std::string> failures;
  // (dtype, world rank, step) -> FNV-1a of the result's bytes
  std::map<std::string, std::uint64_t> results;
  void check(bool ok, const std::string& what) {
    std::lock_guard<std::mutex> lk(m);
    ++checks;
    if (!ok && failures.size() < 20) failures.push_back(what);
  }
  void keep(const std::string& key, const Tensor& t) {
    std::uint64_t h = 1469598103934665603ULL;
    auto* b = static_cast<const unsigned char*>(t.data());
    for (std::size_t i = 0; i < t.bytes(); ++i)
      h = (h ^ b[i]) * 1099511628211ULL;
    std::lock_guard<std::mutex> lk(m);
    results[key] = h;
  }
  std::string digest() const {
    std::uint64_t h = 1469598103934665603ULL;
    for (const auto& [k, v] : results) {
      for (char c : k) h = (h ^ static_cast<unsigned char>(c)) * 1099511628211ULL;
      h = (h ^ v) * 1099511628211ULL;
    }
    char buf[17];
    std::snprintf(buf, sizeof buf, "%016llx",
                  static_cast<unsigned long long>(h));
    return buf;
  }
};

// Input element i of rank r (group rank for split groups).
float value(DType dt, int r, std::int64_t i) {
  if (dt == DType::F8E4M3) return static_cast<float>((r + i) % 2);
  return static_cast<float>((r * 3 + i) % 4);
}

void fill(Tensor& t, int r, std::int64_t offset = 0) {
  for (std::int64_t i = 0; i < t.count(); ++i)
    t.set(static_cast<std::size_t>(i), value(t.dtype(), r, offset + i));
}

// The ops on one communicator, checked against the reference.
// `nccl`: the fabric whose twins hold the results (null on shm).
void run_ops(NcclFabric* nccl, int wr, ProxyCommunicator& c, Tally& tally,
             const std::string& tag) {
  const DType dt = c.dtype();
  const int n = c.size(), me = c.rank();
  const std::int64_t cnt = 24;  // divisible by every group size used
  auto where = [&](const std::string& op, std::int64_t i) {
    return tag + ":" + dtype_name(dt) + ":" + op + "[rank " +
           std::to_string(me) + ", i " + std::to_string(i) + "]";
  };
  int step = 0;
  auto fetch = [&](Tensor& t) {
    if (nccl) nccl->download(wr, t.data(), t.bytes());
    tally.keep(std::string(dtype_name(dt)) + ":" + tag + ":" +
                   std::to_string(wr) + ":" + std::to_string(step++),
               t);
  };

  Tensor src(cnt * n, dt), dst(cnt * n, dt), out(cnt, dt);
  fill(src, me);
  if (nccl) nccl->upload(wr, src.data(), src.bytes());

  c.Allreduce(src.data(), out.data(), cnt);
  fetch(out);
  for (std::int64_t i = 0; i < cnt; ++i) {
    float want = 0;
    for (int q = 0; q < n; ++q) want += value(dt, q, i);
    tally.check(out.get(i) == want, where("allreduce", i));
  }

  c.Allgather(src.data(), dst.data(), cnt);
  fetch(dst);
  for (int q = 0; q < n; ++q)
    for (std::int64_t i = 0; i < cnt; ++i)
      tally.check(dst.get(q * cnt + i) == value(dt, q, i),
                  where("allgather", q * cnt + i));

  c.ReduceScatterBlock(src.data(), out.data(), cnt);
  fetch(out);
  for (std::int64_t i = 0; i < cnt; ++i) {
    float want = 0;
    for (int q = 0; q < n; ++q) want += value(dt, q, me * cnt + i);
    tally.check(out.get(i) == want, where("reduce_scatter", i));
  }

  c.Alltoall(src.data(), dst.data(), cnt);
  fetch(dst);
  for (int q = 0; q < n; ++q)
    for (std::int64_t i = 0; i < cnt; ++i)
      tally.check(dst.get(q * cnt + i) == value(dt, q, me * cnt + i),
                  where("alltoall", q * cnt + i));

  c.Barrier();

  for (int shift : {1, 2}) {
    c.RingShift(src.data(), out.data(), cnt, shift);
    fetch(out);
    int from = ((me - shift) % n + n) % n;
    for (std::int64_t i = 0; i < cnt; ++i)
      tally.check(out.get(i) == value(dt, from, i),
                  where("ring_shift" + std::to_string(shift), i));
  }

  // nonblocking collectives on two slots at once
  Tensor out2(cnt * n, dt);
  c.Iallreduce(src.data(), out.data(), cnt, 0);
  c.Iallgather(src.data(), out2.data(), cnt, 1);
  c.WaitAll(2);
  fetch(out);
  fetch(out2);
  for (std::int64_t i = 0; i < cnt; ++i) {
    float want = 0;
    for (int q = 0; q < n; ++q) want += value(dt, q, i);
    tally.check(out.get(i) == want, where("iallreduce", i));
  }
  for (int q = 0; q < n; ++q)
    for (std::int64_t i = 0; i < cnt; ++i)
      tally.check(out2.get(q * cnt + i) == value(dt, q, i),
                  where("iallgather", q * cnt + i));

  // p2p between pairs (0,1), (2,3), ...; even ranks send first, since
  // NCCL runs one communicator's operations in the order they were issued
  int peer = me ^ 1;
  if (n > 1 && peer < n) {
    // on two slots (one tag: shm pairs a send and a receive by tag)
    if (me % 2 == 0) {
      c.Isend(src.data(), cnt, peer, 0, 11);
      c.Irecv(out.data(), cnt, peer, 1, 11);
    } else {
      c.Irecv(out.data(), cnt, peer, 1, 11);
      c.Isend(src.data(), cnt, peer, 0, 11);
    }
    c.Wait(0);
    c.Wait(1);
    fetch(out);
    for (std::int64_t i = 0; i < cnt; ++i)
      tally.check(out.get(i) == value(dt, peer, i), where("isend_irecv", i));
    {
      if (me % 2 == 0) {
        c.Send(src.data(), cnt, peer);
        c.Recv(out.data(), cnt, peer);
      } else {
        c.Recv(out.data(), cnt, peer);
        c.Send(src.data(), cnt, peer);
      }
      fetch(out);
      for (std::int64_t i = 0; i < cnt; ++i)
        tally.check(out.get(i) == value(dt, peer, i), where("send_recv", i));
    }
  }

  // a blocking op on plain memory: staged through the device, copied back
  std::vector<unsigned char> a(4), b(4);
  store_element(a.data(), 0, dt, 1.0f);
  c.Allreduce(a.data(), b.data(), 1);
  tally.check(load_element(b.data(), 0, dt) == static_cast<float>(n),
              where("allreduce_staged", 0));
}

}  // namespace

int main(int argc, char** argv) {
  Args args("nccl_selftest — value checks of the nccl fabric");
  args.required_int("world", "ranks")
      .optional_str("backend", "nccl", "nccl | shm")
      .optional_str("nccl_impl", "real", "real | host")
      .optional_str("devices", "", "card list, e.g. 0,1")
      .optional_int("procs", 1, "OS processes")
      .optional_str("coordinator", "", "process 0's host:port")
      .optional_int("rank", 0, "this process's rank")
      .optional_str("dtypes", "float32,bfloat16,float8", "dtypes to check");
  args.parse(argc, argv);
  Json rep = Json::object();
  try {
    int world = static_cast<int>(args.integer("world"));
    std::string impl = args.str("nccl_impl");
    std::vector<int> devices;
    {
      std::string s = args.str("devices"), cur;
      for (char ch : s + ",") {
        if (ch == ',') {
          if (!cur.empty()) devices.push_back(std::stoi(cur));
          cur.clear();
        } else {
          cur += ch;
        }
      }
    }
    int procs = static_cast<int>(args.integer("procs"));
    int prank = static_cast<int>(args.integer("rank"));
    Tally tally;
    std::string version, library;
    Json copies = Json::object();
    for (const auto& dname : split_csv(args.str("dtypes"), ',')) {
      DType dt = dtype_from_name(dname);
      std::unique_ptr<Fabric> fab;
      NcclFabric* nf = nullptr;
      if (args.str("backend") == "shm") {
        fab = std::make_unique<ShmFabric>(world, dt);
      } else {
        auto f = std::make_unique<NcclFabric>(world, dt, impl, devices, procs,
                                              args.str("coordinator"), prank);
        version = f->api().version_string();
        library = f->api().library;
        nf = f.get();
        fab = std::move(f);
      }
      fab->launch([&](int r) {
        auto wc = fab->world_comm(r);
        run_ops(nf, r, *wc, tally, "world");
        if (world > 1) {
          auto sc = fab->split(r, r % 2, "selftest_split");
          run_ops(nf, r, *sc, tally, "split");
        }
      });
      if (nf) {
        Json m = Json::object(), mesh = Json::object();
        nf->describe(m, mesh);
        copies[dname] = m.at("late_twins");
      }
    }
    rep["ok"] = tally.failures.empty();
    rep["world"] = world;
    rep["procs"] = procs;
    rep["process"] = prank;
    rep["backend"] = args.str("backend");
    rep["nccl_impl"] = impl;
    rep["digest"] = tally.digest();
    rep["nccl_version"] = version;
    rep["nccl_library"] = library;
    rep["checks"] = static_cast<std::int64_t>(tally.checks);
    Json f = Json::array();
    for (const auto& s : tally.failures) f.push_back(s);
    rep["failures"] = f;
    rep["late_twins"] = copies;
    std::cout << rep.dump() << std::endl;
    return tally.failures.empty() ? 0 : 1;
  } catch (const std::exception& e) {
    std::cerr << "nccl_selftest: " << e.what() << "\n";
    return 1;
  }
}
