// Unit tests: threaded shm fabric — collectives, p2p, slots, splits.
#include "dlnb_test.hpp"

#include <atomic>
#include <chrono>
#include <thread>

#include "dlnb/harness.hpp"
#include "dlnb/shm_backend.hpp"
#include "dlnb/tensor.hpp"

using namespace dlnb;

TEST(allreduce_f32) {
  ShmFabric fab(4, DType::F32);
  fab.launch([&](int r) {
    auto comm = fab.world_comm(r);
    Tensor src(16, DType::F32), dst(16, DType::F32);
    src.fill(static_cast<float>(r + 1));
    comm->Allreduce(src.data(), dst.data(), 16);
    for (int i = 0; i < 16; ++i) CHECK_NEAR(dst.get(i), 10.0, 0);  // 1+2+3+4
  });
}

TEST(allreduce_bf16) {
  ShmFabric fab(8, DType::BF16);
  fab.launch([&](int r) {
    auto comm = fab.world_comm(r);
    Tensor src(32, DType::BF16), dst(32, DType::BF16);
    src.fill(2.0f);
    comm->Allreduce(src.data(), dst.data(), 32);
    for (int i = 0; i < 32; ++i) CHECK_NEAR(dst.get(i), 16.0, 0);
  });
}

TEST(allgather) {
  ShmFabric fab(4, DType::F32);
  fab.launch([&](int r) {
    auto comm = fab.world_comm(r);
    Tensor src(8, DType::F32), dst(32, DType::F32);
    src.fill(static_cast<float>(r));
    comm->Allgather(src.data(), dst.data(), 8);
    for (int blk = 0; blk < 4; ++blk)
      for (int i = 0; i < 8; ++i)
        CHECK_NEAR(dst.get(blk * 8 + i), static_cast<double>(blk), 0);
  });
}

TEST(reduce_scatter_block) {
  ShmFabric fab(4, DType::F32);
  fab.launch([&](int r) {
    auto comm = fab.world_comm(r);
    Tensor src(16, DType::F32), dst(4, DType::F32);
    // src block b holds value b+1 on every rank -> reduced block r = 4*(r+1)
    for (int b = 0; b < 4; ++b)
      for (int i = 0; i < 4; ++i) src.set(b * 4 + i, static_cast<float>(b + 1));
    comm->ReduceScatterBlock(src.data(), dst.data(), 4);
    for (int i = 0; i < 4; ++i) CHECK_NEAR(dst.get(i), 4.0 * (r + 1), 0);
  });
}

TEST(alltoall) {
  ShmFabric fab(4, DType::F32);
  fab.launch([&](int r) {
    auto comm = fab.world_comm(r);
    Tensor src(4, DType::F32), dst(4, DType::F32);
    // rank r sends value 10*r + dest to dest
    for (int d = 0; d < 4; ++d) src.set(d, static_cast<float>(10 * r + d));
    comm->Alltoall(src.data(), dst.data(), 1);
    for (int s = 0; s < 4; ++s) CHECK_NEAR(dst.get(s), 10.0 * s + r, 0);
  });
}

TEST(p2p_ring) {
  ShmFabric fab(4, DType::BF16);
  fab.launch([&](int r) {
    auto comm = fab.world_comm(r);
    Tensor out(8, DType::BF16), in(8, DType::BF16);
    out.fill(static_cast<float>(r));
    int next = (r + 1) % 4, prev = (r + 3) % 4;
    // even ranks send first (classic deadlock-free pairing)
    if (r % 2 == 0) {
      comm->Send(out.data(), 8, next);
      comm->Recv(in.data(), 8, prev);
    } else {
      comm->Recv(in.data(), 8, prev);
      comm->Send(out.data(), 8, next);
    }
    CHECK_NEAR(in.get(0), static_cast<double>(prev), 0);
  });
}

TEST(isend_irecv_slots) {
  ShmFabric fab(2, DType::F32);
  fab.launch([&](int r) {
    auto comm = fab.world_comm(r);
    Tensor a(4, DType::F32), b(4, DType::F32);
    a.fill(static_cast<float>(r + 1));
    if (r == 0) {
      comm->Isend(a.data(), 4, 1, 0);
      comm->Irecv(b.data(), 4, 1, 1);
    } else {
      comm->Isend(a.data(), 4, 0, 1);
      comm->Irecv(b.data(), 4, 0, 0);
    }
    comm->WaitAll(2);
    CHECK_NEAR(b.get(0), r == 0 ? 2.0 : 1.0, 0);
  });
}

TEST(iallreduce_overlap) {
  // nonblocking allreduces on distinct slots complete out of band while
  // the rank "computes" — the DP proxy's core overlap pattern
  ShmFabric fab(4, DType::F32);
  fab.launch([&](int r) {
    auto comm = fab.world_comm(r);
    constexpr int kBuckets = 4;
    std::vector<Tensor> grads, sums;
    for (int b = 0; b < kBuckets; ++b) {
      grads.emplace_back(64, DType::F32);
      sums.emplace_back(64, DType::F32);
      grads.back().fill(static_cast<float>(b + 1));
    }
    for (int b = 0; b < kBuckets; ++b) {
      burn_us(200);  // simulated bwd compute of bucket b
      comm->Iallreduce(grads[b].data(), sums[b].data(), 64, b);
    }
    comm->WaitAll(kBuckets);
    for (int b = 0; b < kBuckets; ++b)
      CHECK_NEAR(sums[b].get(0), 4.0 * (b + 1), 0);
  });
}

TEST(wait_single_slot) {
  ShmFabric fab(2, DType::F32);
  fab.launch([&](int r) {
    auto comm = fab.world_comm(r);
    Tensor a(4, DType::F32), s0(4, DType::F32), s1(4, DType::F32);
    a.fill(1.0f);
    comm->Iallreduce(a.data(), s0.data(), 4, 0);
    comm->Iallreduce(a.data(), s1.data(), 4, 3);
    comm->Wait(3);
    CHECK_NEAR(s1.get(0), 2.0, 0);
    comm->Wait(0);
    CHECK_NEAR(s0.get(0), 2.0, 0);
    comm->Wait(2);  // idle slot: immediate no-op
  });
}

TEST(split_groups) {
  // 8 ranks, 2x2x2 grid (dp,pp,tp): split along tp_color; each pair
  // allreduces independently (reference comm-color math,
  // hybrid_3d.cpp:287-300)
  ShmFabric fab(8, DType::F32);
  fab.launch([&](int r) {
    // tp fastest-varying: pairs (0,1),(2,3),(4,5),(6,7)
    int color = r / 2;
    auto tp = fab.split(r, color, "tp");
    CHECK_EQ(tp->size(), 2);
    CHECK_EQ(tp->rank(), r % 2);
    Tensor src(4, DType::F32), dst(4, DType::F32);
    src.fill(static_cast<float>(r));
    tp->Allreduce(src.data(), dst.data(), 4);
    // pair sums: r + partner = 2*color*2+1 = 4*color+1
    CHECK_NEAR(dst.get(0), 4.0 * color + 1.0, 0);
  });
}

TEST(two_splits_sequential) {
  // fsdp's two communicators: intra-shard then inter-replica
  ShmFabric fab(8, DType::F32);
  fab.launch([&](int r) {
    auto unit = fab.split(r, r / 4, "unit");       // shards of 4
    auto repl = fab.split(r, r % 4, "allreduce");  // replicas of 2
    CHECK_EQ(unit->size(), 4);
    CHECK_EQ(repl->size(), 2);
    Tensor a(2, DType::F32), b(2, DType::F32);
    a.fill(1.0f);
    unit->Allreduce(a.data(), b.data(), 2);
    CHECK_NEAR(b.get(0), 4.0, 0);
    repl->Allreduce(a.data(), b.data(), 2);
    CHECK_NEAR(b.get(0), 2.0, 0);
  });
}

TEST(mismatch_detected) {
  ShmFabric fab(2, DType::F32);
  bool caught = false;
  try {
    fab.launch([&](int r) {
      auto comm = fab.world_comm(r);
      Tensor a(8, DType::F32), b(8, DType::F32);
      // ranks disagree on count -> must abort, not hang
      comm->Allreduce(a.data(), b.data(), r == 0 ? 8 : 4);
    });
  } catch (const std::exception&) {
    caught = true;
  }
  CHECK(caught);
}

TEST(mismatch_then_reuse) {
  // the rendezvous must fully reset after a mismatch so later matched
  // collectives on the same group still work (no wedge)
  ShmFabric fab(2, DType::F32);
  fab.launch([&](int r) {
    auto comm = fab.world_comm(r);
    Tensor a(8, DType::F32), b(8, DType::F32);
    a.fill(1.0f);
    bool threw = false;
    try {
      comm->Allreduce(a.data(), b.data(), r == 0 ? 8 : 4);
    } catch (const std::exception&) {
      threw = true;
    }
    CHECK(threw);
    comm->Allreduce(a.data(), b.data(), 8);  // matched retry succeeds
    CHECK_NEAR(b.get(0), 2.0, 0);
  });
}

TEST(slot_p2p_no_cross_match) {
  // two concurrent slot-tagged transfers between the same rank pair with
  // DIFFERENT sizes must pair by slot, never cross-match
  ShmFabric fab(2, DType::F32);
  fab.launch([&](int r) {
    auto comm = fab.world_comm(r);
    Tensor big(64, DType::F32), small(4, DType::F32);
    Tensor rbig(64, DType::F32), rsmall(4, DType::F32);
    big.fill(7.0f);
    small.fill(9.0f);
    for (int iter = 0; iter < 20; ++iter) {  // race repeatedly
      if (r == 0) {
        comm->Isend(big.data(), 64, 1, 0);
        comm->Isend(small.data(), 4, 1, 1);
      } else {
        comm->Irecv(rbig.data(), 64, 0, 0);
        comm->Irecv(rsmall.data(), 4, 0, 1);
      }
      comm->WaitAll(2);
      if (r == 1) {
        CHECK_NEAR(rbig.get(63), 7.0, 0);
        CHECK_NEAR(rsmall.get(3), 9.0, 0);
      }
    }
  });
}

TEST(barrier_sequencing) {
  ShmFabric fab(4, DType::F32);
  std::atomic<int> phase{0};
  fab.launch([&](int r) {
    auto comm = fab.world_comm(r);
    if (r == 0) {
      std::this_thread::sleep_for(std::chrono::milliseconds(20));
      phase.store(1);
    }
    comm->Barrier();
    CHECK_EQ(phase.load(), 1);  // nobody passes before rank 0 arrives
  });
}

// -------------------------------------------------------------- harness
TEST(estimate_runs_math) {
  // mean of [., ., 100us, 100us] -> 0.1ms; 1s floor -> 10000 runs
  std::vector<double> w{1000.0, 500.0, 100.0, 100.0};
  CHECK_EQ(estimate_runs(w, 1.0), 10000);
  CHECK_EQ(estimate_runs(w, 0.0001), 1);
  CHECK_EQ(estimate_runs({50.0}, 0.001), 20);  // falls back to last entry
  CHECK_EQ(estimate_runs({}, 1.0), 1);
}

TEST(measured_run_loop) {
  ShmFabric fab(2, DType::F32);
  std::vector<TimerSet> timers(2);
  std::vector<RankRun> runs(2);
  HarnessConfig cfg;
  cfg.warmup = 3;
  cfg.runs = 4;
  fab.launch([&](int r) {
    auto comm = fab.world_comm(r);
    runs[r] = run_measured(cfg, *comm, timers[r], [&](TimerSet& ts) {
      auto t = ts.scoped("work_time");
      burn_us(100);
    });
  });
  for (int r = 0; r < 2; ++r) {
    CHECK_EQ(runs[r].runs, 4);
    CHECK_EQ(timers[r].values("runtimes").size(), std::size_t{4});
    CHECK_EQ(timers[r].values("work_time").size(), std::size_t{4});
    CHECK_EQ(runs[r].warmup_us.size(), std::size_t{3});
    for (double t : timers[r].values("runtimes")) CHECK(t >= 90.0);
  }
}

TEST(min_exectime_agreement) {
  ShmFabric fab(4, DType::F32);
  std::vector<RankRun> runs(4);
  HarnessConfig cfg;
  cfg.warmup = 3;
  cfg.min_exectime_s = 0.01;  // 10ms of ~1ms steps -> ~10 runs
  fab.launch([&](int r) {
    auto comm = fab.world_comm(r);
    TimerSet ts;
    runs[r] = run_measured(cfg, *comm, ts,
                           [&](TimerSet&) { burn_us(1000); });
  });
  // all ranks agreed on the same count
  CHECK_EQ(runs[0].runs, runs[1].runs);
  CHECK_EQ(runs[0].runs, runs[3].runs);
  CHECK(runs[0].runs >= 5);
  CHECK(runs[0].runs <= 30);
}

TEST(record_schema) {
  TimerSet ts;
  ts.record("runtimes", 10.5);
  ts.record("runtimes", 11.5);
  ts.record("barrier_time", 1.0);
  ts.record("barrier_time", 2.0);
  Json global = Json::object();
  global["model"] = "gpt2_l_16_bfloat16";
  global["world_size"] = 1;
  Json mesh = Json::object();
  mesh["platform"] = "shm";
  RankReport rep;
  rep.rank = 0;
  rep.hostname = "test";
  rep.timers = &ts;
  Json rec = make_record("dp", global, mesh, 2, {100.0, 90.0}, {rep});
  CHECK_EQ(rec.at("section").as_string(), std::string("dp"));
  CHECK_EQ(rec.at("num_runs").as_int(), 2);
  CHECK_EQ(rec.at("ranks").items().size(), std::size_t{1});
  const Json& row = rec.at("ranks").items()[0];
  CHECK_EQ(row.at("runtimes").items().size(), std::size_t{2});
  CHECK_NEAR(row.at("runtimes").items()[1].as_double(), 11.5, 0);
  // round-trips through the parser
  Json back = Json::parse(rec.dump());
  CHECK_EQ(back.at("global").at("model").as_string(),
           std::string("gpt2_l_16_bfloat16"));
}

TEST(timer_merge_entries) {
  // middle-stage PP merge: 6 raw entries grouped by 2 -> 3 totals
  // (reference hybrid_2d.cpp:416-439)
  TimerSet ts;
  for (double v : {1.0, 2.0, 3.0, 4.0, 5.0, 6.0}) ts.record("pp_comm", v);
  ts.merge_entries("pp_comm", 2);
  const auto& v = ts.values("pp_comm");
  CHECK_EQ(v.size(), std::size_t{3});
  CHECK_NEAR(v[0], 3.0, 0);
  CHECK_NEAR(v[2], 11.0, 0);
}
