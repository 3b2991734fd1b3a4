// tcp_selftest — cross-process correctness check of the TCP fabric.
//
// Launched once per rank (the MPI model): every collective and the p2p
// path run across REAL OS processes and every rank verifies the math
// (the "correct sums" proof for the native multi-process path; reference
// role: the mpi_cpu build running under mpirun).  Exit 0 = all checks
// passed on this rank.
//
//   tcp_selftest --world 2 --rank 0 --coordinator 127.0.0.1:9310
#include <cstdio>
#include <iostream>

#include "dlnb/args.hpp"
#include "dlnb/tcp_backend.hpp"
#include "dlnb/tensor.hpp"

using namespace dlnb;

#define REQUIRE(cond)                                                   \
  do {                                                                  \
    if (!(cond)) {                                                      \
      std::cerr << "tcp_selftest rank " << rank << " FAILED: " << #cond \
                << " (" << __FILE__ << ":" << __LINE__ << ")\n";        \
      return 1;                                                         \
    }                                                                   \
  } while (0)

int main(int argc, char** argv) {
  Args args("tcp_selftest — cross-process fabric correctness");
  args.required_int("world", "total process count")
      .required_int("rank", "this process's rank")
      .optional_str("coordinator", "127.0.0.1:0", "rank 0 listen host:port")
      .flag("final_ring",
            "run ONLY one big ring allreduce and exit immediately — no "
            "trailing barrier, so fast ranks leave the fabric while a "
            "delayed rank is still mid-ring (clean-early-exit coverage "
            "with DLNB_TEST_RING_FINAL_RECV_DELAY_MS)");
  args.parse(argc, argv);
  int world = static_cast<int>(args.integer("world"));
  int rank = static_cast<int>(args.integer("rank"));

  try {
    TcpFabric fab(args.str("coordinator"), world, rank, DType::F32);
    auto comm = fab.world_comm(rank);

    if (args.flag_set("final_ring")) {
      const std::int64_t big = 40001;  // >= ring threshold, odd tail
      Tensor src(big, DType::F32), dst(big, DType::F32);
      for (std::int64_t i = 0; i < big; ++i)
        src.set(static_cast<std::size_t>(i),
                static_cast<float>(rank + (i % 7)));
      comm->Allreduce(src.data(), dst.data(), big);
      for (std::int64_t i : {std::int64_t{0}, big / 2, big - 1}) {
        float expect = static_cast<float>(
            world * (world - 1) / 2 + world * (i % 7));
        REQUIRE(dst.get(static_cast<std::size_t>(i)) == expect);
      }
      std::printf("tcp_selftest rank %d OK\n", rank);
      return 0;
    }

    // allreduce: sum of (r+1) over ranks
    {
      Tensor src(8, DType::F32), dst(8, DType::F32);
      src.fill(static_cast<float>(rank + 1));
      comm->Allreduce(src.data(), dst.data(), 8);
      float expect = world * (world + 1) / 2.0f;
      REQUIRE(dst.get(0) == expect && dst.get(7) == expect);
    }
    // allgather: rank-major concat
    {
      Tensor src(2, DType::F32), dst(2 * world, DType::F32);
      src.set(0, static_cast<float>(rank));
      src.set(1, static_cast<float>(10 * rank));
      comm->Allgather(src.data(), dst.data(), 2);
      for (int r = 0; r < world; ++r) {
        REQUIRE(dst.get(2 * r) == static_cast<float>(r));
        REQUIRE(dst.get(2 * r + 1) == static_cast<float>(10 * r));
      }
    }
    // reduce-scatter-block: each block sums ranks
    {
      Tensor src(2 * world, DType::F32), dst(2, DType::F32);
      src.fill(static_cast<float>(rank));
      comm->ReduceScatterBlock(src.data(), dst.data(), 2);
      float expect = world * (world - 1) / 2.0f;
      REQUIRE(dst.get(0) == expect && dst.get(1) == expect);
    }
    // alltoall: dst block q = 100*q + rank
    {
      Tensor src(world, DType::F32), dst(world, DType::F32);
      for (int q = 0; q < world; ++q)
        src.set(q, static_cast<float>(100 * rank + q));
      comm->Alltoall(src.data(), dst.data(), 1);
      for (int q = 0; q < world; ++q)
        REQUIRE(dst.get(q) == static_cast<float>(100 * q + rank));
    }
    // async slot discipline: two in-flight Iallreduce + WaitAll
    {
      Tensor a(4, DType::F32), b(4, DType::F32);
      Tensor oa(4, DType::F32), ob(4, DType::F32);
      a.fill(1.0f);
      b.fill(2.0f);
      comm->Iallreduce(a.data(), oa.data(), 4, 0);
      comm->Iallreduce(b.data(), ob.data(), 4, 1);
      comm->WaitAll(2);
      REQUIRE(oa.get(0) == static_cast<float>(world));
      REQUIRE(ob.get(0) == static_cast<float>(2 * world));
    }
    // p2p ring: send to next, receive from previous
    if (world > 1) {
      Tensor out(4, DType::F32), in(4, DType::F32);
      out.fill(static_cast<float>(rank));
      comm->RingShift(out.data(), in.data(), 4);
      REQUIRE(in.get(0) == static_cast<float>((rank + world - 1) % world));
    }
    // ring allreduce: a count crossing the ring threshold (64 KiB) on a
    // group of >2 exercises the reduce-scatter + allgather rotation,
    // including the shorter tail block (count not divisible by world)
    if (world > 2) {
      const std::int64_t big = 40001;  // 160 KB of f32, odd tail
      Tensor src(big, DType::F32), dst(big, DType::F32);
      for (std::int64_t i = 0; i < big; ++i)
        src.set(static_cast<std::size_t>(i),
                static_cast<float>(rank + (i % 7)));
      comm->Allreduce(src.data(), dst.data(), big);
      for (std::int64_t i : {std::int64_t{0}, big / 2, big - 1}) {
        float expect = static_cast<float>(
            world * (world - 1) / 2 + world * (i % 7));
        REQUIRE(dst.get(static_cast<std::size_t>(i)) == expect);
      }
    }
    // comm split: pairs {2k, 2k+1} reduce independently
    if (world % 2 == 0) {
      auto pair = fab.split(rank, rank / 2, "pair");
      REQUIRE(pair->size() == (world >= 2 ? 2 : 1));
      Tensor src(2, DType::F32), dst(2, DType::F32);
      src.fill(static_cast<float>(rank));
      pair->Allreduce(src.data(), dst.data(), 2);
      float expect = static_cast<float>(2 * (rank / 2) * 2 + 1) / 1.0f;
      // ranks 2k and 2k+1 sum to 4k+1
      REQUIRE(dst.get(0) == static_cast<float>(4 * (rank / 2) + 1));
      (void)expect;
    }
    comm->Barrier();
    std::printf("tcp_selftest rank %d OK\n", rank);
    return 0;
  } catch (const std::exception& e) {
    std::cerr << "tcp_selftest rank " << rank << ": " << e.what() << "\n";
    return 1;
  }
}
