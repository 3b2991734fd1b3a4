// Abstract communicator — the API every native proxy programs against.
//
// Counterpart of the reference's pure-virtual `ProxyCommunicator`
// (reference cpp/proxy_classes.hpp:30-51): Allreduce / Iallreduce /
// Allgather / Iallgather / Reduce_Scatter_block / Alltoall / Barrier /
// send / recv / Isend / Irecv with the request/stream *index* discipline —
// `Wait(i)` completes whatever was issued on slot i, `WaitAll(n)` slots
// 0..n-1 (reference proxy_classes.hpp:42-43, stream-per-index NCCL
// semantics :143-147).
//
// Backends in the rebuild:
//   * ShmCommunicator (shm_backend.hpp) — in-process rank threads, the
//     testable fake (role of the reference's `mpi_cpu` build, SURVEY.md §4).
//   * NcclCommunicator (nccl_fabric.hpp) — NCCL collectives over the
//     cards' device buffers, one CUDA stream per (rank, slot); the seat
//     the JAX package's PJRT runner fills on a TPU.
//   * TcpCommunicator (tcp_backend.hpp) — one rank per OS process.
//     replica groups and each op replays a cached compiled module
//     (SURVEY.md §5.8).
#pragma once

#include <cstdint>
#include <cstring>
#include <string>

#include "dlnb/tensor.hpp"

namespace dlnb {

class ProxyCommunicator {
 public:
  virtual ~ProxyCommunicator() = default;

  virtual int rank() const = 0;
  virtual int size() const = 0;
  virtual std::string name() const = 0;
  virtual DType dtype() const = 0;

  // ---- blocking collectives (counts are elements of dtype()) ----
  virtual void Allreduce(const void* src, void* dst, std::int64_t count) = 0;
  // dst receives size() * count_per_rank elements, rank-major.
  virtual void Allgather(const void* src, void* dst,
                         std::int64_t count_per_rank) = 0;
  // src holds size() * count_per_rank elements; dst gets this rank's
  // reduced block (MPI_Reduce_scatter_block semantics).
  virtual void ReduceScatterBlock(const void* src, void* dst,
                                  std::int64_t count_per_rank) = 0;
  // classic square all-to-all: src/dst are size() blocks of count_per_rank.
  virtual void Alltoall(const void* src, void* dst,
                        std::int64_t count_per_rank) = 0;
  virtual void Barrier() = 0;

  // ---- point-to-point ----
  // `tag` disambiguates concurrent transfers between the same rank pair
  // (MPI-tag role).  Blocking ops default to tag 0; nonblocking ops with
  // tag < 0 derive the tag from their slot, which pairs naturally when
  // both sides use the same slot.  A send only matches a recv with the
  // same effective tag.
  virtual void Send(const void* src, std::int64_t count, int dst_rank,
                    int tag = 0) = 0;
  virtual void Recv(void* dst, std::int64_t count, int src_rank,
                    int tag = 0) = 0;

  // ---- nonblocking, slot-indexed ----
  virtual void Iallreduce(const void* src, void* dst, std::int64_t count,
                          int slot) = 0;
  virtual void Iallgather(const void* src, void* dst,
                          std::int64_t count_per_rank, int slot) = 0;
  virtual void Isend(const void* src, std::int64_t count, int dst_rank,
                     int slot, int tag = -1) = 0;
  virtual void Irecv(void* dst, std::int64_t count, int src_rank,
                     int slot, int tag = -1) = 0;
  virtual void Wait(int slot) = 0;
  virtual void WaitAll(int num_slots) = 0;

  // ---- ring rotation ----
  // Every group member simultaneously sends `src` to rank (rank+shift) mod
  // size and receives its predecessor's block into `dst` — the ppermute /
  // collective_permute idiom (ring attention's KV rotation).  Blocking.
  // Default: paired Isend/Irecv on slots 0 and 1 (reserved for the call's
  // duration); device backends override with a native collective_permute.
  virtual void RingShift(const void* src, void* dst, std::int64_t count,
                         int shift = 1) {
    int n = size(), me = rank();
    if (n <= 1 || shift % n == 0) {
      if (dst != src)
        std::memcpy(dst, src, static_cast<std::size_t>(count) *
                                  dtype_bytes(dtype()));
      return;
    }
    int to = (me + shift % n + n) % n;
    int from = (me - shift % n + 2 * n) % n;
    Isend(src, count, to, 0, kRingShiftTag);
    Irecv(dst, count, from, 1, kRingShiftTag);
    WaitAll(2);
  }

  virtual void finalize() {}

 protected:
  static constexpr int kRingShiftTag = 7001;
};

}  // namespace dlnb
