// Abstract rank fabric — backend selection point for the native tier.
//
// Plays the role of the reference's compile-time backend ladder (reference
// cpp/data_parallel/dp.cpp:183-224: #ifdef NCCL / oneCCL / MPI communicator
// construction): a Fabric owns the world, hands each rank its
// ProxyCommunicator, and arbitrates communicator splits.  Unlike the
// reference, the backend is a RUNTIME choice (--backend shm|tcp|nccl), so one
// binary serves both the in-process test fabric and the cards.
//
// Implementations:
//   * ShmFabric  (shm_backend.hpp)  — threaded rank fabric, the testable
//     fake (reference `mpi_cpu` role).
//   * TcpFabric  (tcp_backend.hpp)  — one rank per OS process.
//   * NcclFabric (nccl_fabric.hpp)  — NCCL over the cards, one rank a
//     card, in one process or several (the seat of the JAX package's
//     PjrtFabric and HierFabric), with a host double for CI.
#pragma once

#include <functional>
#include <memory>
#include <string>
#include <vector>

#include "dlnb/communicator.hpp"
#include "dlnb/harness.hpp"
#include "dlnb/json.hpp"
#include "dlnb/tensor.hpp"

namespace dlnb {

class Fabric {
 public:
  virtual ~Fabric() = default;

  virtual int world_size() const = 0;
  virtual DType dtype() const = 0;
  virtual std::string backend() const = 0;  // "shm" | "tcp" | "nccl"

  virtual std::unique_ptr<ProxyCommunicator> world_comm(int rank) = 0;
  // Collective split: all world ranks must call with their color
  // (MPI_Comm_split role, key = world rank — reference comm-color math,
  // hybrid_3d.cpp:287-300).
  virtual std::unique_ptr<ProxyCommunicator> split(
      int world_rank, int color, const std::string& name) = 0;

  // Run body(rank) on world_size threads; rethrows the first rank failure.
  // (Cross-process fabrics run body once, for this process's rank.)
  virtual void launch(const std::function<void(int)>& body) = 0;

  // Rank `world_rank` is dying mid-run (fault_plan.hpp crash events, or
  // any rank-body exception): make the death OBSERVABLE to the others —
  // in-process fabrics abort the dead rank's groups so blocked
  // rendezvous throw instead of hanging forever; cross-process fabrics
  // suppress the clean-departure goodbye so peers read the EOF as a
  // death (tcp_backend.hpp `dying_`).  Default: nothing to do.
  virtual void mark_rank_dead(int world_rank) { (void)world_rank; }

  // Ranks measured BY THIS PROCESS (record rows to emit); in-process
  // fabrics own the whole world, cross-process fabrics their one rank.
  virtual std::vector<int> local_ranks() const {
    std::vector<int> all(world_size());
    for (int i = 0; i < world_size(); ++i) all[i] = i;
    return all;
  }
  // This process's index in a multi-process run (metrics.merge key).
  virtual int process_index() const { return 0; }

  // Simulated compute for rank `rank`: `us` microseconds, scaled by
  // `time_scale`.  Default is the host sleep (the reference's usleep,
  // cpp/data_parallel/dp.cpp:93); device-backed fabrics override this to
  // burn REAL device cycles via a calibrated compiled kernel in the same
  // slot (the JAX tier's proxies/burn.py equivalent), so "compute" loads
  // the same execution stream the collectives run on.
  virtual void burn(int rank, double us, double time_scale) {
    (void)rank;
    burn_us(us, time_scale);
  }

  // Enrich the emitted record: backend/platform identity into `meta`,
  // device fabric description (and compile-cache stats) into `mesh`.
  virtual void describe(Json& meta, Json& mesh) const = 0;
};

}  // namespace dlnb
