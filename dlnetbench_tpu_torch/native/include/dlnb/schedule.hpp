// Schedule algebra — pure math of the proxy workloads, native tier.
//
// Mirrors dlnetbench_tpu_torch/core/schedule.py exactly (the Python tier is the
// executable spec; tests/test_native.py cross-checks the two).  Reference
// counterparts:
//   bucket split             reference cpp/data_parallel/dp.cpp:159-164
//   FSDP units/shards/grid   reference cpp/data_parallel/fsdp.cpp:217-265
//   2D pipe grid + messages  reference cpp/hybrid_parallel/hybrid_2d.cpp:236-276
//   3D grid + TP messages    reference cpp/hybrid_parallel/hybrid_3d.cpp:283-325
//   MoE A2A + two-level sync reference cpp/hybrid_parallel/hybrid_3d_moe.cpp:291-363
#pragma once

#include <algorithm>
#include <cstdint>
#include <map>
#include <set>
#include <stdexcept>
#include <string>
#include <vector>

#include "dlnb/model_data.hpp"

namespace dlnb {

using i64 = std::int64_t;

// ----------------------------------------------------------------- DP
// Near-equal split, remainder spread one-per-bucket from the front
// (reference dp.cpp:159-164 semantics).  sum(result) == total always.
inline std::vector<i64> split_buckets(i64 total, i64 num_buckets) {
  if (num_buckets <= 0) throw std::invalid_argument("num_buckets must be > 0");
  i64 base = total / num_buckets, rem = total % num_buckets;
  std::vector<i64> out(num_buckets);
  for (i64 i = 0; i < num_buckets; ++i) out[i] = base + (i < rem ? 1 : 0);
  return out;
}

struct DPSchedule {
  i64 num_buckets;
  std::vector<i64> bucket_sizes;  // elements per bucket
  double fwd_us;                  // whole-model forward compute
  double bwd_us_per_bucket;
  double bytes_per_element;

  std::vector<i64> bucket_bytes() const {
    std::vector<i64> out;
    out.reserve(bucket_sizes.size());
    for (i64 s : bucket_sizes)
      out.push_back(static_cast<i64>(s * bytes_per_element));
    return out;
  }
};

inline DPSchedule dp_schedule(const ModelStats& st, i64 num_buckets) {
  return DPSchedule{num_buckets, split_buckets(st.model_size, num_buckets),
                    st.fwd_us, st.bwd_us / num_buckets, st.bytes_per_element};
}

// ----------------------------------------------------------------- FSDP
struct FSDPSchedule {
  i64 num_units;
  i64 sharding_factor;
  i64 num_replicas;
  std::vector<i64> unit_sizes;  // full (unsharded) unit sizes, elements
  i64 shard_size;               // padded per-rank shard of one unit
  double fwd_us_per_unit;
  double bwd_us_per_unit;
  double bytes_per_element;

  i64 padded_unit_size() const { return shard_size * sharding_factor; }
};

// World = sharding_factor x num_replicas (reference fsdp.cpp:217,258);
// shard sizes padded so every rank holds an equal slice (fsdp.cpp:251-255).
inline FSDPSchedule fsdp_schedule(const ModelStats& st, i64 num_units,
                                  i64 world_size, i64 sharding_factor = 0) {
  i64 sf = sharding_factor > 0 ? sharding_factor : world_size;
  if (world_size % sf != 0)
    throw std::invalid_argument("world_size " + std::to_string(world_size) +
                                " not divisible by sharding_factor " +
                                std::to_string(sf));
  auto units = split_buckets(st.model_size, num_units);
  i64 max_unit = 0;
  for (i64 u : units) max_unit = std::max(max_unit, u);
  i64 shard = (max_unit + sf - 1) / sf;  // ceil
  return FSDPSchedule{num_units, sf, world_size / sf, units, shard,
                      st.fwd_us / num_units, st.bwd_us / num_units,
                      st.bytes_per_element};
}

// ----------------------------------------------------------------- grids
// 3D process grid, fastest-varying axis LAST (tp/ep): `tp_id = rank % tp;
// stage_id = (rank/tp) % pp; dp_id = rank/(tp*pp)` (hybrid_3d.cpp:283-285).
struct Grid3D {
  i64 dp, pp, tp;

  i64 world_size() const { return dp * pp * tp; }

  struct Coords { i64 dp_id, pp_id, tp_id; };
  Coords coords(i64 rank) const {
    return {rank / (tp * pp), (rank / tp) % pp, rank % tp};
  }
  i64 rank(i64 dp_id, i64 pp_id, i64 tp_id) const {
    return (dp_id * pp + pp_id) * tp + tp_id;
  }
  // Communicator "colors" — ranks sharing a color form one group
  // (reference hybrid_3d.cpp:287-300).
  i64 dp_color(i64 r) const { auto c = coords(r); return c.pp_id * tp + c.tp_id; }
  i64 pp_color(i64 r) const { auto c = coords(r); return c.dp_id * tp + c.tp_id; }
  i64 tp_color(i64 r) const { auto c = coords(r); return c.dp_id * pp + c.pp_id; }
};

// The multi-process fabric's balanced contiguous rank->process layout: process p
// hosts world/procs ranks, the first world%procs processes one extra
// (uneven locals).  DERIVED identically everywhere it is needed — the
// fabric (nccl_fabric.hpp with --procs > 1), the span stamping below, and tests — never
// exchanged on the wire.
inline i64 balanced_local(i64 world, i64 procs, i64 p) {
  return world / procs + (p < world % procs ? 1 : 0);
}

inline i64 balanced_start(i64 world, i64 procs, i64 p) {
  const i64 base = world / procs, rem = world % procs;
  return p * base + (p < rem ? p : rem);
}

inline i64 balanced_proc_of(i64 world, i64 procs, i64 rank) {
  for (i64 p = procs - 1; p >= 0; --p)
    if (rank >= balanced_start(world, procs, p)) return p;
  return 0;
}

// Max OS processes any single group of an axis split spans, under the
// multi-process fabric's balanced contiguous rank->process layout (above;
// handles uneven locals).  Stamped into comm-model components ("span")
// so the small-allreduce full-mesh busbw refusal
// (analysis/bandwidth.py) keys on the group's REAL network mesh width: a
// group contained in one process (span 1) never touches the network and
// must not be refused on the record-global process count.
// `color_of` maps world rank -> group color (Grid3D::*_color).
template <typename ColorFn>
inline i64 axis_span_procs(i64 world, i64 procs, ColorFn color_of) {
  if (procs <= 1 || world <= 0) return 1;
  std::map<i64, std::set<i64>> procs_by_color;
  for (i64 r = 0; r < world; ++r)
    procs_by_color[color_of(r)].insert(balanced_proc_of(world, procs, r));
  i64 mx = 1;
  for (const auto& kv : procs_by_color)
    mx = std::max<i64>(mx, static_cast<i64>(kv.second.size()));
  return mx;
}

// ----------------------------------------------------------------- PP(+TP)
struct PipelineSchedule {
  Grid3D grid;
  i64 num_microbatches;
  i64 layers_per_stage;
  i64 pipe_msg_elems;   // activations per microbatch hop
  i64 dp_sync_elems;    // per-stage gradient shard for DP allreduce
  i64 tp_msg_elems;     // per-microbatch TP allreduce (0 if tp==1)
  double fwd_us_per_stage_mb;
  double bwd_us_per_stage_mb;
  double bytes_per_element;

  i64 num_stages() const { return grid.pp; }
};

// Invariants from the reference: layers divisible by stages and batch by
// microbatches (hybrid_2d.cpp:264-265); pipe message = seq_len x embed_dim
// x samples-per-microbatch (hybrid_2d.cpp:244-247); DP allreduce =
// model/(num_stages*tp) (hybrid_2d.cpp:250, hybrid_3d.cpp:325); with TP the
// per-microbatch compute divides by tp and the TP message is pipe_msg/tp
// (hybrid_3d.cpp:314-315, 322).
inline PipelineSchedule pipeline_schedule(const ModelStats& st,
                                          const ModelCard& card,
                                          i64 num_stages, i64 num_microbatches,
                                          i64 dp = 1, i64 tp = 1) {
  if (card.num_layers() % num_stages != 0)
    throw std::invalid_argument(std::to_string(card.num_layers()) +
                                " layers not divisible by " +
                                std::to_string(num_stages) + " stages");
  if (st.batch_size % num_microbatches != 0)
    throw std::invalid_argument("batch " + std::to_string(st.batch_size) +
                                " not divisible by " +
                                std::to_string(num_microbatches) +
                                " microbatches");
  i64 samples_per_mb = st.batch_size / num_microbatches;
  i64 pipe_msg = st.seq_len * st.embed_dim * samples_per_mb;
  return PipelineSchedule{
      Grid3D{dp, num_stages, tp},
      num_microbatches,
      card.num_layers() / num_stages,
      pipe_msg,
      st.model_size / (num_stages * tp),
      tp > 1 ? pipe_msg / tp : 0,
      st.fwd_us / (num_stages * num_microbatches * tp),
      st.bwd_us / (num_stages * num_microbatches * tp),
      st.bytes_per_element};
}

// ------------------------------------------------- zero-bubble pipeline
// ZB-H1 per-stage op program (rebuild extension; the reference models
// only GPipe).  Same tick-synchronous greedy as the JAX tier
// (dlnetbench_tpu_torch/core/schedule.py zb_tables): one unit op per stage per
// tick, priority B > F > W, cross-stage deps land strictly after the
// tick that produced them.  F = forward microbatch (hops up), B =
// input-grad half (hops down), W = local weight-grad half (no hop; fills
// the drain bubble).  Returns stage `s`'s ops in execution order — the
// blocking recv/async send discipline of the engine realizes the timing.
struct ZBOp {
  char kind;  // 'F' | 'B' | 'W'
  i64 mb;     // microbatch index
};

// Core greedy simulation; returns the makespan in ticks and, when
// `stage` >= 0, that stage's ops in execution order via `mine`.  When
// `tick_kinds` is given, appends one entry per tick: bit0 = some stage
// ran F, bit1 = some stage ran B or W (for the weighted unit makespan).
inline i64 zb_simulate(i64 num_stages, i64 num_microbatches, i64 stage,
                       std::vector<ZBOp>* mine,
                       std::vector<unsigned char>* tick_kinds = nullptr) {
  const i64 S = num_stages, M = num_microbatches;
  if (S <= 0 || M <= 0)
    throw std::invalid_argument("zb_ops: S and M must be positive");
  std::vector<std::vector<i64>> f_tick(S, std::vector<i64>(M, -1));
  std::vector<std::vector<i64>> b_tick(S, std::vector<i64>(M, -1));
  std::vector<i64> nf(S, 0), nb(S, 0), nw(S, 0);
  i64 t = 0;
  auto done = [&] {
    for (i64 s = 0; s < S; ++s)
      if (nw[s] < M) return false;
    return true;
  };
  while (!done()) {
    unsigned char kinds = 0;
    for (i64 s = 0; s < S; ++s) {
      i64 k = nb[s];
      if (k < nf[s] &&
          (s == S - 1 || (b_tick[s + 1][k] >= 0 && b_tick[s + 1][k] < t))) {
        b_tick[s][k] = t;
        ++nb[s];
        kinds |= 2;
        if (s == stage && mine) mine->push_back({'B', k});
        continue;
      }
      k = nf[s];
      if (k < M &&
          (s == 0 || (f_tick[s - 1][k] >= 0 && f_tick[s - 1][k] < t))) {
        f_tick[s][k] = t;
        ++nf[s];
        kinds |= 1;
        if (s == stage && mine) mine->push_back({'F', k});
        continue;
      }
      if (nw[s] < nb[s]) {
        ++nw[s];
        kinds |= 2;
        if (s == stage && mine) mine->push_back({'W', nw[s] - 1});
      }
    }
    if (tick_kinds) tick_kinds->push_back(kinds);
    if (++t > 4 * (M + S))
      throw std::runtime_error("zb_simulate failed to converge");
  }
  return t;
}

inline std::vector<ZBOp> zb_ops(i64 num_stages, i64 num_microbatches,
                                i64 stage) {
  std::vector<ZBOp> mine;
  zb_simulate(num_stages, num_microbatches, stage, &mine);
  return mine;
}

// Makespan of the greedy program in unit ticks (== the JAX tier's
// zb_tables(...).ticks; 3M + S - 1 when M >= S-ish, longer for tiny M).
inline i64 zb_ticks(i64 num_stages, i64 num_microbatches) {
  return zb_simulate(num_stages, num_microbatches, -1, nullptr);
}

// Weighted makespan in FORWARD units (== the JAX tier's zb_unit_ticks):
// F costs 1, B and W each cost half a backward (bwd_units / 2, DERIVED
// from the stats' bwd/fwd ratio rather than hardcoding the 2x
// convention); the engine is tick-synchronous, so each tick costs its
// largest resident op.  Equals zb_ticks when bwd_units == 2.
inline double zb_unit_ticks(i64 num_stages, i64 num_microbatches,
                            double bwd_units) {
  std::vector<unsigned char> kinds;
  zb_simulate(num_stages, num_microbatches, -1, nullptr, &kinds);
  const double half = bwd_units / 2.0;
  double total = 0.0;
  for (unsigned char k : kinds)
    total += std::max((k & 1) ? 1.0 : 0.0, (k & 2) ? half : 0.0);
  return total;
}

// ----------------------------------------------------------------- MoE/EP
struct MoESchedule {
  PipelineSchedule pipe;
  i64 num_expert_shards;
  i64 top_k;
  i64 a2a_elems;             // one all-to-all dispatch/combine message
  i64 a2a_per_direction;     // A2As per microbatch per direction
  i64 nonexpert_sync_elems;  // level-1 grad sync over the EP group
  i64 expert_sync_elems;     // level-2 expert-param stage shard over DP

  Grid3D grid() const {
    return Grid3D{pipe.grid.dp, pipe.grid.pp, num_expert_shards};
  }
};

// A2A message = tokens_per_microbatch x top_k x embed_dim /
// num_expert_shards (reference hybrid_3d_moe.cpp:354-359); two A2As per MoE
// layer per direction (:161-165); two-level grad sync sizes from
// non_expert_size (:278, 361-363).  Unlike TP, EP does not divide the
// per-microbatch compute or the pipe message (hybrid_3d_moe.cpp:339-347).
inline MoESchedule moe_schedule(const ModelStats& st, const ModelCard& card,
                                i64 num_stages, i64 num_microbatches,
                                i64 num_expert_shards, i64 dp = 1) {
  if (card.num_experts % num_expert_shards != 0)
    throw std::invalid_argument(std::to_string(card.num_experts) +
                                " experts not divisible by " +
                                std::to_string(num_expert_shards) + " shards");
  auto pipe = pipeline_schedule(st, card, num_stages, num_microbatches, dp, 1);
  i64 samples_per_mb = st.batch_size / num_microbatches;
  i64 tokens_per_mb = samples_per_mb * st.seq_len;
  i64 a2a = tokens_per_mb * card.top_k * st.embed_dim / num_expert_shards;
  i64 layers_per_stage = card.num_layers() / num_stages;
  i64 non_expert = st.non_expert_size;
  i64 expert_params = st.model_size - non_expert;
  return MoESchedule{pipe,
                     num_expert_shards,
                     card.top_k,
                     a2a,
                     2 * layers_per_stage,
                     non_expert / std::max<i64>(num_stages, 1),
                     expert_params / (num_stages * num_expert_shards)};
}

// ------------------------------------------------- sequence parallelism
// Rebuild extension (SURVEY.md §5.7): ring attention + Ulysses.
struct SequenceSchedule {
  i64 sp;
  i64 seq_per_rank;
  i64 kv_block_elems;  // ring: one K+V block exchanged per hop
  i64 a2a_elems;       // ulysses: one head<->seq reshard message
  i64 num_ring_hops;   // sp - 1 per attention layer
  double attn_us_per_block;
  // "ffn_stats" | "even_split_fallback" — which estimator produced
  // attn_us_per_block (emitted into the record, mirrors the JAX tier's
  // core/schedule.py SequenceSchedule.attn_time_source)
  std::string attn_time_source;
  i64 layers;
  double bytes_per_element;
};

inline SequenceSchedule sequence_schedule(const ModelStats& st,
                                          const ModelCard& card, i64 sp,
                                          i64 batch = 0) {
  if (card.seq_len % sp != 0)
    throw std::invalid_argument("seq_len " + std::to_string(card.seq_len) +
                                " not divisible by sp=" + std::to_string(sp));
  i64 b = batch > 0 ? batch : st.batch_size;
  i64 n_local = card.seq_len / sp;
  bool have_ffn = st.fwd_us > 0 && st.ffn_fwd_us > 0;
  double attn_frac = have_ffn ? 1.0 - st.ffn_fwd_us / st.fwd_us : 0.5;
  double attn_us = st.fwd_us * attn_frac /
                   std::max<i64>(card.num_layers(), 1) /
                   static_cast<double>(sp * sp);
  return SequenceSchedule{sp,
                          n_local,
                          2 * b * n_local * card.kv_dim(),
                          b * n_local * card.embed_dim,
                          sp - 1,
                          attn_us,
                          have_ffn ? "ffn_stats" : "even_split_fallback",
                          card.num_layers(),
                          st.bytes_per_element};
}

}  // namespace dlnb
