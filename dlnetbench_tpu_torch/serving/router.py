"""The fleet's front-end router: which replica takes the next request
(the JAX package's ``serving/router.py``).

Routing is the one fleet-level decision; each replica keeps its own
admission control.  Every policy is seeded and replayable: the same
plan, seed and policy give the same assignment on any machine, and the
draws are the JAX package's (``serving/arrivals._Rng``, splitmix64), so
a p2c router here picks what the JAX package's picks from the same
replica states.

``ROUTING_POLICIES``:

* ``round_robin`` — cycle over the active replicas; no draws.
* ``p2c`` — power of two choices: two distinct active replicas drawn
  from the router's stream, the lower load score wins, the first draw
  on a tie.
* ``prefix_affinity`` — the replica whose trie holds the longest run of
  the prompt (``PagedKVCache.prefix_match_len``, a read-only probe);
  p2c on a tie (no match included) or when that replica is full (every
  slot spoken for), so affinity never queues a request behind one hot
  replica.

The load score is ``len(queue) + len(pending) + occupied slots``: the
work a replica has accepted and not finished.  p2c takes two draws per
routed request (none with one replica active), round_robin none, and
prefix_affinity two on its fallback only.
"""
from __future__ import annotations

from dlnetbench_tpu_torch.serving.arrivals import _Rng

ROUTING_POLICIES = ("round_robin", "p2c", "prefix_affinity")


class Router:
    """Seeded request -> replica router over ``num_replicas`` queues,
    with its provenance: the assignment log, per-replica counts, the
    chosen replica's load score at each pick (the load histogram) and
    the affinity accounting."""

    def __init__(self, policy: str, num_replicas: int, *, seed: int = 0):
        if policy not in ROUTING_POLICIES:
            raise ValueError(f"router: unknown policy {policy!r} "
                             f"(one of {ROUTING_POLICIES})")
        if num_replicas < 1:
            raise ValueError(f"router: num_replicas must be >= 1, got "
                             f"{num_replicas}")
        self.policy = policy
        self.num_replicas = num_replicas
        self.seed = seed
        self.reset()

    def reset(self) -> None:
        """Back to the seeded origin with an empty log (a measured run
        must not inherit a warm-up's draws)."""
        self._rng = _Rng(self.seed)
        self._rr_next = 0
        self.assignments: list[tuple[int, int]] = []   # (rid, replica)
        self.counts = [0] * self.num_replicas
        self.load_samples: list[int] = []
        self.affinity_hits = 0
        self.affinity_bounces = 0
        self.prefix_reuse_tokens = 0

    # ---- the load signal ---------------------------------------------
    @staticmethod
    def load_score(engine) -> int:
        """Routed-not-admitted queue + pending + occupied slots."""
        return (len(engine.queue) + len(engine.pending)
                + sum(1 for s in engine.slots if s is not None))

    @staticmethod
    def _is_full(engine) -> bool:
        return Router.load_score(engine) >= engine.cfg.slots

    # ---- policies ----------------------------------------------------
    def _round_robin(self, active: list[int]) -> int:
        active_set = set(active)
        for _ in range(self.num_replicas):
            r = self._rr_next % self.num_replicas
            self._rr_next += 1
            if r in active_set:
                return r
        raise RuntimeError("router: no active replica")

    def _p2c(self, active: list[int], engines) -> int:
        if len(active) == 1:
            return active[0]
        n = len(active)
        i = self._rng.uniform_int(0, n - 1)
        j = self._rng.uniform_int(0, n - 2)
        if j >= i:
            j += 1  # the second draw over the other n - 1
        a, b = active[i], active[j]
        # strict <: the first draw wins ties
        return b if self.load_score(engines[b]) \
            < self.load_score(engines[a]) else a

    def _prefix_affinity(self, active: list[int], engines,
                         prompt_tokens) -> int:
        best, best_len = None, 0
        for r in active:
            m = engines[r].cache.prefix_match_len(prompt_tokens)
            if m > best_len:
                best, best_len = r, m
        if best is None:
            return self._p2c(active, engines)
        if self._is_full(engines[best]):
            self.affinity_bounces += 1
            return self._p2c(active, engines)
        self.affinity_hits += 1
        self.prefix_reuse_tokens += best_len
        return best

    # ---- the decision ------------------------------------------------
    def pick(self, req, engines, active: list[int], *,
             prompt_tokens=None) -> int:
        """Route one request; returns the chosen replica's index.
        ``active`` lists the live replicas in ascending order;
        ``prompt_tokens`` feeds the affinity probe."""
        if not active:
            raise RuntimeError("router: no active replica to route to")
        if self.policy == "round_robin":
            r = self._round_robin(active)
        elif self.policy == "p2c":
            r = self._p2c(active, engines)
        else:
            r = self._prefix_affinity(active, engines, prompt_tokens)
        self.assignments.append((req.rid, r))
        self.counts[r] += 1
        self.load_samples.append(self.load_score(engines[r]))
        return r

    # ---- record assembly ---------------------------------------------
    def load_histogram(self) -> list[int]:
        """Counts of the chosen replica's load score, indexed by score."""
        if not self.load_samples:
            return []
        hist = [0] * (max(self.load_samples) + 1)
        for s in self.load_samples:
            hist[s] += 1
        return hist

    def affinity_hit_rate(self) -> float:
        routed = len(self.assignments)
        return round(self.affinity_hits / routed, 4) if routed else 0.0
