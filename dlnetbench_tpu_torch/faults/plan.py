"""FaultPlan: the JSON-serializable fault schedule (the port's copy of
the JAX package's ``faults/plan.py``, as data).

One plan drives a faulted proxy run (``--fault`` on ``cli.py``; the
injection is ``faults/inject.py``, the policies ``faults/policy.py``)
and the analysis layer, which reads it back out of a record's
``global.fault_plan`` to know which runs were faulted
(``analysis/bandwidth.py``, ``analysis/critical_path.py``).  The wire
format is the JAX package's, so a JAX or native record's plan
round-trips unchanged.

Kinds:
  delay      — fixed straggler latency (``magnitude_us``) on the target
               ranks each step (or each collective with
               ``where="collective"``) inside the trigger window.
  jitter     — like delay, but uniform in [0, magnitude_us), seeded.
  drop       — message loss at probability ``rate`` per transmission.
  crash      — hard rank death at ``iteration``.
  partition  — the ranks in ``group`` lose contact with everyone else
               from ``iteration`` on (whichever side excludes rank 0 is
               lost).
  preempt    — grace-window eviction of the target ranks at
               ``iteration`` after a ``magnitude_us`` drain window;
               needs policy ``shrink``.
  rejoin     — the evicted ranks return at ``iteration``.

Triggers are in STEP units counted from the first step the harness
runs (warmup included).
"""
from __future__ import annotations

import dataclasses
import json

KINDS = ("delay", "jitter", "drop", "crash", "partition", "preempt",
         "rejoin")
POLICIES = ("fail_fast", "retry", "shrink")


@dataclasses.dataclass
class FaultEvent:
    kind: str
    ranks: list[int] = dataclasses.field(default_factory=list)
    iteration: int = 0          # first step index the event is live at
    until: int = -1             # first step index it stops (-1 = never)
    magnitude_us: float = 0.0   # delay/jitter sleep; drop backoff base
    rate: float = 0.0           # drop probability per transmission
    seed: int = 0               # jitter/drop determinism
    where: str = "step"         # "step" | "collective"
    group: list[int] = dataclasses.field(default_factory=list)

    def targets(self, rank: int) -> bool:
        return not self.ranks or rank in self.ranks

    def live_at(self, iteration: int) -> bool:
        return iteration >= self.iteration and (
            self.until < 0 or iteration < self.until)

    def to_dict(self) -> dict:
        out = {"kind": self.kind, "iteration": self.iteration}
        if self.ranks:
            out["ranks"] = list(self.ranks)
        if self.until >= 0:
            out["until"] = self.until
        if self.magnitude_us:
            out["magnitude_us"] = self.magnitude_us
        if self.rate:
            out["rate"] = self.rate
        if self.seed:
            out["seed"] = self.seed
        if self.where != "step":
            out["where"] = self.where
        if self.group:
            out["group"] = list(self.group)
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "FaultEvent":
        return cls(kind=d["kind"], ranks=list(d.get("ranks", [])),
                   iteration=int(d.get("iteration", 0)),
                   until=int(d.get("until", -1)),
                   magnitude_us=float(d.get("magnitude_us", 0.0)),
                   rate=float(d.get("rate", 0.0)),
                   seed=int(d.get("seed", 0)),
                   where=d.get("where", "step"),
                   group=list(d.get("group", [])))


@dataclasses.dataclass
class FaultPlan:
    events: list[FaultEvent] = dataclasses.field(default_factory=list)
    policy: str = "fail_fast"

    def validate(self) -> "FaultPlan":
        if self.policy not in POLICIES:
            raise ValueError(f"fault plan: unknown policy {self.policy!r} "
                             f"(one of {POLICIES})")
        for e in self.events:
            if e.kind not in KINDS:
                raise ValueError(f"fault plan: unknown kind {e.kind!r} "
                                 f"(one of {KINDS})")
            if e.kind == "drop" and not 0.0 < e.rate < 1.0:
                raise ValueError(
                    "fault plan: drop rate must be in (0, 1) — rate 1 "
                    "never delivers and would hang any policy")
            if e.kind == "partition" and not e.group:
                raise ValueError("fault plan: partition needs 'group' "
                                 "(the ranks on one side)")
            if e.where not in ("step", "collective"):
                raise ValueError(
                    f"fault plan: where must be step|collective, got "
                    f"{e.where!r}")
            if e.kind == "preempt" and not e.ranks:
                raise ValueError(
                    "fault plan: preempt needs explicit 'ranks' (the "
                    "evicted ranks must be plan-known on every tier)")
        kinds = {e.kind for e in self.events}
        if kinds & {"preempt", "rejoin"}:
            if self.policy != "shrink":
                raise ValueError(
                    "fault plan: preempt/rejoin model elastic eviction "
                    "and recovery — they need policy 'shrink' (an "
                    "eviction under fail_fast is just a crash; script "
                    "that instead)")
            if "rejoin" in kinds and "preempt" not in kinds:
                raise ValueError(
                    "fault plan: rejoin without a preempt — nobody left "
                    "to return")
            for r in self.events:
                if r.kind != "rejoin":
                    continue
                back = set(r.ranks) if r.ranks else None
                for p in self.events:
                    if p.kind != "preempt":
                        continue
                    if back is not None and not back & set(p.ranks):
                        continue
                    if r.iteration <= p.iteration:
                        raise ValueError(
                            f"fault plan: rejoin at iteration "
                            f"{r.iteration} does not follow its preempt "
                            f"at {p.iteration}")
        return self

    # ---- serialization (the shared wire format) ----------------------
    def to_dict(self) -> dict:
        return {"policy": self.policy,
                "events": [e.to_dict() for e in self.events]}

    def dumps(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        return cls(events=[FaultEvent.from_dict(e)
                           for e in d.get("events", [])],
                   policy=d.get("policy", "fail_fast")).validate()

    @classmethod
    def loads(cls, text: str) -> "FaultPlan":
        """Parse an inline JSON plan or an ``@path`` file reference."""
        text = text.strip()
        if text.startswith("@"):
            with open(text[1:]) as f:
                text = f.read()
        return cls.from_dict(json.loads(text))

    # ---- harness pre-flight ------------------------------------------
    def check_config(self, cfg) -> None:
        """Reject plan/ProxyConfig combinations the segmented
        retry/shrink policies cannot honor — BEFORE the expensive run,
        so they surface as usage errors, not mid-run failures."""
        pre_at = self.first_preempt_iteration()
        rej_at = self.rejoin_iteration()
        if pre_at is not None and rej_at is not None and \
                rej_at < pre_at + 2:
            raise ValueError(
                f"fault plan: rejoin at iteration {rej_at} leaves no "
                f"degraded step after the preempt at {pre_at} — the "
                f"segmented python tier needs rejoin >= preempt + 2")
        crash_at = self.first_crash_iteration()
        if pre_at is not None:
            crash_at = pre_at if crash_at is None else min(crash_at,
                                                           pre_at)
        if crash_at is None or self.policy == "fail_fast":
            return
        if getattr(cfg, "reps_per_fence", 1) > 1:
            raise ValueError(
                "fault plan: crash triggers need reps_per_fence == 1 "
                "(the segmented retry/shrink policies recover at step "
                "granularity, not mid-fence-chain)")
        if getattr(cfg, "min_exectime_s", 0) > 0:
            raise ValueError(
                "fault plan: crash triggers need min_exectime_s == 0 — "
                "the run-count estimation could extend the measured "
                "region past the scripted trigger, letting the crash "
                "escape the retry/shrink policy")
        warm = max(getattr(cfg, "warmup", 1), 1)
        if crash_at < warm:
            raise ValueError(
                f"fault plan: crash iteration {crash_at} lands inside "
                f"the {warm}-step warmup; the segmented policies "
                f"recover measured steps only — move the trigger to "
                f">= {warm}")

    # ---- plan queries (harness + analysis) ---------------------------
    def crash_victims(self, world: int | None = None) -> list[int]:
        """Ranks lost to crash/partition events.  Single-controller
        partition semantics: whichever side EXCLUDES rank 0 is lost —
        when rank 0 sits inside ``group`` the lost side is the
        complement, which needs ``world`` to enumerate (raised, never
        silently ignored)."""
        out: set[int] = set()
        for e in self.events:
            if e.kind == "crash":
                out.update(e.ranks)
            elif e.kind == "partition":
                if 0 not in e.group:
                    out.update(e.group)
                elif world is not None:
                    out.update(r for r in range(world)
                               if r not in e.group)
                else:
                    raise ValueError(
                        "fault plan: a partition whose group contains "
                        "rank 0 loses the COMPLEMENT side — pass the "
                        "world size to enumerate it")
        return sorted(out)

    def survivors(self, world: int) -> list[int]:
        dead = set(self.crash_victims(world))
        return [r for r in range(world) if r not in dead]

    def shrink_survivors(self, world: int) -> list[int]:
        """Ranks left standing under policy ``shrink``: crash AND
        preempt victims are both gone from the degraded world (a
        preempted rank may rejoin later, but the shrink segment runs
        without it).  The one spelling every crash-shrink segmentation
        shares (serving/requeue.py) — it used to be inlined per
        runner, which is how survivor-set definitions drift."""
        dead = set(self.crash_victims(world)) \
            | set(self.preempt_victims())
        return [r for r in range(world) if r not in dead]

    def first_crash_iteration(self) -> int | None:
        its = [e.iteration for e in self.events
               if e.kind in ("crash", "partition")]
        return min(its) if its else None

    # ---- elastic eviction (preempt/rejoin) ---------------------------
    def preempt_victims(self) -> list[int]:
        """Ranks TEMPORARILY lost to preempt events (distinct from
        crash_victims: a preempted rank stays alive and may rejoin)."""
        out: set[int] = set()
        for e in self.events:
            if e.kind == "preempt":
                out.update(e.ranks)
        return sorted(out)

    def first_preempt_iteration(self) -> int | None:
        its = [e.iteration for e in self.events if e.kind == "preempt"]
        return min(its) if its else None

    def rejoin_iteration(self) -> int | None:
        """First step index at which evicted ranks return (None: the
        plan never grows back — preempt degrades to the end, like
        shrink)."""
        its = [e.iteration for e in self.events if e.kind == "rejoin"]
        return min(its) if its else None

    def evicted(self, rank: int, iteration: int) -> bool:
        """Is ``rank`` out of the run at ``iteration`` — inside a
        preempt window that no rejoin (or ``until``) has closed yet?"""
        for e in self.events:
            if e.kind != "preempt" or rank not in e.ranks:
                continue
            end = e.until
            rej = [r.iteration for r in self.events
                   if r.kind == "rejoin" and r.targets(rank)
                   and r.iteration > e.iteration]
            if rej:
                end = min(rej) if end < 0 else min(end, min(rej))
            if iteration >= e.iteration and (end < 0 or iteration < end):
                return True
        return False

    def fault_window(self) -> tuple[int, int | None] | None:
        """[start, end) step window in which ANY event is live; end is
        None for an open window.  The analysis layer uses this to split
        a record's runs into clean and faulted samples.  Elastic
        events: a preempt's window closes at its rejoin's trigger + 1
        (the rejoin step itself pays the grow re-split and must not
        pass as clean); a rejoin event spans exactly its own step."""
        if not self.events:
            return None
        spans: list[tuple[int, int]] = []  # end -1 = open
        for e in self.events:
            if e.kind == "rejoin":
                spans.append((e.iteration, e.iteration + 1))
                continue
            end = e.until
            if e.kind == "preempt":
                rej = [r.iteration + 1 for r in self.events
                       if r.kind == "rejoin" and r.iteration > e.iteration
                       and (not r.ranks or set(r.ranks) & set(e.ranks))]
                if rej:
                    end = min(rej) if end < 0 else min(end, min(rej))
            spans.append((e.iteration, end))
        start = min(s for s, _ in spans)
        ends = [u for _, u in spans]
        end = None if any(u < 0 for u in ends) else max(ends)
        return (start, end)

    def delay_per_step_us(self, rank: int | None = None) -> float:
        """Deterministic injected delay per faulted step, STEP-scoped
        events only (delay at face value; jitter averages magnitude/2;
        collective-scoped events fire an unknown number of times per
        step and cannot be priced per step).  ``rank=None``: the MAX
        over target ranks — different ranks sleep in parallel, so a
        collective step gates on the slowest rank's total, never on
        the sum across ranks (events targeting every rank stack on top
        of each per-rank total)."""
        def contrib(e):
            return e.magnitude_us if e.kind == "delay" \
                else e.magnitude_us / 2.0

        events = [e for e in self.events
                  if e.kind in ("delay", "jitter") and e.where == "step"]
        if rank is not None:
            return sum(contrib(e) for e in events if e.targets(rank))
        everyone = sum(contrib(e) for e in events if not e.ranks)
        per_rank: dict[int, float] = {}
        for e in events:
            for r in e.ranks:
                per_rank[r] = per_rank.get(r, 0.0) + contrib(e)
        return everyone + max(per_rank.values(), default=0.0)
