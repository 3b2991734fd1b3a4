"""ArrivalPlan: the JSON-serializable open-loop traffic schedule (the
port's copy of the JAX package's ``serving/arrivals.py``: the same plan
JSON gives the same request stream, draw for draw).

Deliberately mirrors ``faults/plan.py`` — ``to_dict``/``from_dict``/
``validate``/``loads("@path")`` and seeded splitmix64 draws (the same
generator the native tier's ``fault_plan.hpp`` uses, so a plan's
randomness is reproducible from its JSON alone) — because traffic plans
are committable artifacts exactly like fault plans: a latency-vs-load
study's arrival process must be replayable from the record.

Kinds:
  poisson — memoryless arrivals at ``rate_rps`` (exponential
            inter-arrival draws).  The open-loop baseline: arrivals do
            NOT wait for the server, so a saturated engine builds a
            queue and TTFT blows up — the knee the study looks for.
  bursty  — piecewise poisson: within every ``period_s`` window the
            first ``duty`` fraction runs at ``rate_rps * factor``, the
            rest at ``rate_rps / factor`` — same *mean* arrival count
            per period only when duty balances factor; the point is
            tail pressure, and the plan states its own shape.
  diurnal — day-shaped poisson: ``phases`` is a piecewise
            rate curve, ``[[fraction_of_run, rate_multiplier], ...]``
            — the phase starting at fraction f of the plan's nominal
            span (``num_requests / rate_rps`` seconds) runs at
            ``rate_rps * multiplier`` until the next phase begins (the
            last phase holds to the end).  The load curve an elastic
            autoscaler study needs: a trough the fleet can scale down
            into and a peak it must scale back up for, committed in
            the plan JSON like every other traffic shape.
  replay  — explicit trace of ``{"t": seconds, "prompt_len", ...}``
            entries (a recorded production trace, replayed verbatim).

Per-request prompt/output lengths are fixed ints or seeded-uniform
``[lo, hi]`` ranges.  Arrival times are RELATIVE seconds from the run's
admission clock start.
"""
from __future__ import annotations

import dataclasses
import json
import math

KINDS = ("poisson", "bursty", "diurnal", "replay")

_M64 = (1 << 64) - 1


def splitmix64(state: int) -> tuple[int, int]:
    """One splitmix64 draw; returns ``(value, next_state)``.  Constants
    match the native tier (fault_plan.hpp:147) so a seed means the same
    stream on every tier."""
    state = (state + 0x9E3779B97F4A7C15) & _M64
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)), state


class _Rng:
    """Seeded splitmix64 stream with the native tier's u01 convention
    (``value >> 11`` over 2^53)."""

    def __init__(self, seed: int):
        self.state = seed & _M64

    def u01(self) -> float:
        v, self.state = splitmix64(self.state)
        return (v >> 11) / float(1 << 53)

    def uniform_int(self, lo: int, hi: int) -> int:
        """Inclusive [lo, hi]."""
        if hi <= lo:
            return lo
        v, self.state = splitmix64(self.state)
        return lo + v % (hi - lo + 1)

    def expovariate(self, rate: float) -> float:
        # 1 - u01() is in (0, 1]: log never sees 0
        return -math.log(1.0 - self.u01()) / rate


def _len_range(v) -> tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


@dataclasses.dataclass(frozen=True)
class Request:
    """One request of the open-loop workload (plan-derived, so the
    whole request stream is replayable from the plan JSON)."""
    rid: int
    arrival_s: float     # relative to the admission clock start
    prompt_len: int
    output_len: int      # decode tokens to generate (EOS stand-in: the
                         # trace/production knowledge of response length)
    prefix_id: int = -1  # shared system-prompt id: >= 0
                         # means the first prefix_len prompt tokens
                         # come from prefix pool entry prefix_id's
                         # seeded stream (decode.prompt_tokens_for) —
                         # the page-shareable prefix
    prefix_len: int = 0


@dataclasses.dataclass
class ArrivalPlan:
    kind: str = "poisson"
    rate_rps: float = 0.0          # poisson/bursty mean request rate
    num_requests: int = 0          # poisson/bursty: how many to draw
    seed: int = 0
    prompt_len: object = 16        # int or [lo, hi] inclusive
    output_len: object = 8         # int or [lo, hi] inclusive
    # bursty shape: duty fraction of each period at rate*factor
    period_s: float = 1.0
    duty: float = 0.2
    factor: float = 4.0
    # diurnal shape: [[fraction_of_run, rate_multiplier],
    # ...] — phase i runs at rate_rps * multiplier from fraction f_i of
    # the nominal span (num_requests / rate_rps seconds) until f_{i+1}
    phases: list = dataclasses.field(default_factory=list)
    # replay: explicit trace entries {"t", "prompt_len", "output_len"}
    trace: list = dataclasses.field(default_factory=list)
    # prefix-heavy traffic: every request's first
    # shared_prefix_len prompt tokens come from one of prefix_pool
    # seeded "system prompts" (seeded choice per request) — the
    # replayable shape of shared-system-prompt production traffic, so
    # prefix-sharing wins are a committable scenario like every other
    shared_prefix_len: int = 0     # 0 disables (no prefix stamped)
    prefix_pool: int = 1           # distinct system prompts to draw from

    def validate(self) -> "ArrivalPlan":
        if self.kind not in KINDS:
            raise ValueError(f"arrival plan: unknown kind {self.kind!r} "
                             f"(one of {KINDS})")
        if self.kind in ("poisson", "bursty", "diurnal"):
            if not self.rate_rps > 0:
                raise ValueError(
                    f"arrival plan: {self.kind} needs rate_rps > 0, got "
                    f"{self.rate_rps!r} — a non-positive rate draws no "
                    f"(or infinitely-spaced) arrivals")
            if self.num_requests < 1:
                raise ValueError(
                    f"arrival plan: {self.kind} needs num_requests >= 1, "
                    f"got {self.num_requests}")
        if self.kind == "bursty":
            if not self.period_s > 0 or not 0.0 < self.duty < 1.0 \
                    or not self.factor >= 1.0:
                raise ValueError(
                    "arrival plan: bursty needs period_s > 0, "
                    "0 < duty < 1 and factor >= 1")
        if self.kind == "diurnal":
            if not self.phases:
                raise ValueError(
                    "arrival plan: diurnal needs a non-empty 'phases' "
                    "curve [[fraction_of_run, rate_multiplier], ...] — "
                    "a diurnal plan without a day shape is just "
                    "poisson, and the plan must state its own shape")
            last_f = -1.0
            for i, ph in enumerate(self.phases):
                if not (isinstance(ph, (list, tuple)) and len(ph) == 2):
                    raise ValueError(
                        f"arrival plan: diurnal phase {i} must be a "
                        f"[fraction_of_run, rate_multiplier] pair, got "
                        f"{ph!r}")
                f, mult = float(ph[0]), float(ph[1])
                if not 0.0 <= f < 1.0:
                    raise ValueError(
                        f"arrival plan: diurnal phase {i} starts at "
                        f"fraction {f!r} — fractions must be in [0, 1)")
                if f <= last_f:
                    raise ValueError(
                        f"arrival plan: diurnal phase {i} starts at "
                        f"fraction {f!r} <= the previous phase's "
                        f"{last_f!r} — phases must be strictly "
                        f"increasing")
                if not mult > 0:
                    raise ValueError(
                        f"arrival plan: diurnal phase {i} has rate "
                        f"multiplier {mult!r} — multipliers must be "
                        f"> 0 (a zero-rate phase never draws the next "
                        f"arrival)")
                last_f = f
            if float(self.phases[0][0]) != 0.0:
                raise ValueError(
                    "arrival plan: the first diurnal phase must start "
                    "at fraction 0.0 — the curve must cover the whole "
                    "run")
        if self.kind == "replay":
            if not self.trace:
                raise ValueError(
                    "arrival plan: replay needs a non-empty 'trace' — "
                    "an empty trace is a zero-request study, which is "
                    "a configuration error, not a measurement")
            last = -1.0
            for i, e in enumerate(self.trace):
                t = float(e.get("t", -1.0))
                if t < 0 or t < last:
                    raise ValueError(
                        f"arrival plan: trace entry {i} has t={t!r} — "
                        f"times must be >= 0 and non-decreasing")
                last = t
        for name in ("prompt_len", "output_len"):
            lo, hi = _len_range(getattr(self, name))
            if lo < 1 or hi < lo:
                raise ValueError(
                    f"arrival plan: {name} must be >= 1 (range "
                    f"[lo, hi] with lo <= hi), got "
                    f"{getattr(self, name)!r}")
        if self.shared_prefix_len < 0:
            raise ValueError(
                f"arrival plan: shared_prefix_len must be >= 0, got "
                f"{self.shared_prefix_len}")
        if self.prefix_pool < 1:
            raise ValueError(
                f"arrival plan: prefix_pool must be >= 1, got "
                f"{self.prefix_pool}")
        if self.shared_prefix_len:
            p_lo, _ = _len_range(self.prompt_len)
            # replay traces may carry explicit per-entry prompt
            # lengths that bypass the plan-level range — the guard
            # must see the SHORTEST prompt any request can get
            if self.kind == "replay":
                p_lo = min([p_lo] + [int(e["prompt_len"])
                                     for e in self.trace
                                     if "prompt_len" in e])
            if self.shared_prefix_len >= p_lo:
                raise ValueError(
                    f"arrival plan: shared_prefix_len "
                    f"{self.shared_prefix_len} must be < the minimum "
                    f"prompt_len {p_lo} — every request needs at "
                    f"least one private prompt token (the final "
                    f"prompt token always re-prefills: it produces "
                    f"the first generated token)")
        return self

    # ---- serialization (the committable wire format) -----------------
    def to_dict(self) -> dict:
        out = {"kind": self.kind, "seed": self.seed,
               "prompt_len": self.prompt_len,
               "output_len": self.output_len}
        if self.kind in ("poisson", "bursty", "diurnal"):
            out["rate_rps"] = self.rate_rps
            out["num_requests"] = self.num_requests
        if self.kind == "bursty":
            out.update(period_s=self.period_s, duty=self.duty,
                       factor=self.factor)
        if self.kind == "diurnal":
            # JSON-canonical pairs: a fixture round-trips byte-
            # identically through json.dumps whatever pair type the
            # caller built the plan with
            out["phases"] = [[float(f), float(m)]
                             for f, m in self.phases]
        if self.kind == "replay":
            out["trace"] = list(self.trace)
        if self.shared_prefix_len:
            # absent unless set: committed earlier plan fixtures
            # round-trip byte-identically
            out["shared_prefix_len"] = self.shared_prefix_len
            out["prefix_pool"] = self.prefix_pool
        return out

    def dumps(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d: dict) -> "ArrivalPlan":
        return cls(
            kind=d.get("kind", "poisson"),
            rate_rps=float(d.get("rate_rps", 0.0)),
            num_requests=int(d.get("num_requests", 0)),
            seed=int(d.get("seed", 0)),
            prompt_len=d.get("prompt_len", 16),
            output_len=d.get("output_len", 8),
            period_s=float(d.get("period_s", 1.0)),
            duty=float(d.get("duty", 0.2)),
            factor=float(d.get("factor", 4.0)),
            phases=[list(p) for p in d.get("phases", [])],
            trace=list(d.get("trace", [])),
            shared_prefix_len=int(d.get("shared_prefix_len", 0)),
            prefix_pool=int(d.get("prefix_pool", 1)),
        ).validate()

    @classmethod
    def loads(cls, text: str) -> "ArrivalPlan":
        """Parse an inline JSON plan or an ``@path`` file reference
        (same convention as ``FaultPlan.loads``)."""
        text = text.strip()
        if text.startswith("@"):
            with open(text[1:]) as f:
                text = f.read()
        return cls.from_dict(json.loads(text))

    # ---- the request stream ------------------------------------------
    def sample(self) -> list[Request]:
        """The plan's deterministic request stream.  Same plan JSON ->
        same arrivals, lengths and ids, on any machine."""
        self.validate()
        rng = _Rng(self.seed)
        p_lo, p_hi = _len_range(self.prompt_len)
        o_lo, o_hi = _len_range(self.output_len)

        def prefix():
            # drawn ONLY when the knob is set, so legacy plans keep
            # their exact earlier request streams
            if not self.shared_prefix_len:
                return {}
            return {"prefix_id": rng.uniform_int(0,
                                                 self.prefix_pool - 1),
                    "prefix_len": self.shared_prefix_len}
        out: list[Request] = []
        if self.kind == "replay":
            for i, e in enumerate(self.trace):
                out.append(Request(
                    rid=i, arrival_s=float(e["t"]),
                    prompt_len=int(e.get("prompt_len",
                                         rng.uniform_int(p_lo, p_hi))),
                    output_len=int(e.get("output_len",
                                         rng.uniform_int(o_lo, o_hi))),
                    **prefix()))
            return out
        # diurnal clock: the curve is stated in fractions of the
        # NOMINAL span (num_requests at the base rate) so the same
        # phases list means the same day shape at any scale
        span = (self.num_requests / self.rate_rps
                if self.kind == "diurnal" else 0.0)
        t = 0.0
        for i in range(self.num_requests):
            rate = self.rate_rps
            if self.kind == "bursty":
                phase = (t % self.period_s) / self.period_s
                rate = (self.rate_rps * self.factor if phase < self.duty
                        else self.rate_rps / self.factor)
            elif self.kind == "diurnal":
                frac = t / span
                mult = self.phases[0][1]
                for f, m in self.phases:
                    if frac >= float(f):
                        mult = m   # last phase holds past fraction 1.0
                rate = self.rate_rps * float(mult)
            t += rng.expovariate(rate)
            out.append(Request(rid=i, arrival_s=t,
                               prompt_len=rng.uniform_int(p_lo, p_hi),
                               output_len=rng.uniform_int(o_lo, o_hi),
                               **prefix()))
        return out

    def offered_rps(self) -> float:
        """The plan's realized offered load: requests per second of the
        sampled stream's span (the x-axis of latency-vs-load plots; for
        poisson it converges on ``rate_rps``)."""
        reqs = self.sample()
        span = max((r.arrival_s for r in reqs), default=0.0)
        if span <= 0:
            return float(len(reqs))
        return len(reqs) / span
