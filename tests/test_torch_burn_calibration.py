"""The burn's calibration bookkeeping in the torch port (CPU): a card's
persisted calibration is keyed by its timing method, so a value timed
by fenced single launches (the earlier method, which a host cost
growing with the graph inflated after a ``torch.profiler`` session) is
never reused; the CPU's key and path are unchanged (fenced calls, as
the JAX package times its burn); the card path times back-to-back
replays between CUDA events (held on the card in
tests/test_torch_card_proxies.py)."""
from __future__ import annotations

import json

import pytest

from dlnetbench_tpu_torch.proxies import burn as T_burn

KEY_CARD = ((256, 256), "bfloat16", "NVIDIA H100 80GB HBM3")
KEY_CPU = ((256, 256), "bfloat16", "cpu")


def test_persisted_key_names_the_card_method_not_the_cpu():
    assert T_burn._persist_key(KEY_CPU) == "(256, 256):bfloat16:cpu"
    assert T_burn._persist_key(KEY_CARD) == (
        f"(256, 256):bfloat16:NVIDIA H100 80GB HBM3:{T_burn.CARD_METHOD}")


@pytest.mark.parametrize("key", [KEY_CARD, KEY_CPU])
def test_a_value_under_the_old_card_key_is_not_reused(tmp_path, key):
    """A file holding a card value under the method-less key gives
    nothing back for the card; a value stored now round-trips."""
    path = tmp_path / "burn_calibration.json"
    old = ":".join(map(str, key))
    path.write_text(json.dumps({old: 13600.0}))
    got = T_burn._load_persisted(path, key)
    if key is KEY_CARD:
        assert got is None
    else:
        assert got.ns_per_iter == 13600.0
    cal = T_burn.BurnCalibration(12681.5, *key)
    T_burn._store_persisted(path, key, cal)
    assert T_burn._load_persisted(path, key) == cal
    assert json.loads(path.read_text())[old] == (
        13600.0 if key is KEY_CARD else 12681.5)


def test_cpu_calibration_never_times_replays(monkeypatch):
    """On the CPU ``_measure`` times fenced calls; the replay timing
    (CUDA events) is the card's alone."""
    def no_replays(*a, **kw):
        raise AssertionError("replay timing on the CPU")
    monkeypatch.setattr(T_burn, "_replayed_s", no_replays)
    cal = T_burn._measure(T_burn.Burner("cpu"), "cpu")
    assert cal.ns_per_iter > 0 and cal.device_kind == "cpu"


class _Levels:
    """A scripted card: ``timed(iters, replays)`` gives ``iters`` at the
    ns an iteration of the level in force plus a fixed launch cost, and
    the level moves on at the call numbers ``switch_at`` names."""

    def __init__(self, levels, switch_at=()):
        self.levels, self.switch_at, self.calls = list(levels), switch_at, 0

    def __call__(self, iters, replays):
        self.calls += 1
        k = sum(self.calls > c for c in self.switch_at)
        return (iters * self.levels[min(k, len(self.levels) - 1)]
                + 3000.0) * 1e-9


# one try: a chain, CAL_PAIRS (lo, hi) pairs, a chain
TRY = 2 + 2 * T_burn.CAL_PAIRS


def test_paired_calibration_of_a_steady_card_is_its_level():
    timed = _Levels([12770.0])
    assert T_burn._paired_ns(timed) == pytest.approx(12770.0)
    assert timed.calls == TRY


@pytest.mark.parametrize("at", [1, 2, TRY // 2, TRY - 1])
def test_a_switch_inside_a_try_is_measured_again(at):
    """The level moves from 12.77 to 12.04 µs an iteration inside the
    first try (after its first chain, between a pair's lo and hi, or
    before its last chain): the try is refused and the next one, on one
    level, gives the level in force."""
    timed = _Levels([12770.0, 12040.0], switch_at=(at,))
    assert T_burn._paired_ns(timed) == pytest.approx(12040.0)
    assert timed.calls == 2 * TRY


def test_a_card_that_never_settles_gives_its_last_chain():
    """A level that moves inside every try: after CAL_TRIES tries the
    last long chain's ns an iteration (launch cost included)."""
    switches = tuple(TRY * t + 1 for t in range(T_burn.CAL_TRIES))
    levels = [12770.0 if t % 2 == 0 else 12040.0
              for t in range(T_burn.CAL_TRIES + 1)]
    timed = _Levels(levels, switch_at=switches)
    got = T_burn._paired_ns(timed)
    assert timed.calls == TRY * T_burn.CAL_TRIES
    last = levels[T_burn.CAL_TRIES]
    assert got == pytest.approx(last + 3000.0 / T_burn.CAL_LONG)
