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
