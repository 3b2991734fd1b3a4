"""The port's autotuner (``dlnetbench_tpu_torch/tuning``) held against the
JAX package's (``dlnetbench_tpu/tuning``) on the CPU: the seeded candidate
order, the search (scripted samples, pruning included), the DB files
(byte-equal, each loading the other's, the durability cases), the key
functions (torch dtypes against jnp dtypes), consult and provenance, the
SPMD knobs' resolution (and its agreement across two gloo ranks), the
``global.tuning`` record block, the tune CLI and the bench's ``tuned_ab``
line.  The consult sites (K11, K12, K1/K2, the flash ops, the SPMD
knobs): with the tuner off they consult nothing, an empty DB changes
nothing, a hit changes the config and not the plain versions' math, and a
hit the card's kernel cannot take is refused."""
from __future__ import annotations

import itertools
import json
import multiprocessing
import os
import shutil
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlnetbench_tpu import tuning as jt
from dlnetbench_tpu.tuning.db import TuningDB as JDB
from dlnetbench_tpu_torch import tuning as tt
from dlnetbench_tpu_torch.tuning.db import TuningDB as TDB
from dlnetbench_tpu_torch.utils.net import free_port

pytestmark = pytest.mark.tuning

FIXTURE = Path(__file__).parent / "data" / "tuning_db.jsonl"
BAND = {"value": 1.0, "best": 0.9, "band": [0.9, 1.2], "n": 3}


@pytest.fixture(autouse=True)
def _clean_tuning_state(monkeypatch):
    """Both packages start disabled with empty consult caches, and leave
    no process-wide consult log behind."""
    monkeypatch.delenv(tt.ENV_DB_DIR, raising=False)
    tt.reset()
    jt.reset()
    yield
    tt.reset()
    jt.reset()


def _enable(monkeypatch, tmp_path, with_fixture: bool = False) -> Path:
    root = tmp_path / "tdb"
    root.mkdir(exist_ok=True)
    if with_fixture:
        shutil.copy(FIXTURE, root / tt.DB_FILENAME)
    monkeypatch.setenv(tt.ENV_DB_DIR, str(root))
    tt.reset()
    jt.reset()
    return root


def test_names_and_exports_equal_jax():
    assert tt.__all__ == jt.__all__
    assert (tt.DB_FILENAME, tt.SCHEMA_VERSION, tt.ENV_DB_DIR) == \
        (jt.DB_FILENAME, jt.SCHEMA_VERSION, jt.ENV_DB_DIR)
    from dlnetbench_tpu.tuning.__main__ import OPS as JOPS
    from dlnetbench_tpu_torch.tuning.__main__ import OPS
    assert OPS == JOPS


# ---------------------------------------------------------------- search

@pytest.mark.parametrize("n,seed", [(1, 0), (2, 0), (3, 5), (8, 3),
                                    (8, 4), (17, 123456789)])
def test_seeded_order_equals_jax(n, seed):
    assert tt.seeded_order(n, seed) == jt.seeded_order(n, seed)


def _scripted(seqs: dict, seen: list):
    def measure(cfg):
        name = cfg["name"]
        seen.append(name)
        return seqs[name][seen.count(name) - 1]
    return measure


def _seed_where(first: list[int]) -> int:
    return next(s for s in itertools.count()
                if jt.seeded_order(len(first), s)[:1] == first[:1])


# the JAX tests' scripted searches: a clear winner, a band-disjoint loser
# pruned after two samples beside a band-ambiguous one given its rounds,
# and a winner whose first draw is slow
SEARCHES = {
    "elects_min": ({"a": [3.0, 3.1, 3.2], "b": [1.0, 1.1, 1.2],
                    "c": [2.0, 2.1, 2.2]}, 0, 3),
    "prunes": ({"fast": [1.0, 1.2, 1.1], "slow": [9.0, 9.0, 9.0],
                "close": [1.15, 1.15, 1.15]}, _seed_where([0]), 3),
    "slow_first_draw": ({"incumbent": [1.0, 1.1, 1.2],
                         "winner": [1.5, 0.9, 0.9]},
                        next(s for s in itertools.count()
                             if jt.seeded_order(2, s) == [0, 1]), 3),
    "two_rounds": ({"a": [2.0, 2.5], "b": [1.0, 9.0]}, 1, 2),
}


@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_run_search_equals_jax(name):
    """One scripted sample sequence through both searches: the same
    visits, pruning, trials, winner and band."""
    seqs, seed, rounds = SEARCHES[name]
    cands = [{"name": k} for k in seqs]
    got_seen, want_seen = [], []
    got = tt.run_search(cands, _scripted(seqs, got_seen), seed=seed,
                        rounds=rounds)
    want = jt.run_search(cands, _scripted(seqs, want_seen), seed=seed,
                         rounds=rounds)
    assert got == want and got_seen == want_seen
    if name == "prunes":
        assert got["pruned"] == 1 and got_seen.count("slow") == 2


def test_search_refusals_equal_jax():
    for kw in ({"candidates": []},
               {"candidates": [{"a": 1}], "rounds": 0}):
        msgs = []
        for mod in (tt, jt):
            with pytest.raises(ValueError) as e:
                mod.run_search(kw["candidates"], lambda c: 1.0,
                               rounds=kw.get("rounds", 3))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# -------------------------------------------------------------------- DB

def _puts(db):
    db.put("quantized_matmul", "fmt=int8,k=64,n=64,t=64,xdtype=bfloat16",
           "cpu", {"cluster": 2}, band=BAND, meta={"seed": 0})
    db.put("paged_attention", "b=2,dh=8", "h100_sxm",
           {"pages_per_compute_block": 4})
    db.put("quantized_matmul", "fmt=int8,k=64,n=64,t=64,xdtype=bfloat16",
           "cpu", {"cluster": 1}, band=BAND)


def test_db_files_byte_equal_and_cross_load(tmp_path):
    """The same put sequence writes byte-equal files in both packages,
    and each package loads the other's file (the JAX fixture too)."""
    tdb, jdb = TDB(tmp_path / "t"), JDB(tmp_path / "j")
    _puts(tdb)
    _puts(jdb)
    assert tdb.path.read_bytes() == jdb.path.read_bytes()
    assert TDB(tmp_path / "j").load() == JDB(tmp_path / "t").load() \
        == tdb.load()
    assert TDB(FIXTURE.parent).path.name == FIXTURE.name
    assert TDB(FIXTURE.parent).load() == JDB(FIXTURE.parent).load()


class _FlakyLock:
    """The JAX tests' lock stand-in: a concurrent writer holds the lock
    for the first ``held`` rounds and releases it under the stat."""

    def __init__(self, real: Path, held: int):
        self.real, self.held, self.attempt = real, held, 0

    def mkdir(self):
        self.attempt += 1
        if self.attempt <= self.held:
            raise FileExistsError(self)
        self.real.mkdir()

    def stat(self):
        if self.attempt <= self.held:
            raise FileNotFoundError(self)
        return self.real.stat()

    def rmdir(self):
        self.real.rmdir()


def _durability(case: str, cls, root: Path, capsys):
    """One durability case on one package's DB; returns what it shows."""
    root.mkdir(parents=True)
    db = cls(root)
    if case == "torn":
        db.put("op", "k=1", "cpu", {"b": 64})
        db.put("op", "k=2", "cpu", {"b": 128})
        db.path.write_bytes(db.path.read_bytes()[:-20])
        kept = sorted(db.load())
        note = capsys.readouterr().err
        db.put("op", "k=3", "cpu", {"b": 256})
        return kept, "torn" in note, db.path.read_text()
    if case == "newer_schema":
        db.path.write_text(json.dumps(
            {"schema": tt.SCHEMA_VERSION + 1, "op": "op", "key": "k",
             "hw": "cpu", "config": {}}) + "\n")
        with pytest.raises(ValueError, match="newer than this build") as e:
            db.load()
        return str(e.value).split(": ", 1)[1]
    if case == "claim_retry":
        cls._claim(_FlakyLock(root / "lock", held=2))
        return (root / "lock").is_dir()
    if case == "claim_give_up":
        flaky = _FlakyLock(root / "never", held=10 ** 9)
        with pytest.raises(RuntimeError, match="could not claim"):
            cls._claim(flaky, attempts=3, wait_s=0.0)
        return flaky.attempt
    lock = root / "lock"                              # claim_steal
    lock.mkdir()
    cls._claim(lock, attempts=3, wait_s=0.0, stale_s=0.0)
    return lock.is_dir()


@pytest.mark.parametrize("case", ["torn", "newer_schema", "claim_retry",
                                  "claim_give_up", "claim_steal"])
def test_db_durability_equals_jax(case, tmp_path, capsys):
    """The JAX tests' durability cases, each on both packages: a torn
    line skipped with a note and healed by the next put, a newer schema
    refused, the claim's retry after a concurrent release, its bounded
    give-up and the stale lock's steal."""
    got = _durability(case, TDB, tmp_path / "t", capsys)
    want = _durability(case, JDB, tmp_path / "j", capsys)
    assert got == want
    assert got not in (False, None)


# ------------------------------------------------------------------ keys

def _dtypes():
    return [(torch.bfloat16, jnp.dtype(jnp.bfloat16)),
            (torch.float32, jnp.dtype(jnp.float32))]


KEY_CASES = {
    "quantized_matmul_key": lambda dt: (12288, 4096, 14336, "float8", dt),
    "flash_fwd_key": lambda dt: (2, 6144, 32, 8, 128, True, dt),
    "flash_bwd_key": lambda dt: (1, 1024, 4, 4, 64, False, dt),
    "splash_key": lambda dt: (2, 6144, 32, 8, 128,
                              "causal&window(1024)", dt),
    "paged_attention_key": lambda dt: (32, 16, 8, 32, 8, 128),
    "paged_attention_quant_key": lambda dt: (32, 16, 8, 32, 8, 128,
                                             "int8"),
    "grouped_ffn_key": lambda dt: (8, 1280, 4096, 7168, "none", dt),
    "tp_overlap_chunks_key": lambda dt: (64, 128, 32, 2, "float32"),
    "grad_bucket_layers_key": lambda dt: (4, 2, 1, 64, 128),
}


@pytest.mark.parametrize("name", sorted(KEY_CASES))
def test_key_functions_equal_jax(name):
    """Every key function spells JAX's string for the same shape, torch
    dtypes against jnp dtypes (``dtype_name``: ``torch.bfloat16`` ->
    ``bfloat16``)."""
    for tdt, jdt in _dtypes():
        got = getattr(tt.params, name)(*KEY_CASES[name](tdt))
        want = getattr(jt.params, name)(*KEY_CASES[name](jdt))
        assert got == want and "torch" not in got
    assert tt.canonical_key(b=1, a="x") == jt.canonical_key(b=1, a="x")


def test_hw_key_is_the_devices_chip(monkeypatch, tmp_path):
    """A CPU tensor's chip is ``cpu``; a card's is its roofline preset
    key (``h100_sxm`` for "NVIDIA H100 80GB HBM3").  A CPU record never
    answers a consult on the card, nor a card record one on the CPU."""
    assert tt.hw_key("cpu") == tt.hw_key(torch.device("cpu")) == "cpu"
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    tt.params._card_key.cache_clear()
    try:
        assert tt.hw_key("cuda:0") == tt.hw_key("cuda") == "h100_sxm"
        root = _enable(monkeypatch, tmp_path)
        TDB(root).put("op", "k", "cpu", {"b": 1})
        TDB(root).put("op", "k", "h100_sxm", {"b": 2})
        TDB(root).put("op", "card_only", "h100_sxm", {"b": 3})
        assert tt.consult("op", "k", {"b": 0}, device="cpu") == {"b": 1}
        assert tt.consult("op", "k", {"b": 0}, device="cuda:0") == {"b": 2}
        assert tt.consult("op", "card_only", {"b": 0},
                          device="cpu") == {"b": 0}
    finally:
        tt.params._card_key.cache_clear()


# --------------------------------------------------------------- consult

def test_consult_disabled_returns_default_and_logs_nothing():
    for mod in (tt, jt):
        assert mod.consult("op", "k", {"b": 64}) == {"b": 64}
        assert mod.provenance() is None and not mod.enabled()


def test_consult_hit_miss_freeze_and_provenance_equal_jax(monkeypatch,
                                                          tmp_path):
    """Hit, miss and freeze-after-first-consult on one DB: the port's
    answers and provenance block (hits, misses, keys, bands, db_path)
    are JAX's."""
    root = _enable(monkeypatch, tmp_path)
    TDB(root).put("op", "k", "cpu", {"b": 32}, band=BAND)
    for mod in (tt, jt):
        assert mod.consult("op", "k", {"b": 64, "c": 1}) == \
            {"b": 32, "c": 1}
        assert mod.consult("op", "other", {"b": 64}) == {"b": 64}
    TDB(root).put("op", "k", "cpu", {"b": 8})
    for mod in (tt, jt):
        assert mod.consult("op", "k", {"b": 64, "c": 1})["b"] == 32
    got, want = tt.provenance(), jt.provenance()
    assert got == want
    assert got["hits"] == 1 and got["misses"] == 1
    assert got["sites"]["op|k"]["tuned_band"] == BAND
    tt.reset()
    assert tt.consult("op", "k", {"b": 64})["b"] == 8   # a fresh process


def test_consult_refuses_inapplicable_hit_like_jax(monkeypatch, tmp_path):
    root = _enable(monkeypatch, tmp_path)
    TDB(root).put("op", "k", "cpu", {"block": -5})

    def check(cfg):
        if cfg["block"] < 1:
            raise ValueError(f"block={cfg['block']} is not positive")

    msgs = []
    for mod in (tt, jt):
        with pytest.raises(ValueError, match="inapplicable") as e:
            mod.consult("op", "k", {"block": 64}, validate=check)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "re-tune or remove the record" in msgs[0]


# ----------------------------------------------------------------- sites

def _k11(cluster=None):
    from dlnetbench_tpu_torch.ops import quantized_matmul as Q
    g = torch.Generator().manual_seed(3)
    x = torch.randn(64, 64, generator=g).to(torch.bfloat16)
    w = (torch.randn(64, 512, generator=g) * 0.1).to(torch.bfloat16)
    out = {}
    for fmt in ("int8", "float8"):
        wq, sw = Q.quantize_tensor(w, fmt)
        sx = Q.scale_from_amax(Q.amax_of(x), fmt)
        out[fmt] = Q.fused_matmul(x, wq, sw, sx, fmt=fmt, cluster=cluster)
    return out


def _k12(cluster=None, fmt="int8"):
    from dlnetbench_tpu_torch.ops import grouped_matmul as GM
    from dlnetbench_tpu_torch.ops import quantized_matmul as Q
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 16, 64, generator=g)
    w = torch.randn(2, 64, 512, generator=g) * 0.1
    counts = torch.tensor([16, 9], dtype=torch.int32)
    if fmt is None:
        return {"none": GM.grouped_matmul(x, w, counts=counts,
                                          cluster=cluster)}
    wq, sw = GM.quantize_experts(w, fmt)
    sx = Q.scale_from_amax(GM.expert_amax(x), fmt)
    return {fmt: GM.grouped_matmul(x, wq, counts=counts, sx=sx, sw=sw,
                                   fmt=fmt, cluster=cluster)}


def _attn_ops():
    g = torch.Generator().manual_seed(5)
    q = torch.randn(1, 128, 2, 64, generator=g, requires_grad=True)
    k = torch.randn(1, 128, 2, 64, generator=g, requires_grad=True)
    v = torch.randn(1, 128, 2, 64, generator=g, requires_grad=True)
    return q, k, v


def _flash(splash: bool):
    from dlnetbench_tpu_torch.ops import flash_attention as FA
    from dlnetbench_tpu_torch.ops.attention_mask import MaskSpec
    q, k, v = _attn_ops()
    out = (FA.splash_attention(q, k, v, MaskSpec(causal=True, window=32))
           if splash else FA.flash_attention(q, k, v, True))
    out.sum().backward()
    return {"o": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}


def _decode(split_from_site: bool, quant: bool = False):
    """K1/K2's decode program site (``SplitOnce``) and the attention it
    feeds on the CPU (the plain version)."""
    from dlnetbench_tpu_torch.serving import decode as D
    from dlnetbench_tpu_torch.serving import kv_cache as KV
    g = torch.Generator().manual_seed(6)
    q = torch.randn(2, 4, 32, generator=g)
    kp = torch.randn(2, 8, 4, 32, generator=g)
    vp = torch.randn(2, 8, 4, 32, generator=g)
    bt = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    lengths = torch.tensor([16, 7], dtype=torch.int32)
    kw = {}
    if quant:
        ks = kp.abs().amax(dim=(2, 3)) / 127
        vs = vp.abs().amax(dim=(2, 3)) / 127
        kp = torch.clamp(torch.round(kp / ks[..., None, None]), -127,
                         127).to(torch.int8)
        vp = torch.clamp(torch.round(vp / vs[..., None, None]), -127,
                         127).to(torch.int8)
        kw = {"k_scale": ks, "v_scale": vs, "fmt": "int8"}
    split = 0
    if split_from_site:
        mc = types.SimpleNamespace(num_heads=4)
        cc = types.SimpleNamespace(num_kv_heads=2, head_dim=32,
                                   page_size=4,
                                   quant_fmt="int8" if quant else None)
        split = D.SplitOnce(mc, cc)(bt)
    return {"att": KV.paged_attention_decode(q, kp, vp, lengths, bt,
                                             split=split, **kw),
            "split": torch.tensor(split)}


def _spmd():
    from dlnetbench_tpu_torch.models import spmd
    r = spmd.SpmdConfig(embed_dim=64, ff_dim=128, seq_len=32,
                        tp_overlap="decomposed",
                        grad_sync="bucketed").resolve_tuned(2, 1, 2)
    return {"knobs": torch.tensor([r.tp_overlap_chunks,
                                   r.grad_bucket_layers])}


# site -> (run the site, the key its consult builds, a valid tuned
# config other than the default where the kernel has one)
SITES = {
    "quantized_matmul": (
        _k11, [("quantized_matmul", tt.params.quantized_matmul_key(
            64, 64, 512, f, torch.bfloat16)) for f in ("int8", "float8")],
        {"cluster": 2}),
    "grouped_ffn": (
        _k12, [("grouped_ffn", tt.params.grouped_ffn_key(
            2, 16, 64, 512, "int8", torch.float32))], {"cluster": 1}),
    "paged_attention": (
        lambda: _decode(True), [("paged_attention",
                                 tt.params.paged_attention_key(
                                     4, 4, 2, 4, 2, 32))],
        {"pages_per_compute_block": 2}),
    "paged_attention_quant": (
        lambda: _decode(True, True), [("paged_attention_quant",
                                       tt.params.paged_attention_quant_key(
                                           4, 4, 2, 4, 2, 32, "int8"))],
        {"pages_per_compute_block": 1}),
    "flash": (lambda: _flash(False), [
        ("flash_fwd", tt.params.flash_fwd_key(1, 128, 2, 2, 64, True,
                                              torch.float32)),
        ("flash_bwd", tt.params.flash_bwd_key(1, 128, 2, 2, 64, True,
                                              torch.float32))], None),
    "splash": (lambda: _flash(True), [
        (op, tt.params.splash_key(1, 128, 2, 2, 64, "causal&window(32)",
                                  torch.float32))
        for op in ("splash_fwd", "splash_bwd")], None),
    "spmd": (_spmd, [
        ("tp_overlap_chunks", tt.params.tp_overlap_chunks_key(
            64, 128, 32, 2, "float32")),
        ("grad_bucket_layers", tt.params.grad_bucket_layers_key(
            4, 2, 1, 64, 128))], {"chunks": 4, "layers": 2}),
}


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("site", sorted(SITES))
def test_site_untuned_empty_db_and_hit(site, monkeypatch, tmp_path):
    """With the tuner off a site consults nothing; an empty DB gives the
    same bits and logs misses; a hit changes the config and not the
    plain version's math (the SPMD knobs change, as they should)."""
    run, keys, tuned = SITES[site]
    off = run()
    assert tt.provenance() is None
    root = _enable(monkeypatch, tmp_path)
    empty = run()
    if site.startswith("paged"):
        # off: the launch sizes its own split; an empty DB: the same
        # default, named
        from dlnetbench_tpu_torch.ops.paged_attention import split_pages
        assert empty.pop("split").item() == split_pages(4, 4)
        off.pop("split")
    assert _same(empty, off)
    prov = tt.provenance()
    assert prov["hits"] == 0 and prov["misses"] == len(keys)
    assert {f"{op}|{key}" for op, key in keys} == set(prov["sites"])
    from dlnetbench_tpu_torch.ops import flash_attention as FA
    for op, key in keys:
        cfg = tuned or (FA.FWD_CONFIG if op.endswith("fwd")
                        else FA.BWD_CONFIG)
        if site == "spmd":
            cfg = {"chunks": tuned["chunks"]} if op.startswith("tp") \
                else {"layers": tuned["layers"]}
        TDB(root).put(op, key, "cpu", cfg, band=BAND)
    tt.reset()
    hit = run()
    prov = tt.provenance()
    assert prov["hits"] == len(keys) and prov["misses"] == 0
    if site == "spmd":
        assert hit["knobs"].tolist() == [4, 2]
    elif site.startswith("paged"):
        assert hit["split"].item() == tuned["pages_per_compute_block"]
        assert torch.equal(hit["att"], off["att"])
    else:
        assert _same(hit, off)


# site -> (run, op, key, a config the kernel cannot take, the refusal)
REFUSALS = {
    "k11_cluster_3": (_k11, "quantized_matmul",
                      SITES["quantized_matmul"][1][0][1], {"cluster": 3},
                      "not one of"),
    "k11_cluster_not_dividing": (
        lambda: _k11(), "quantized_matmul",
        SITES["quantized_matmul"][1][0][1], {"cluster": 4},
        r"dividing N/256 = 2"),
    "k12_master_dtype_cluster_2": (
        lambda: _k12(fmt=None), "grouped_ffn",
        tt.params.grouped_ffn_key(2, 16, 64, 512, "none", torch.float32),
        {"cluster": 2}, "one config cluster=1"),
    "k1_split_not_dividing": (
        lambda: _decode(True), "paged_attention",
        SITES["paged_attention"][1][0][1], {"pages_per_compute_block": 3},
        "does not divide"),
    "flash_other_tile": (
        lambda: _flash(False), "flash_fwd", SITES["flash"][1][0][1],
        {"block_q": 128, "block_k": 128}, "one compiled tile"),
    "splash_bwd_other_tile": (
        lambda: _flash(True), "splash_bwd", SITES["splash"][1][1][1],
        {"bq_dq": 64, "bk_dq": 64, "bq_dkv": 64, "bk_dkv": 64},
        "one compiled tile"),
    "spmd_chunks_zero": (_spmd, "tp_overlap_chunks",
                         SITES["spmd"][1][0][1], {"chunks": 0},
                         "not a positive int"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_site_refuses_a_hit_its_kernel_cannot_take(case, monkeypatch,
                                                   tmp_path):
    """A DB config the card's kernel cannot take is refused with the JAX
    package's message shape — never run on another config, never
    fallen back from."""
    run, op, key, cfg, why = REFUSALS[case]
    root = _enable(monkeypatch, tmp_path)
    TDB(root).put(op, key, "cpu", cfg)
    with pytest.raises(ValueError, match="inapplicable") as e:
        run()
    assert why in str(e.value), str(e.value)


def test_explicit_values_bypass_the_db(monkeypatch, tmp_path):
    """Explicit arguments win: an explicit cluster and an explicit
    ``pages_per_compute_block`` consult nothing, and a bad explicit one
    fails on the plain path too, with JAX's message."""
    from dlnetbench_tpu.serving import kv_cache as JKV
    from dlnetbench_tpu_torch.serving import kv_cache as KV
    _enable(monkeypatch, tmp_path)
    _k11(cluster=2)
    _k12(cluster=1)
    assert tt.provenance() is None
    q = torch.zeros(2, 4, 8)
    kp = torch.zeros(2, 8, 4, 8)
    pidx = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    assert KV.resolve_pages_per_compute_block(q, kp, pidx, 2) == 2
    msgs = []
    for res, args in ((KV.resolve_pages_per_compute_block,
                       (q, kp, pidx, 3)),
                      (JKV.resolve_pages_per_compute_block,
                       (jnp.zeros((2, 4, 8)), jnp.zeros((2, 8, 4, 8)),
                        jnp.asarray(pidx.numpy()), 3))):
        with pytest.raises(ValueError, match="does not divide") as e:
            res(*args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="does not divide"):
        KV.paged_attention_decode(q, kp, kp, torch.full((2,), 16,
                                                        dtype=torch.int32),
                                  pidx, impl="gather",
                                  pages_per_compute_block=3)


def test_jax_fixture_answers_the_port_sites_like_jax(monkeypatch, tmp_path):
    """The JAX package's committed DB fixture under the port: the K11
    record (written with the TPU's grid blocks) is a hit at its shape,
    its block fields riding along beside the card's cluster, and the
    consult's provenance is JAX's for the same shape."""
    from dlnetbench_tpu.ops import quantized_matmul as JQ
    from dlnetbench_tpu_torch.ops import quantized_matmul as Q
    _enable(monkeypatch, tmp_path, with_fixture=True)
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    w = torch.randn(64, 64, generator=torch.Generator().manual_seed(1))
    xt, wt = x.to(torch.bfloat16), w.to(torch.bfloat16)
    wq, sw = Q.quantize_tensor(wt, "int8")
    Q.fused_matmul(xt, wq, sw, Q.scale_from_amax(Q.amax_of(xt), "int8"),
                   fmt="int8")
    xj = jnp.asarray(x.numpy(), jnp.bfloat16)
    wq, sw = JQ.quantize_tensor(jnp.asarray(w.numpy(), jnp.bfloat16), "int8")
    JQ.fused_matmul(xj, wq, sw, JQ.scale_from_amax(
        jnp.max(jnp.abs(xj.astype(jnp.float32))), "int8"), fmt="int8")
    got, want = tt.provenance(), jt.provenance()
    assert got["hits"] == want["hits"] == 1
    assert got["sites"].keys() == want["sites"].keys()
    (site,) = got["sites"]
    assert got["sites"][site]["config"] == {"cluster": 4, "block_m": 32,
                                            "block_n": 64, "block_k": 64}
    for k in ("hit", "tuned_band", "db_path"):
        assert got["sites"][site][k] == want["sites"][site][k]


# ------------------------------------------------------------------ SPMD

SPMD_CASES = {
    "decomposed_hit": dict(tp_overlap="decomposed"),
    "inert_knobs": dict(),
    "explicit_chunks": dict(tp_overlap="decomposed", tp_overlap_chunks=3),
    "bucketed_miss": dict(grad_sync="bucketed"),
    "both": dict(tp_overlap="decomposed", grad_sync="bucketed"),
}


@pytest.mark.parametrize("case", sorted(SPMD_CASES))
def test_resolve_tuned_equals_jax(case, monkeypatch, tmp_path):
    """``SpmdConfig.resolve_tuned`` on the JAX fixture: the port's
    chunk and bucket counts and provenance are JAX's, inert knobs taking
    their defaults with no consult."""
    from dlnetbench_tpu.models.spmd import SpmdConfig as JCfg
    from dlnetbench_tpu_torch.models.spmd import SpmdConfig as TCfg
    _enable(monkeypatch, tmp_path, with_fixture=True)
    kw = dict(embed_dim=64, ff_dim=128, seq_len=32, **SPMD_CASES[case])
    got = TCfg(**kw).resolve_tuned(2, 1, 2)
    want = JCfg(**kw).resolve_tuned(2, 1, 2)
    assert (got.tp_overlap_chunks, got.grad_bucket_layers) == \
        (want.tp_overlap_chunks, want.grad_bucket_layers)
    assert tt.provenance() == jt.provenance()
    if case == "inert_knobs":
        assert tt.provenance() is None
    if case == "decomposed_hit":
        assert got.tp_overlap_chunks == 4


def _agree_worker(rank: int, port: int, out_dir: str, roots: list) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank))
    if roots[rank]:
        os.environ[tt.ENV_DB_DIR] = roots[rank]
    else:
        os.environ.pop(tt.ENV_DB_DIR, None)
    torch.set_num_threads(1)
    from dlnetbench_tpu_torch.models.spmd import SpmdConfig
    from dlnetbench_tpu_torch.parallel import multihost
    multihost.initialize("cpu")
    try:
        cfg = SpmdConfig(embed_dim=64, ff_dim=128, seq_len=32,
                         tp_overlap="decomposed")
        try:
            res = ["ok", cfg.resolve_tuned(1, 1, 2).tp_overlap_chunks]
        except ValueError as e:
            res = ["refused", str(e)]
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        multihost.shutdown()


@pytest.mark.parametrize("case", ["one_db", "rank1_untuned"])
def test_two_gloo_ranks_agree_or_refuse(case, tmp_path):
    """Two gloo ranks resolve one grain: on one DB both take its answer;
    when rank 1 reads no DB (another answer) both refuse, loudly,
    instead of issuing different collectives."""
    root = tmp_path / "tdb"
    root.mkdir()
    shutil.copy(FIXTURE, root / tt.DB_FILENAME)
    roots = [str(root), str(root) if case == "one_db" else None]
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_agree_worker,
                         args=(r, port, str(tmp_path), roots))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not alive, "a rank hung"
    res = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(2)]
    if case == "one_db":
        assert res == [["ok", 4], ["ok", 4]]
    else:
        assert [r[0] for r in res] == ["refused", "refused"]
        assert "(4, 1), (2, 1)" in res[0][1] and res[0][1] == res[1][1]


# --------------------------------------------------------------- records

def test_record_tuning_block_equals_jax_and_reads_back(monkeypatch,
                                                       tmp_path):
    """``global.tuning`` in a port record is JAX's block for the same
    consults; the port's parser, merge and bandwidth read it, and an
    untuned record carries none."""
    from dlnetbench_tpu.metrics.emit import result_to_record as j_record
    from dlnetbench_tpu.proxies.base import ProxyResult as JResult
    from dlnetbench_tpu_torch.analysis.bandwidth import effective_bandwidth
    from dlnetbench_tpu_torch.metrics.emit import result_to_record
    from dlnetbench_tpu_torch.metrics.merge import merge_records
    from dlnetbench_tpu_torch.metrics.parser import records_to_dataframe
    from dlnetbench_tpu_torch.proxies.base import ProxyResult
    meta = {"proxy": "dp", "model": "m", "world_size": 1,
            "comm_model": {"runtimes": [
                {"kind": "allreduce", "bytes": 1024, "group": 1}]},
            "mesh": {"platform": "cpu", "device_kind": "host",
                     "num_hosts": 1, "devices": [{"id": 0, "process": 0}]}}
    args = dict(name="dp", global_meta=meta,
                timers_us={"runtimes": [100.0, 110.0, 105.0]},
                warmup_times_us=[500.0], num_runs=3)
    untuned = result_to_record(ProxyResult(**args))
    assert "tuning" not in untuned["global"]
    _enable(monkeypatch, tmp_path, with_fixture=True)
    key = "fmt=int8,k=64,n=64,t=64,xdtype=bfloat16"
    for mod in (tt, jt):
        mod.consult("quantized_matmul", key, {"cluster": 4})
        mod.consult("quantized_matmul", "t=1", {"cluster": 4})
    rec = result_to_record(ProxyResult(**args))
    want = j_record(JResult(**args))["global"]["tuning"]
    assert rec["global"]["tuning"] == want
    assert {k: v for k, v in rec["global"].items() if k != "tuning"} == \
        untuned["global"]
    assert set(records_to_dataframe([rec])["tuned"]) == {"1/2"}
    merged = merge_records([json.loads(json.dumps(rec))])
    assert merged["global"]["tuning"]["hits"] == 1
    assert set(effective_bandwidth([merged])["tuned"]) == {"1/2"}


# ------------------------------------------------------------------- CLI

def _tune(argv, capsys) -> dict:
    from dlnetbench_tpu_torch.tuning.__main__ import main
    assert main(["tune", "--platform", "cpu", *argv]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_tune_cli_key_equals_jax_cli(tmp_path, capsys):
    """The two CLIs commit the same key and hw for the same shape flags
    (the port's config names the card's knob), and each lists the
    other's DB with ``show``."""
    from dlnetbench_tpu.tuning.__main__ import main as jmain
    from dlnetbench_tpu_torch.tuning.__main__ import main
    flags = ["--op", "quantized_matmul", "--fmt", "int8", "--tokens", "64",
             "--d", "64", "--n", "64", "--rounds", "1", "-k", "1"]
    got = _tune([*flags, "--db", str(tmp_path / "t")], capsys)
    assert jmain(["tune", *flags, "--db", str(tmp_path / "j"),
                  "--candidates", "64,64,64"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (got["op"], got["key"], got["hw"]) == \
        (want["op"], want["key"], want["hw"])
    assert set(got["config"]) == {"cluster"}
    assert got["config"]["cluster"] in (1, 2, 4)
    assert main(["show", "--db", str(tmp_path / "j")]) == 0
    assert json.loads(capsys.readouterr().out.strip()) == want


CLI_SITES = {
    "quantized_matmul": (["--fmt", "float8", "--tokens", "64", "--d", "64",
                          "--n", "512"],
                         lambda: _k11()),
    "paged_attention": (["--batch", "2", "--heads", "4", "--kv_heads", "2",
                         "--head_dim", "32", "--pages", "4",
                         "--page_size", "4"], lambda: _decode(True)),
    "flash_fwd": (["--seq", "128", "--heads", "2", "--kv_heads", "2",
                   "--head_dim", "64"], lambda: _flash(False)),
}


@pytest.mark.parametrize("op", sorted(CLI_SITES))
def test_tune_cli_commit_is_a_hit_at_the_real_site(op, monkeypatch,
                                                   tmp_path, capsys):
    """The CLI's committed record is consulted as a hit by the real site
    (the JAX tests' ``test_tune_cli_*``): search, commit, consult."""
    flags, site = CLI_SITES[op]
    root = tmp_path / "tdb"
    rec = _tune(["--op", op, "--db", str(root), "--rounds", "2", "-k", "1",
                 *flags], capsys)
    assert rec["op"] == op and rec["band"]["n"] == 2 and rec["hw"] == "cpu"
    monkeypatch.setenv(tt.ENV_DB_DIR, str(root))
    tt.reset()
    site()
    sites = tt.provenance()["sites"]
    assert sites[f"{op}|{rec['key']}"]["hit"] is True
    assert sites[f"{op}|{rec['key']}"]["tuned_band"] == rec["band"]


@pytest.mark.parametrize("op,why", [
    ("tp_overlap_chunks", "one device has no ring to overlap"),
    ("grad_bucket_layers", "one device has no grad sync to schedule")])
def test_tune_cli_spmd_ops_need_two_ranks(op, why, tmp_path):
    from dlnetbench_tpu_torch.tuning.__main__ import main
    with pytest.raises(SystemExit) as e:
        main(["tune", "--op", op, "--db", str(tmp_path), "--platform",
              "cpu"])
    assert str(e.value).startswith(f"{op} tuning needs >= 2 devices "
                                   f"({why})")


def test_tune_cli_refuses_what_the_card_cannot_run(tmp_path, capsys):
    from dlnetbench_tpu_torch.tuning.__main__ import main
    assert main(["tune", "--op", "flash_fwd", "--db", str(tmp_path),
                 "--platform", "cpu", "--seq", "128", "--head_dim", "64",
                 "--candidates", "128,128"]) == 2
    assert "one compiled tile" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        main(["tune", "--op", "quantized_matmul", "--fmt", "none",
              "--db", str(tmp_path)])
    assert main(["show"]) == 2          # no --db and no DLNB_TUNING_DB_DIR


# ------------------------------------------------------------- tuned_ab

@pytest.fixture
def tiny_bench(monkeypatch):
    from dlnetbench_tpu_torch import bench
    from dlnetbench_tpu_torch.models import bench_step as bs
    monkeypatch.setattr(bs, "BATCH", 2)
    monkeypatch.setattr(bs, "SEQ", 32)        # 64 tokens
    card = types.SimpleNamespace(embed_dim=64, ff_dim=1024)
    return lambda: bench.bench_tuned_ab(card, None, "cpu",
                                        torch.device("cpu"))


def test_bench_tuned_ab_end_to_end_tiny(tiny_bench, capsys):
    """The ``tuned_ab`` line at a tiny CPU shape: the seeded search runs
    over three candidates (the frozen default among them), commits to an
    ephemeral DB (removed after), and the line carries both variants'
    bands, the configs and the prior hits: an ms line for the
    sentinel."""
    from dlnetbench_tpu_torch.sentinel import is_ms_line
    line = tiny_bench()
    assert json.loads(capsys.readouterr().out.strip()) == line
    for sub in ("tuned_ms", "frozen_ms", "ratio_tuned_vs_frozen"):
        assert line[sub]["n"] == 3
    assert line["db_prior_hit"] == {"up": False, "down": False}
    assert "[ephemeral]" in line["metric"]
    assert not Path(line["db_path"]).parent.exists()
    for stage in ("up", "down"):
        assert set(line["configs"][stage]) == {"cluster"}
        assert line["search"][stage]["candidates"] == 3
    assert line["vs_baseline"] is None and is_ms_line(line)


def test_bench_tuned_ab_reuses_existing_db_record(tiny_bench, monkeypatch,
                                                  tmp_path):
    """A record the DB already holds is measured, never overwritten; the
    other projection is searched and committed."""
    root = _enable(monkeypatch, tmp_path)
    up_key = tt.params.quantized_matmul_key(64, 64, 1024, "float8",
                                            torch.bfloat16)
    TDB(root).put("quantized_matmul", up_key, "cpu", {"cluster": 2})
    line = tiny_bench()
    assert line["db_prior_hit"] == {"up": True, "down": False}
    assert line["search"]["up"] == {"reused_db_record": True,
                                    "tuned_band": None}
    assert line["configs"]["up"] == {"cluster": 2}
    assert TDB(root).get("quantized_matmul", up_key,
                         "cpu")["config"] == {"cluster": 2}
    assert line["search"]["down"]["candidates"] == 3
    assert len(TDB(root).load()) == 2 and "[ephemeral]" not in \
        line["metric"]


def test_tuned_ab_line_equals_jax_on_the_same_timings():
    """The line's schema and numbers are the JAX bench's
    ``_tuned_ab_line`` on the same summaries, rounds and roofline."""
    import bench as JBENCH
    from dlnetbench_tpu_torch import bench
    from dlnetbench_tpu_torch.metrics import stats
    rounds = {"tuned": [0.010, 0.011, 0.0105],
              "frozen": [0.013, 0.012, 0.0125]}
    sums = {k: stats.summarize(v) for k, v in rounds.items()}
    kw = dict(metric="tuned A/B: test", db_path="/x/tuning_db.jsonl",
              configs={"up": {"cluster": 2}, "down": {"cluster": 4}},
              db_prior_hit={"up": False, "down": True},
              search_meta={"up": {"candidates": 3}})
    got = bench.tuned_ab_line(sums, rounds, 10 ** 12, 0.008, **kw)
    want = JBENCH._tuned_ab_line(sums, rounds, 10 ** 12, 0.008, **kw)
    assert got == want and got["band_disjoint_win"] is True
    np.testing.assert_equal(list(got), list(want))
