"""Prefix sharing and MoE decode on a CUDA card: kernels K1/K2 over block
tables that alias pages (the shared prefix read by several slots)
against their plain gather, the copy-on-write page copy on card pools
and scales against the CPU's, ``moe_mlp_rounds`` on the card against
the CPU, the MoE decode programs' host reads (exactly ``num_layers`` a
fused trip, none for a dense model, none besides inside a dispatch),
and served runs with sharing and with a MoE model whose streams equal
the unshared / 1-step runs' with K1 or K2 launched layers x device
steps.

This file imports neither jax nor the JAX package, so it runs on the
card machine: ``python -m pytest --noconftest -m cuda
tests/test_torch_card*.py`` (``chip_smoke.py`` runs it so).  Every case
takes the ``cuda_device`` fixture, which skips where no card is
visible; the CPU side is held against the JAX package in
tests/test_torch_prefix_sharing.py and test_torch_moe_serving.py."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from dlnetbench_tpu_torch.models.transformer import (TransformerConfig,
                                                     init_params)
from dlnetbench_tpu_torch.ops import paged_attention as PA
from dlnetbench_tpu_torch.ops import paged_attention_quant as PAQ
from dlnetbench_tpu_torch.serving import decode as D
from dlnetbench_tpu_torch.serving import kv_cache as KV
from dlnetbench_tpu_torch.serving import moe_decode as MD
from dlnetbench_tpu_torch.serving import scheduler as S
from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan

# head_dim 32: the smallest the kernels take
MODEL = dict(vocab_size=128, embed_dim=128, num_heads=4, num_kv_heads=2,
             ff_dim=256, num_layers=2, seq_len=64, dtype="float32")
MOE = dict(MODEL, num_experts=4, top_k=2, moe_capacity_factor=1.0)
SERVING = dict(slots=4, page_size=8, num_pages=48, max_seq_len=64,
               prefill_chunk=8, warmup_requests=0)
# a 20-token system prompt over 8-token pages: two shared pages and a
# copy-on-write boundary page of 4 rows; on a quantized cache the
# copied rows are quantized again with the sharer's own rows, so there
# the JAX package's bar (equal streams) holds at a page-aligned prefix
PREFIX_PLAN = dict(kind="poisson", rate_rps=500.0, num_requests=8, seed=5,
                   prompt_len=[24, 36], output_len=[4, 12],
                   shared_prefix_len=20, prefix_pool=2)
ALIGNED_PLAN = dict(PREFIX_PLAN, shared_prefix_len=16)
PLAN = dict(kind="poisson", rate_rps=500.0, num_requests=8, seed=5,
            prompt_len=[5, 20], output_len=[4, 12])
FMT = {"int8": "int8", "fp8": "float8"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: prefix sharing and MoE decode "
                    "launch the Hopper kernels K1/K2 only there (their "
                    "CPU side is tested against JAX in tests/"
                    "test_torch_prefix_sharing.py and "
                    "test_torch_moe_serving.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _aliased_tables(rng, b, pmax, pages, shared):
    """Block tables whose first ``shared`` columns name the same pages in
    every row (a shared prefix), the rest private pages."""
    perm = rng.permutation(pages)
    bt = np.empty((b, pmax), np.int32)
    bt[:, :shared] = perm[:shared]
    bt[:, shared:] = perm[shared:shared + b * (pmax - shared)].reshape(
        b, pmax - shared)
    return bt


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("shared", [1, 5])
def test_kernels_over_aliased_block_tables(cuda_device, cache_dtype,
                                           shared):
    """K1 (f32 pages) and K2 (int8, e4m3) over block tables where every
    slot reads the same prefix pages: one launch, equal to the plain
    gather within 1e-5 (f32) / 1e-4 (8-bit, as K2's own card test)."""
    rng = np.random.default_rng(3 + shared)
    b, hq, hkv, dh, pages, psize, pmax = 4, 8, 2, 64, 64, 16, 8
    bt = torch.from_numpy(_aliased_tables(rng, b, pmax, pages, shared)).to(
        cuda_device)
    lengths = torch.tensor([shared * psize + 1, 100, 37 + shared * psize,
                            128], dtype=torch.int32, device=cuda_device)
    q = torch.from_numpy(rng.standard_normal((b, hq, dh), np.float32)
                         * dh ** -0.5).to(cuda_device)
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (hkv, pages, psize, dh), np.float32)).to(cuda_device)
        for _ in range(2))
    if cache_dtype == "bf16":
        before = PA.launches
        got = KV.paged_attention_decode(q, kp, vp, lengths, bt)
        torch.cuda.synchronize()
        assert PA.launches == before + 1
        ref = KV.paged_attention_decode(q, kp, vp, lengths, bt,
                                        impl="gather")
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
        return
    pools = []
    for p in (kp, vp):
        amax = p.abs().amax(dim=(2, 3))
        fmax = 127.0 if cache_dtype == "int8" else 448.0
        scale = amax.clamp_min(1e-12) / fmax
        x = p / scale[:, :, None, None]
        qp = (x.round().clamp(-127, 127).to(torch.int8)
              if cache_dtype == "int8"
              else x.clamp(-448, 448).to(torch.float8_e4m3fn))
        pools += [qp, scale]
    kq, ks, vq, vs = pools
    before = PAQ.launches
    got = KV.paged_attention_decode(q, kq, vq, lengths, bt, k_scale=ks,
                                    v_scale=vs, fmt=FMT[cache_dtype])
    torch.cuda.synchronize()
    assert PAQ.launches == before + 1
    ref = KV.paged_attention_decode(q, kq, vq, lengths, bt, k_scale=ks,
                                    v_scale=vs, fmt=FMT[cache_dtype],
                                    impl="gather")
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype", ["bf16", "int8", "fp8"])
def test_cow_copy_on_card_pools_equals_cpu(cuda_device, cache_dtype):
    """The copy-on-write page copy on the card's pools (and scales): the
    bytes equal the CPU's copy, every other page untouched."""
    cc = KV.CacheConfig(num_layers=2, num_kv_heads=2, head_dim=32,
                        num_pages=10, page_size=8, max_seqs=2,
                        max_pages_per_seq=4, cache_dtype=cache_dtype)
    gen = torch.Generator().manual_seed(2)
    cpu = KV.device_buffers(cc, "cpu")
    for t in cpu:
        bits = KV._bits(t)
        bits.copy_(torch.randint(0, 120, bits.shape, generator=gen)
                   .to(bits.dtype))
    card = tuple(t.to(cuda_device) for t in cpu)
    KV.copy_page(cpu, 7, 2)
    KV.copy_page(card, 7, 2)
    for a, b in zip(cpu, card):
        assert torch.equal(KV._bits(a), KV._bits(b).cpu())
        assert torch.equal(KV._bits(a)[:, :, 2], KV._bits(a)[:, :, 7])


@pytest.mark.cuda
@pytest.mark.parametrize("top_k,capacity", [(2, 1), (2, 2), (1, 4)])
def test_moe_mlp_rounds_card_equals_cpu(cuda_device, top_k, capacity):
    """``moe_mlp_rounds`` on the card against the CPU (f32, TF32 off):
    load and rounds exact, the output within 1e-5 of max-abs, with a
    skew bias and a slot mask."""
    rng = np.random.RandomState(top_k * 10 + capacity)
    b, d, e, h = 8, 64, 4, 96
    arrs = [rng.randn(b, d).astype(np.float32),
            rng.randn(d, e).astype(np.float32),
            (rng.randn(e, d, h) * 0.1).astype(np.float32),
            (rng.randn(e, d, h) * 0.1).astype(np.float32),
            (rng.randn(e, h, d) * 0.1).astype(np.float32)]
    active = torch.from_numpy(rng.rand(b) < 0.75)
    bias = MD.skew_bias(e, 2.0, 5)
    out = {}
    for dev in ("cpu", cuda_device):
        y, load, rounds = MD.moe_mlp_rounds(
            *(torch.from_numpy(a).to(dev) for a in arrs), top_k=top_k,
            capacity=capacity, bias=bias.to(dev), active=active.to(dev))
        out[str(dev)] = (y.cpu(), load.cpu(), rounds)
    (yc, lc, rc), (yg, lg, rg) = out["cpu"], out[str(cuda_device)]
    assert torch.equal(lc, lg) and rc == rg >= 1
    assert float((yc - yg).abs().max()) <= 1e-5 * float(yc.abs().max())


def _loop_inputs(device, model):
    cfg = TransformerConfig(**model)
    cc = KV.CacheConfig(num_layers=2, num_kv_heads=2, head_dim=32,
                        num_pages=16, page_size=8, max_seqs=2,
                        max_pages_per_seq=6)
    params = init_params(cfg, seed=1, device=device)
    k, v = KV.device_buffers(cc, device)
    bt = torch.arange(12, dtype=torch.int32, device=device).reshape(2, 6)
    state = torch.zeros((D.STATE_ROWS, 2), dtype=torch.int32,
                        device=device)
    state[:, 0] = torch.tensor([3, 0, 9, 40, 1, 0])
    state[:, 1] = torch.tensor([5, 0, 4, 40, 2, 0])
    return cfg, cc, params, k, v, bt, state


@pytest.mark.cuda
@pytest.mark.parametrize("trips", [1, 4])
def test_fused_moe_trip_reads_num_layers_values_dense_none(cuda_device,
                                                           trips,
                                                           monkeypatch):
    """One fused dispatch of ``trips`` trips under
    ``set_sync_debug_mode("error")``, the round-count read alone let
    through: a MoE model reads exactly num_layers x trips values back
    (``moe_decode.host_reads`` agrees) and makes no other host sync, a
    dense model reads none; K1 launched layers x trips either way."""
    real = MD._read_max
    calls = []

    def read(load):
        calls.append(1)
        torch.cuda.set_sync_debug_mode(0)
        try:
            return real(load)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(MD, "_read_max", read)
    for model, moe in ((MOE, True), (MODEL, False)):
        cfg, cc, params, k, v, bt, state = _loop_inputs(cuda_device, model)
        loop = D.make_multi_step_decode(cfg, cc, 4)
        loop(params, k, v, state, bt, 1)            # builds, loads K1
        torch.cuda.synchronize()
        calls.clear()
        reads0, launches0 = MD.host_reads, PA.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = loop(params, k, v, state, bt, trips)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert len(calls) == (cfg.num_layers * trips if moe else 0)
        assert MD.host_reads - reads0 == len(calls)
        assert PA.launches - launches0 == cfg.num_layers * trips
        if moe:
            load, rounds = out[-2:]
            assert int(load.sum()) == 2 * cfg.top_k * cfg.num_layers * trips
            assert rounds >= cfg.num_layers * trips
        assert int(out[-3 if moe else -1]) == trips


def _params(cfg, device):
    """Seeded weights made on the CPU, then moved: the same values on
    either device."""
    tree = init_params(cfg, seed=3, device="cpu")
    return {k: ({n: w.to(device) for n, w in v.items()}
                if isinstance(v, dict) else v.to(device))
            for k, v in tree.items()}


def _served(device, model, plan, **kw):
    cfg = TransformerConfig(**model)
    eng = S.Engine(cfg, S.ServingConfig(**{**SERVING, **kw}),
                   params=_params(cfg, device), device=device)
    PA.launches = PAQ.launches = S.decode_device_steps = 0
    reqs = ArrivalPlan.from_dict(plan).sample()
    done, _ = eng.run(reqs)
    assert len(done) == len(reqs)
    assert eng.cache.pages_in_use == 0
    if torch.device(device).type == "cuda":
        launches = PA.launches if eng.cache_cfg.cache_dtype == "bf16" \
            else PAQ.launches
        assert launches == cfg.num_layers * S.decode_device_steps > 0
    return dict(eng.token_streams), eng


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("n", [1, 8])
def test_sharing_streams_equal_unshared_on_the_kernels(cuda_device,
                                                       cache_dtype, n):
    """Served with sharing (f32, K1 / K2 over aliased block tables): the
    streams equal the unshared run's, prefixes were shared (with
    copy-on-write copies on the unquantized cache's unaligned prefix),
    and K1 / K2 ran layers x device steps."""
    plan = PREFIX_PLAN if cache_dtype == "bf16" else ALIGNED_PLAN
    off, _ = _served(cuda_device, MODEL, plan, cache_dtype=cache_dtype,
                     multi_step_n=n)
    on, eng = _served(cuda_device, MODEL, plan, cache_dtype=cache_dtype,
                      multi_step_n=n, prefix_sharing=True)
    assert on == off
    st = eng.cache.stats()["prefix"]
    assert st["hits"] > 0 and st["pages_shared"] > 0
    if cache_dtype == "bf16":
        assert st["cow_copies"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_moe_nstep_equals_one_step_on_the_card(cuda_device, cache_dtype):
    """A MoE model served on the card (f32): N=8 streams equal N=1 and
    equal the CPU's, K1 / K2 layers x device steps, and a skew raises
    the mean rounds."""
    one, e1 = _served(cuda_device, MOE, PLAN, cache_dtype=cache_dtype)
    got, _ = _served(cuda_device, MOE, PLAN, cache_dtype=cache_dtype,
                     multi_step_n=8)
    assert got == one
    cpu, ec = _served("cpu", MOE, PLAN, cache_dtype=cache_dtype)
    assert cpu == one
    assert ec.moe_block()["expert_load"] == e1.moe_block()["expert_load"]
    _, skewed = _served(cuda_device, MOE, PLAN, cache_dtype=cache_dtype,
                        moe_skew=20.0, moe_skew_seed=1)
    assert skewed.moe_block()["rounds_mean"] > e1.moe_block()["rounds_mean"]
