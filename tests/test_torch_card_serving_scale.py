"""Serving at scale on CUDA cards: the page-migration channel's payload
bit for bit in the stored dtype (one card and across two), K1/K2 over
KV-head-sharded pools against the unsharded launch, a source page
reused right after a send leaving the landed payload intact (the
channel's reuse fence), the decode dispatch and a send issuing no
host sync, and a kv_shard=2 engine and a disaggregated server giving
the one-engine streams.

This file imports neither jax nor the JAX package, so it runs on the
card machine: ``python -m pytest --noconftest -m cuda
tests/test_torch_card*.py`` (``chip_smoke.py`` runs it so).  Every case
takes the ``cards`` fixture: ``one`` names cuda:0 twice, ``two`` the
first two cards and skips below two; both skip where no card is
visible.  The CPU side is held against the JAX package in
tests/test_torch_serving_scale.py and test_torch_disagg.py."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from dlnetbench_tpu_torch.models.transformer import (TransformerConfig,
                                                     init_params)
from dlnetbench_tpu_torch.ops import page_migration as PM
from dlnetbench_tpu_torch.ops import paged_attention as PA
from dlnetbench_tpu_torch.ops import paged_attention_quant as PAQ
from dlnetbench_tpu_torch.serving import kv_cache as KV
from dlnetbench_tpu_torch.serving import scheduler as S
from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan

# head_dim 32: the smallest the kernels take
MODEL = dict(vocab_size=128, embed_dim=128, num_heads=4, num_kv_heads=2,
             ff_dim=256, num_layers=2, seq_len=64, dtype="float32")
SERVING = dict(slots=4, page_size=8, num_pages=48, max_seq_len=64,
               prefill_chunk=8, warmup_requests=0)
PLAN = dict(kind="poisson", rate_rps=500.0, num_requests=8, seed=5,
            prompt_len=[5, 20], output_len=[4, 12])
CHAN = dict(num_layers=2, num_kv_heads=4, head_dim=32, num_pages=24,
            page_size=8, max_seqs=2, max_pages_per_seq=4)
FMT = {"int8": "int8", "fp8": "float8"}


@pytest.fixture(params=["one", "two"])
def cards(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the migration streams and the "
                    "sharded K1/K2 launches run only there (their CPU "
                    "side is tested against JAX in tests/"
                    "test_torch_serving_scale.py and test_torch_disagg.py)")
    if request.param == "two":
        if torch.cuda.device_count() < 2:
            pytest.skip("needs two cards (the one-card case names "
                        "cuda:0 twice)")
        return [torch.device("cuda", 0), torch.device("cuda", 1)]
    torch.backends.cuda.matmul.allow_tf32 = False
    return [torch.device("cuda", 0)] * 2


def _filled(cfg, device, seed):
    """Pools of ``cfg`` on ``device`` filled with seeded values in the
    stored dtype (scales positive)."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for t in KV.device_buffers(cfg, "cpu"):
        if t.dtype == torch.int8:
            v = torch.randint(-127, 128, t.shape, generator=g,
                              dtype=torch.int8)
        elif t.dtype == torch.float8_e4m3fn:
            v = torch.randn(t.shape, generator=g).to(torch.float8_e4m3fn)
        elif t.dim() == 3:
            v = torch.rand(t.shape, generator=g) + 0.01
        else:
            v = torch.randn(t.shape, generator=g).to(t.dtype)
        out.append(v.to(device))
    return tuple(out)


def _bits(t):
    """A tensor's bytes as numpy (bf16 and e4m3 as integers)."""
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    elif t.dtype == torch.float8_e4m3fn:
        t = t.view(torch.uint8)
    return t.numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype", ["bf16", "int8", "fp8"])
def test_migration_payload_bit_exact_on_card(cards, cache_dtype):
    """send -> scatter from the first device to the second lands every
    page (and scale) bit for bit, in the stored dtype."""
    cfg = KV.CacheConfig(**CHAN, dtype="bfloat16",
                         cache_dtype=cache_dtype).validate()
    src = _filled(cfg, cards[0], 0)
    ch = PM.MigrationChannel(cfg, cards[1], chunk_pages=3)
    src_ids, dst_ids = [5, 1, 7, 2, 11], [0, 3, 9, 11, 4]
    dst = ch.scatter(KV.device_buffers(cfg, cards[1]),
                     ch.send(src, src_ids), dst_ids)
    for got, want in zip(dst, src):
        assert got.dtype == want.dtype and got.device == cards[1]
        for s, d in zip(src_ids, dst_ids):
            np.testing.assert_array_equal(_bits(got[:, :, d]),
                                          _bits(want[:, :, s]))
    assert ch._sends[0].bytes == 5 * cfg.page_bytes


@pytest.mark.cuda
def test_reused_source_page_leaves_payload_intact(cards):
    """A long kernel runs on the source stream, the send is issued, the
    source pages are overwritten at once on the same stream (the
    prefill replica reusing freed pages): the landed payload is the
    pages' content at the send, not the overwrite."""
    cfg = KV.CacheConfig(**CHAN, dtype="bfloat16").validate()
    src = _filled(cfg, cards[0], 1)
    want = [t[:, :, [2, 3, 4, 5]].clone() for t in src]
    ch = PM.MigrationChannel(cfg, cards[1], chunk_pages=2)
    with torch.cuda.device(cards[0]):
        torch.cuda._sleep(50_000_000)      # keep the source stream busy
        pending = ch.send(src, [2, 3, 4, 5], fence=False)
        for t in src:
            t[:, :, 2:6] = 7                # the reuse write
    pending.wait()
    dst = ch.scatter(KV.device_buffers(cfg, cards[1]), pending,
                     [0, 1, 2, 3])
    for got, w in zip(dst, want):
        np.testing.assert_array_equal(_bits(got[:, :, :4]), _bits(w))
    assert bool((src[0][:, :, 2:6] == 7).all())


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype", ["bf16", "int8", "fp8"])
def test_sharded_decode_attention_matches_unsharded(cards, cache_dtype):
    """K1/K2 over pools split along the KV heads, one launch a shard, the
    output concatenated on the first device: within K1's bar of the
    unsharded launch (each head's math is the same kernel's).  At Dh 128
    a bf16 block takes over 48 KiB of shared memory, so the second
    card's launch needs the raised cap set on that card too."""
    b, hq, hkv, dh, s, pmax = 4, 8, 4, 128, 16, 8
    cfg = KV.CacheConfig(num_layers=1, num_kv_heads=hkv, head_dim=dh,
                         num_pages=40, page_size=s, max_seqs=b,
                         max_pages_per_seq=pmax, dtype="bfloat16",
                         cache_dtype=cache_dtype).validate()
    pools = _filled(cfg, cards[0], 2)
    g = torch.Generator().manual_seed(3)
    q = (torch.randn(b, hq, dh, generator=g) * dh ** -0.5).to(
        torch.bfloat16).to(cards[0])
    bt = torch.randperm(40, generator=g)[:b * pmax].reshape(b, pmax).to(
        torch.int32).to(cards[0])
    lengths = torch.tensor([1, 17, 64, 128], dtype=torch.int32,
                           device=cards[0])
    quant = cache_dtype != "bf16"
    fmt = FMT.get(cache_dtype)
    ref = KV.paged_attention_decode(
        q, pools[0][0], pools[1][0], lengths, bt,
        k_scale=pools[2][0] if quant else None,
        v_scale=pools[3][0] if quant else None, fmt=fmt)
    shards = tuple(KV.HeadShards(
        t[:, sl].contiguous().to(d) for sl, d in
        ((slice(0, hkv // 2), cards[0]), (slice(hkv // 2, hkv), cards[1])))
        for t in pools)
    PA.launches = PAQ.launches = 0
    got = KV.paged_attention_decode(
        q, shards[0][0], shards[1][0], lengths, bt,
        k_scale=shards[2][0] if quant else None,
        v_scale=shards[3][0] if quant else None, fmt=fmt)
    assert (PAQ.launches if quant else PA.launches) == 2
    assert got.device == cards[0] and got.shape == ref.shape
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2e-2, err


def _streams(eng, plan):
    eng.run(plan.sample())
    return {rid: list(t) for rid, t in eng.token_streams.items()}


@pytest.mark.cuda
def test_kv_shard_engine_streams_and_launches(cards):
    """A kv_shard=2 engine gives the kv_shard=1 engine's greedy streams,
    K1 launched once a shard, a layer and a decode step."""
    mc = TransformerConfig(**MODEL)
    params = init_params(mc, seed=0, device=cards[0])
    plan = ArrivalPlan(**PLAN)
    one = _streams(S.Engine(mc, S.ServingConfig(**SERVING), params=params,
                            devices=cards[:1]), plan)
    PA.launches = 0
    S.decode_device_steps = 0
    eng = S.Engine(mc, S.ServingConfig(**SERVING, kv_shard=2),
                   params=params, devices=cards)
    two = _streams(eng, plan)
    assert two == one
    assert PA.launches == 2 * mc.num_layers * S.decode_device_steps > 0


@pytest.mark.cuda
def test_disagg_streams_equal_monolithic_on_card(cards):
    """The disaggregated server's streams equal the world-2 monolithic
    engine's, int8 pages on the wire, every request sent once."""
    from dlnetbench_tpu_torch.serving.disagg import DisaggServer
    mc = TransformerConfig(**MODEL)
    params = init_params(mc, seed=0, device=cards[0])
    plan = ArrivalPlan(**PLAN)
    kw = dict(SERVING, cache_dtype="int8", multi_step_n=4, world=2)
    mono = _streams(S.Engine(mc, S.ServingConfig(**kw), params=params,
                             devices=cards), plan)
    srv = DisaggServer(mc, S.ServingConfig(**kw, disaggregate=True),
                       params=params, devices=cards)
    srv.run(plan.sample())
    assert srv.token_streams == mono
    assert srv.channel.stats_block()["sends"] == PLAN["num_requests"]


@pytest.mark.cuda
def test_dispatch_and_send_issue_no_host_sync(cards):
    """A fused decode dispatch and an unfenced migration send return to
    the host without a synchronisation (``set_sync_debug_mode``)."""
    mc = TransformerConfig(**MODEL)
    eng = S.Engine(mc, S.ServingConfig(**SERVING, multi_step_n=4),
                   params=init_params(mc, seed=0, device=cards[0]),
                   devices=cards[:1])
    eng._reset_state()
    eng._t0 = 0.0
    eng._now = lambda: 0.0
    eng.pending = [ArrivalPlan(**PLAN).sample()[0]]
    eng._admit_arrivals(0.0)
    eng.dstate.carries()                  # the admission flush
    torch.cuda.synchronize()
    ch = PM.MigrationChannel(eng.cache_cfg, cards[1])
    torch.cuda.set_sync_debug_mode("error")
    try:
        ctx = eng._step_dispatch()
        pending = ch.send(eng.pools, [0, 1], fence=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eng._step_complete(ctx)
    pending.wait()
    assert ctx is not None and ctx["fused"]
