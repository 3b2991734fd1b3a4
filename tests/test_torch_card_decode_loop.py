"""The fused decode loop, seeded sampling and speculative decode on a
CUDA card: N-step streams equal 1-step streams over kernels K1 and K2,
the device key twin against the host twin's golden values, one fused
dispatch and one speculative round with no host sync, the gated
K+1-row write against its CPU result, the speculative verify pass
against iterated 1-step calls, speculative streams run to completion,
and sampled streams against the 1-step ones.

This file imports neither jax nor the JAX package, so it runs on the
card machine: ``python -m pytest --noconftest -m cuda
tests/test_torch_card*.py`` (``chip_smoke.py`` runs it so).  Every case
takes the ``cuda_device`` fixture, which skips where no card is
visible; the CPU side is held against the JAX package in
tests/test_torch_decode_loop.py, test_torch_sampling.py and
test_torch_speculative.py."""
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
from dlnetbench_tpu_torch.serving import sampling as SMP
from dlnetbench_tpu_torch.serving import scheduler as S
from dlnetbench_tpu_torch.serving import speculative as SP
from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan

# head_dim 32: the smallest the kernels take
MODEL = dict(vocab_size=128, embed_dim=128, num_heads=4, num_kv_heads=2,
             ff_dim=256, num_layers=2, seq_len=64, dtype="float32")
SERVING = dict(slots=4, page_size=8, num_pages=48, max_seq_len=64,
               prefill_chunk=8, warmup_requests=0)
PLAN = dict(kind="poisson", rate_rps=500.0, num_requests=8, seed=5,
            prompt_len=[5, 20], output_len=[4, 16])
CACHE = dict(num_layers=2, num_kv_heads=2, head_dim=32, num_pages=16,
             page_size=8, max_seqs=2, max_pages_per_seq=6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode loop launches the "
                    "Hopper kernels K1/K2 only there (its CPU side is "
                    "tested against JAX in tests/test_torch_decode_loop"
                    ".py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _streams(device, **kw):
    cfg = TransformerConfig(**MODEL)
    eng = S.Engine(cfg, S.ServingConfig(**{**SERVING, **kw}),
                   params=init_params(cfg, seed=3, device=device),
                   device=device)
    done, _ = eng.run(ArrivalPlan.from_dict(PLAN).sample())
    assert len(done) == PLAN["num_requests"]
    return dict(eng.token_streams), eng


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype", ["bf16", "int8", "fp8"])
def test_nstep_equals_one_step_on_the_kernels(cuda_device, cache_dtype):
    """N=8 greedy streams equal N=1 exactly over K1 (bf16 label: f32
    pages here) and K2, and the kernel ran layers x device steps."""
    one, _ = _streams(cuda_device, cache_dtype=cache_dtype)
    PA.launches = PAQ.launches = S.decode_device_steps = 0
    got, eng = _streams(cuda_device, cache_dtype=cache_dtype,
                        multi_step_n=8)
    assert got == one
    mine = PA.launches if cache_dtype == "bf16" else PAQ.launches
    other = PAQ.launches if cache_dtype == "bf16" else PA.launches
    assert mine == MODEL["num_layers"] * S.decode_device_steps > 0
    assert other == 0
    assert eng.decode_loop_block()["steps_per_dispatch"] > 1.0


@pytest.mark.cuda
def test_device_u01_matches_host_golden_values(cuda_device):
    """The device chain on the card: key_bits(0, 0, 0, 0) = 0x37dd7702
    in full, and u01 equal to the host twin over a grid."""
    h = SMP._fmix32_host(SMP._GOLDEN)
    x = torch.zeros(1, dtype=torch.int64, device=cuda_device) ^ h
    for v in (0, 0, 0):
        x = SMP._fmix32_dev(x ^ v)
    assert int(x[0]) == 0x37DD7702 == SMP.key_bits(0, 0, 0, 0)
    s = SMP.DeviceSampler(SMP.check_sampling_config(
        temperature=1.0, top_k=0, top_p=1.0, sample_seed=7, grammar=""),
        16, cuda_device)
    rng = np.random.RandomState(0)
    uids = rng.randint(-2**31, 2**31 - 1, 512).astype(np.int32)
    ctrs = rng.randint(0, 2**31 - 1, 512).astype(np.int32)
    for lane in range(4):
        dev = s.u01(torch.from_numpy(uids).to(cuda_device),
                    torch.from_numpy(ctrs).to(cuda_device), lane)
        host = np.float32([SMP.key_u01(7, int(u), int(c), lane)
                           for u, c in zip(uids, ctrs)])
        np.testing.assert_array_equal(dev.cpu().numpy(), host)


def _op_inputs(device, seed=0):
    cfg = TransformerConfig(**MODEL)
    cc = KV.CacheConfig(**CACHE)
    params = init_params(cfg, seed=seed, device=device)
    k, v = KV.device_buffers(cc, device)
    bt = torch.arange(12, dtype=torch.int32, device=device).reshape(2, 6)
    state = torch.zeros((D.STATE_ROWS, 2), dtype=torch.int32,
                        device=device)
    state[:, 0] = torch.tensor([3, 0, 9, 40, 1, 0])
    state[:, 1] = torch.tensor([5, 0, 4, 40, 2, 0])
    return cfg, cc, params, k, v, bt, state


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [False, True])
def test_fused_dispatch_and_spec_round_make_no_host_sync(cuda_device,
                                                         sampled):
    """One fused dispatch and one speculative round (truncated drafter:
    K1 in the drafter, gather math in the verify pass) run under
    ``set_sync_debug_mode("error")``: nothing reads back or uploads
    between the launches."""
    cfg, cc, params, k, v, bt, state = _op_inputs(cuda_device)
    sampler = None
    if sampled:
        sampler = SMP.DeviceSampler(SMP.check_sampling_config(
            temperature=0.8, top_k=5, top_p=0.9, sample_seed=7,
            grammar="json"), MODEL["vocab_size"], cuda_device)
    loop = D.make_multi_step_decode(cfg, cc, 4, sampler=sampler)
    spec = SP.make_spec_decode_loop(cfg, cc, 2, spec_k=3,
                                    drafter="truncated", drafter_layers=1,
                                    sampler=sampler)
    table = torch.zeros((2, MODEL["vocab_size"]), dtype=torch.int32,
                        device=cuda_device)
    loop(params, k, v, state, bt, 1)              # builds, loads K1
    spec(params, k, v, state, table, bt, 1)
    torch.cuda.synchronize()
    before = PA.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = loop(params, k, v, state, bt, 4)
        sout = spec(params, k, v, state, table, bt, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # the loop: layers x 4 trips; the round: the drafter's 1 layer x 3
    # drafts and none in the verify pass
    assert PA.launches - before == cfg.num_layers * 4 + 1 * 3
    assert int(out[-1]) == 4 and int(sout[6]) == 1
    assert int(out[-2].sum()) == 8


@pytest.mark.cuda
def test_gated_k1_row_write_matches_cpu(cuda_device):
    """The gated page write over B x (K+1) rows through one gate (a
    prefill chunk's write, a speculative round's positions), a switched
    off slot writing nothing; the card's pools equal the CPU's bitwise."""
    rng = np.random.RandomState(3)
    pools = {}
    b, k1 = 3, 5
    pos = np.array([0, 6, 13], np.int64)
    bt = rng.permutation(16)[:b * 4].reshape(b, 4).astype(np.int64)
    ok = rng.rand(b, k1) < 0.6
    ok[1] = False
    vals = rng.randn(b * k1, 2, 32).astype(np.float32)
    for dev in ("cpu", cuda_device):
        pages = torch.full((1, 2, 16, 8, 32), 7.0, device=dev)
        pos2 = torch.from_numpy(pos).to(dev)[:, None] + torch.arange(
            k1, device=dev)
        page = torch.from_numpy(bt).to(dev).gather(1, pos2 // 8)
        gate = KV.write_gate((page.reshape(-1), (pos2 % 8).reshape(-1)),
                             torch.from_numpy(ok).to(dev).reshape(-1))
        KV.write_rows(pages, 0, torch.from_numpy(vals).to(dev), gate)
        pools[str(dev)] = pages.cpu()
    assert torch.equal(pools["cpu"], pools[str(cuda_device)])
    # the switched-off slot's pages kept their fill value
    assert (pools["cpu"][0][:, torch.from_numpy(bt[1])] == 7.0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("attn_impl", ["gather", "auto"])
def test_verify_pass_matches_iterated_steps_on_the_card(cuda_device,
                                                        attn_impl):
    """One verify pass over 2 x 4 fed positions against 4 iterated
    1-step calls on the same pools (f32): no K1 launch in the pass,
    logits and written k/v within 1e-4, the same greedy tokens."""
    cfg, cc, params, k, v, bt, _ = _op_inputs(cuda_device)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(4)
    k.normal_(generator=gen)
    v.normal_(generator=gen)
    tokens = torch.randint(0, MODEL["vocab_size"], (2, 4), generator=gen,
                           device=cuda_device, dtype=torch.int32)
    pos = torch.tensor([9, 30], dtype=torch.int32, device=cuda_device)
    ok = torch.ones((2, 4), dtype=torch.bool, device=cuda_device)
    before = PA.launches
    kp, vp, out, logits = SP._verify_tokens(
        cfg, cc, params, k.clone(), v.clone(), tokens, pos, ok, bt,
        return_logits=True)
    assert PA.launches == before
    pools, ref = (k.clone(), v.clone()), []
    for j in range(4):
        pools, _, lg = D._step_tokens(cfg, cc, params, pools, tokens[:, j],
                                      pos + j, ok[:, j], bt,
                                      attn_impl=attn_impl,
                                      return_logits=True)
        ref.append(lg)
    ref = torch.stack(ref, dim=1)
    torch.testing.assert_close(logits, ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(kp, pools[0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(vp, pools[1], rtol=1e-4, atol=1e-4)
    assert torch.equal(out, ref.argmax(dim=-1).to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("drafter", ["ngram", "truncated"])
@pytest.mark.parametrize("attn_impl", ["gather", "auto"])
def test_speculative_streams_run_on_the_card(cuda_device, drafter,
                                             attn_impl):
    """Speculative decode on the card: every request completes with its
    full output, every token in the vocab, drafts proposed and the
    accepted ones counted.  Token-for-token equality with the 1-step
    streams holds on the CPU (tests/test_torch_speculative.py); here
    the verify pass rounds at slots x (spec_k + 1) rows, and
    test_verify_pass_matches_iterated_steps_on_the_card holds it."""
    got, eng = _streams(cuda_device, attn_impl=attn_impl, multi_step_n=8,
                        speculative=True, spec_k=4, drafter=drafter)
    want = {r.rid: r.output_len
            for r in ArrivalPlan.from_dict(PLAN).sample()}
    assert {rid: len(t) for rid, t in got.items()} == want
    assert all(0 <= t < MODEL["vocab_size"]
               for toks in got.values() for t in toks)
    spec = eng.decode_loop_block()["spec"]
    assert spec["drafted"] > 0 and 0 <= spec["accepted"] <= spec["drafted"]


@pytest.mark.cuda
def test_sampled_nstep_and_grammar_on_the_card(cuda_device):
    """Seeded sampling on the card: N=8 equals N=1 token for token, and
    grammar-constrained streams validate."""
    kw = dict(temperature=0.8, top_p=0.95, sample_seed=7)
    one, _ = _streams(cuda_device, **kw)
    got, _ = _streams(cuda_device, multi_step_n=8, **kw)
    assert got == one
    g, _ = _streams(cuda_device, multi_step_n=8, temperature=0.8,
                    grammar="json")
    grammar = SMP.compile_grammar("json", MODEL["vocab_size"])
    assert all(SMP.validate_stream(grammar, toks) for toks in g.values())


@pytest.mark.cuda
def test_attn_impl_paths_on_the_card(cuda_device):
    """``auto`` is the kernel launch on a card, ``gather`` the plain
    version within 1e-5 (f32) and no launch."""
    rng = np.random.RandomState(1)
    q = torch.from_numpy(rng.randn(2, 4, 32).astype(np.float32)).to(
        cuda_device)
    k = torch.from_numpy(rng.randn(2, 16, 8, 32).astype(np.float32)).to(
        cuda_device)
    v = torch.from_numpy(rng.randn(2, 16, 8, 32).astype(np.float32)).to(
        cuda_device)
    lengths = torch.tensor([9, 40], dtype=torch.int32, device=cuda_device)
    bt = torch.arange(12, dtype=torch.int32,
                      device=cuda_device).reshape(2, 6)
    before = PA.launches
    auto = KV.paged_attention_decode(q, k, v, lengths, bt)
    gather = KV.paged_attention_decode(q, k, v, lengths, bt,
                                       impl="gather")
    assert PA.launches - before == 1
    torch.testing.assert_close(gather, auto, rtol=1e-5, atol=1e-5)
