"""The SPMD tier's ops against the JAX package's, on the CPU: the
decomposed collective matmuls (``ops/collective_matmul.py``), ring and
Ulysses attention (``ops/sequence_parallel.py``) and the decomposed MoE
all-to-all (``ops/moe_dispatch.py``) on four spawned gloo ranks (groups
of 4 and of 2) against ``shard_map`` on four virtual devices; and, in
this process, ``int8_dot_batched``, the seeded routing's shard
invariance, ``spmd_a2a_elems``, ``SpmdConfig.validate``'s messages, the
overlap line's schema and ``dryrun_multichip``'s world check.

Bars: forward and both gradients of the collective matmuls within 1e-5
of their max-abs (the all-gather matmul) and JAX's own 1e-4 where the
reduce-scatter sums in ring order; attention outputs and gradients
1e-5; the skipped-hop fraction exact; the decomposed MoE loop against
the monolithic all-to-all pair (and JAX's) 1e-5; ``int8_dot_batched``
exact forward and straight-through gradients 1e-6."""
from __future__ import annotations

import os
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_spmd import WORLD, finished, spawn_world

MB, S_LOC, D, K = 2, 4, 16, 12
CM_CASES = [(2, 1), (4, 2)]              # (ranks, chunks)
ATT_CASES = [
    # b, s, hq, hkv, dh, causal
    (2, 64, 4, 4, 16, True),
    (1, 64, 4, 2, 16, True),             # GQA
    (2, 64, 4, 4, 16, False),
]
MASKS = [dict(causal=True, window=20),
         dict(causal=True, seg_avg=24, seg_seed=9),
         dict(causal=False, seg_avg=16, seg_seed=2),
         dict(causal=True, window=24, seg_avg=32, seg_seed=4)]
E, C, DE, H = 4, 8, 16, 32               # MoE loop: experts, slots, d, ff


def _rng(seed):
    return np.random.default_rng(seed)


def cm_inputs(n: int):
    r = _rng(10 + n)
    x = r.standard_normal((MB, n * S_LOC, D)).astype(np.float32)
    w = (r.standard_normal((D, K)) * 0.1).astype(np.float32)
    return x, w


def att_inputs(case):
    b, s, hq, hkv, dh, _ = case
    r = _rng(20 + hkv + b)
    return tuple(r.standard_normal(shape).astype(np.float32) for shape in
                 ((b, s, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh),
                  (b, s, hq, dh)))


def moe_inputs():
    r = _rng(30)
    ein = r.standard_normal((WORLD, E, C, DE)).astype(np.float32)
    ws = [(r.standard_normal(shape) * scale).astype(np.float32)
          for shape, scale in (((E, DE, H), 0.25), ((E, DE, H), 0.25),
                               ((E, H, DE), 0.18))]
    cot = r.standard_normal((WORLD, E, C, DE)).astype(np.float32)
    return ein, ws, cot


def _grads(out, cot, *leaves):
    out.backward(cot)
    return [t.grad.numpy().copy() for t in leaves]


def ops_worker(rank: int, port: int, out_dir: str) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from dlnetbench_tpu_torch.models import moe as MoE
    from dlnetbench_tpu_torch.models import spmd
    from dlnetbench_tpu_torch.ops import attention_mask as am
    from dlnetbench_tpu_torch.ops import collective_matmul as CM
    from dlnetbench_tpu_torch.ops import moe_dispatch as MD
    from dlnetbench_tpu_torch.ops import sequence_parallel as SP
    from dlnetbench_tpu_torch.parallel import collectives as col
    from dlnetbench_tpu_torch.parallel import multihost
    multihost.initialize("cpu")
    t = torch.from_numpy
    pair = spmd.grid_mesh(2, 1, 2, torch.device("cpu")).groups["tp"]
    groups = {2: pair, 4: None}
    res = {}
    for n, chunks in CM_CASES:
        g = groups[n]
        r = dist.get_rank(g)
        x, w = cm_inputs(n)
        xl = t(x[:, r * S_LOC:(r + 1) * S_LOC]).requires_grad_(True)
        wl = t(w).requires_grad_(True)
        out = CM.all_gather_matmul(xl, wl, g, gather_axis=1, chunks=chunks)
        res[("ag", n)] = (out.detach().numpy().copy(),
                          *_grads(out, torch.sin(out.detach()), xl, wl))
        dl = D // n
        al = t(x[..., r * dl:(r + 1) * dl]).requires_grad_(True)
        wl = t(w[r * dl:(r + 1) * dl]).requires_grad_(True)
        out = CM.matmul_reduce_scatter(al, wl, g, scatter_axis=1,
                                       chunks=chunks)
        res[("rs", n)] = (out.detach().numpy().copy(),
                          *_grads(out, torch.sin(out.detach()), al, wl))
    x, _ = cm_inputs(4)
    w1 = (_rng(5).standard_normal((D, 1))).astype(np.float32)
    r = dist.get_rank()
    res[("rs_odd", 4)] = CM.matmul_reduce_scatter(
        t(x[..., r * 4:(r + 1) * 4]), t(w1[r * 4:(r + 1) * 4]),
        None, scatter_axis=1).numpy()
    xl = t(x[:, r * S_LOC:(r + 1) * S_LOC])
    wk = t(cm_inputs(4)[1])
    res["legs"] = {leg: tuple(CM.all_gather_matmul(
        xl, wk, None, gather_axis=1, **{leg: True}).shape)
        for leg in ("fake_comm", "fake_compute")}

    def sharded(a):
        s = a.shape[1] // WORLD
        return t(a[:, r * s:(r + 1) * s].copy()).requires_grad_(True)

    for i, case in enumerate(ATT_CASES):
        q, k, v, cot = att_inputs(case)
        causal = case[-1]
        for name in ("ring", "ulysses"):
            if name == "ulysses" and case[3] % WORLD:
                continue
            ql, kl, vl = sharded(q), sharded(k), sharded(v)
            fn = SP.ring_attention if name == "ring" else \
                SP.ulysses_attention
            kw = {} if name == "ring" else {"impl": "xla"}
            out = fn(ql, kl, vl, None, causal=causal, **kw)
            cl = sharded(cot).detach()
            res[(name, i)] = (out.detach().numpy().copy(),
                              *_grads(out, cl, ql, kl, vl))
    for i, m in enumerate(MASKS):
        case = (2, 64, 4, 4, 16, m["causal"])
        q, k, v, cot = att_inputs(case)
        spec = am.MaskSpec(**m)
        for name in ("ring", "ulysses"):
            ql, kl, vl = sharded(q), sharded(k), sharded(v)
            if name == "ring":
                out = SP.ring_attention(ql, kl, vl, None,
                                        causal=spec.causal, spec=spec)
            else:
                out = SP.ulysses_attention(ql, kl, vl, None,
                                           causal=spec.causal, impl="xla",
                                           spec=spec)
            res[(name, f"mask{i}")] = (out.detach().numpy().copy(),
                                       *_grads(out, sharded(cot).detach(),
                                               ql, kl, vl))

    ein, ws, cot = moe_inputs()
    for n in (2, 4):
        g = groups[n]
        gr = dist.get_rank(g)
        eloc = E // n
        loc = [w[gr * eloc:(gr + 1) * eloc] for w in ws]
        for mode in ("monolithic", 1, 2):
            xe = t(ein[r]).requires_grad_(True)
            wl = [t(w).requires_grad_(True) for w in loc]
            if mode == "monolithic":
                a = col.all_to_all(xe, g, split=0, concat=1)
                y = MoE.expert_ffn(a, *wl)
                out = col.all_to_all(y, g, split=1, concat=0)
            else:
                out = MD.a2a_expert_ffn(xe, *wl, g, chunks=mode)
            res[("moe", n, mode)] = (out.detach().numpy().copy(),
                                     *_grads(out, t(cot[r]), xe, *wl))
    gathered = multihost.all_ranks(res)
    if rank == 0:
        with open(Path(out_dir) / "rank0.pkl", "wb") as f:
            pickle.dump(gathered, f)
    finished(rank, out_dir)
    multihost.shutdown()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_world(tmp_path_factory.mktemp("spmd_ops"), ops_worker, ())


def _close(a, b, tol, what):
    scale = max(float(np.abs(b).max()), 1e-30)
    err = float(np.abs(np.asarray(a) - np.asarray(b)).max())
    assert err <= tol * scale, f"{what}: {err:.3e} of {scale:.3e} (bar {tol})"


def _jax_mesh(n):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:n]).reshape(n), ("r",))


# ------------------------------------------------- collective matmuls
@pytest.mark.parametrize("n,chunks", CM_CASES)
def test_all_gather_matmul_equals_jax(ranks, eight_devices, n, chunks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from dlnetbench_tpu.ops import collective_matmul as JCM
    from dlnetbench_tpu.utils.jax_compat import shard_map
    x, w = cm_inputs(n)
    sm = shard_map(lambda a, b: JCM.all_gather_matmul(
        a, b, "r", gather_axis=1, chunks=chunks), mesh=_jax_mesh(n),
        in_specs=(P(None, "r", None), P()), out_specs=P(), check_vma=False)
    out, vjp = jax.vjp(sm, jnp.asarray(x), jnp.asarray(w))
    dx, dw = (np.asarray(g) for g in vjp(jnp.sin(out)))
    for r in range(n):
        o, gx, gw = ranks[r][("ag", n)]
        _close(o, np.asarray(out), 1e-5, f"out r{r}")
        # every rank seeded the full cotangent of its (replicated) copy:
        # its x gradient is n copies' worth, its w gradient one copy's
        _close(gx / n, dx[:, r * S_LOC:(r + 1) * S_LOC], 1e-5, f"dx r{r}")
        _close(gw, dw, 1e-5, f"dw r{r}")


@pytest.mark.parametrize("n,chunks", CM_CASES)
def test_matmul_reduce_scatter_equals_jax(ranks, eight_devices, n, chunks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from dlnetbench_tpu.ops import collective_matmul as JCM
    from dlnetbench_tpu.utils.jax_compat import shard_map
    x, w = cm_inputs(n)
    sm = shard_map(lambda a, b: JCM.matmul_reduce_scatter(
        a, b, "r", scatter_axis=1, chunks=chunks), mesh=_jax_mesh(n),
        in_specs=(P(None, None, "r"), P("r", None)),
        out_specs=P(None, "r", None), check_vma=False)
    out, vjp = jax.vjp(sm, jnp.asarray(x), jnp.asarray(w))
    da, dw = (np.asarray(g) for g in vjp(jnp.sin(out)))
    out = np.asarray(out)
    dl = D // n
    for r in range(n):
        o, ga, gw = ranks[r][("rs", n)]
        _close(o, out[:, r * S_LOC:(r + 1) * S_LOC], 1e-4, f"out r{r}")
        _close(ga, da[..., r * dl:(r + 1) * dl], 1e-5, f"da r{r}")
        _close(gw, dw[r * dl:(r + 1) * dl], 1e-4, f"dw r{r}")


def test_odd_width_one_direction_fallback(ranks, eight_devices):
    import jax.numpy as jnp
    x, _ = cm_inputs(4)
    w1 = (_rng(5).standard_normal((D, 1))).astype(np.float32)
    want = np.asarray(jnp.dot(jnp.asarray(x), jnp.asarray(w1)))
    for r in range(WORLD):
        _close(ranks[r][("rs_odd", 4)], want[:, r * S_LOC:(r + 1) * S_LOC],
               1e-5, f"rank {r}")
    assert ranks[0]["legs"] == {"fake_comm": (MB, 4 * S_LOC, K),
                                "fake_compute": (MB, 4 * S_LOC, K)}


# ------------------------------------------------ sequence parallel
def _jax_attention(name, q, k, v, cot, causal, spec=None):
    """JAX's ring / Ulysses on four devices: the output and the
    gradients of sum(out * cot) over the global q, k, v."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from dlnetbench_tpu.ops import sequence_parallel as JSP
    from dlnetbench_tpu.utils.jax_compat import shard_map
    spec_p = P(None, "r", None, None)
    if name == "ring":
        def f(q_, k_, v_):
            return JSP.ring_attention(q_, k_, v_, "r", causal=causal,
                                      spec=spec)
    else:
        def f(q_, k_, v_):
            return JSP.ulysses_attention(q_, k_, v_, "r", causal=causal,
                                         impl="xla", spec=spec)
    mesh = _jax_mesh(WORLD)

    def loss_local(q_, k_, v_, c_):
        out = f(q_, k_, v_)
        return lax.psum(jnp.sum(out * c_), "r"), out

    loss = shard_map(loss_local, mesh=mesh, in_specs=(spec_p,) * 4,
                     out_specs=(P(), spec_p), check_vma=False)
    grad_fn = jax.jit(jax.grad(loss, argnums=(0, 1, 2), has_aux=True))
    args = [jnp.asarray(a) for a in (q, k, v, cot)]
    grads, out = grad_fn(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _check_attention(ranks, key, want_out, want_grads):
    s = want_out.shape[1] // WORLD
    for r in range(WORLD):
        out, *grads = ranks[r][key]
        sl = slice(r * s, (r + 1) * s)
        _close(out, want_out[:, sl], 1e-5, f"{key} out r{r}")
        for g, w, nm in zip(grads, want_grads, "qkv"):
            _close(g, w[:, sl], 1e-5, f"{key} d{nm} r{r}")


@pytest.mark.parametrize("name,i", [
    (name, i) for i, case in enumerate(ATT_CASES)
    for name in ("ring", "ulysses")
    # Ulysses shards the KV heads: the GQA case's 2 do not split over 4
    if name == "ring" or case[3] % WORLD == 0])
def test_sequence_parallel_equals_jax(ranks, eight_devices, name, i):
    case = ATT_CASES[i]
    q, k, v, cot = att_inputs(case)
    out, grads = _jax_attention(name, q, k, v, cot, case[-1])
    _check_attention(ranks, (name, i), out, grads)


@pytest.mark.parametrize("name", ["ring", "ulysses"])
@pytest.mark.parametrize("i", range(len(MASKS)))
def test_masked_sequence_parallel_equals_jax(ranks, eight_devices, name, i):
    from dlnetbench_tpu.ops import attention_mask as JAM
    from dlnetbench_tpu_torch.ops import attention_mask as am
    m = MASKS[i]
    q, k, v, cot = att_inputs((2, 64, 4, 4, 16, m["causal"]))
    out, grads = _jax_attention(name, q, k, v, cot, m["causal"],
                                JAM.MaskSpec(**m))
    _check_attention(ranks, (name, f"mask{i}"), out, grads)
    # the skipped-hop accounting, exactly JAX's
    assert am.ring_skipped_hop_fraction(am.MaskSpec(**m), 64, WORLD) == \
        JAM.ring_skipped_hop_fraction(JAM.MaskSpec(**m), 64, WORLD)


# ------------------------------------------------ decomposed MoE loop
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("chunks", [1, 2])
def test_a2a_expert_ffn_equals_monolithic(ranks, n, chunks):
    for r in range(WORLD):
        mono = ranks[r][("moe", n, "monolithic")]
        dec = ranks[r][("moe", n, chunks)]
        for a, b, what in zip(dec, mono, ("out", "dein", "dwg", "dwu",
                                           "dwd")):
            _close(a, b, 1e-5, f"n={n} chunks={chunks} r{r} {what}")


def test_a2a_expert_ffn_equals_jax(ranks, eight_devices):
    """The port's monolithic pair (which the decomposed loop equals)
    against JAX's decomposed loop on four devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from dlnetbench_tpu.ops import moe_dispatch as JMD
    from dlnetbench_tpu.utils.jax_compat import shard_map
    ein, ws, cot = moe_inputs()
    sp = P("r", None, None, None)
    spw = P("r", None, None)

    def body(x, a, b, c):
        return JMD.a2a_expert_ffn(x[0], a, b, c, "r")[None]

    sm = shard_map(body, mesh=_jax_mesh(WORLD),
                   in_specs=(sp, spw, spw, spw), out_specs=sp,
                   check_vma=False)
    args = [jnp.asarray(ein)] + [jnp.asarray(w) for w in ws]
    out, vjp = jax.vjp(sm, *args)
    grads = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    out = np.asarray(out)
    for r in range(WORLD):
        o, gx, *gw = ranks[r][("moe", 4, 2)]
        _close(o, out[r], 1e-5, f"out r{r}")
        _close(gx, grads[0][r], 1e-5, f"dein r{r}")
        for g, w, nm in zip(gw, grads[1:], ("dwg", "dwu", "dwd")):
            _close(g, w[r:r + 1], 1e-5, f"{nm} r{r}")


# ------------------------------------------------------ in process
def test_int8_dot_batched_equals_jax():
    import jax
    import jax.numpy as jnp

    from dlnetbench_tpu.ops import int8 as J8
    from dlnetbench_tpu_torch.ops import int8 as T8
    r = _rng(40)
    x = r.standard_normal((3, 10, 24)).astype(np.float32)
    w = (r.standard_normal((3, 24, 20)) * 0.2).astype(np.float32)
    dy = r.standard_normal((3, 10, 20)).astype(np.float32)
    want, vjp = jax.vjp(J8.int8_dot_batched, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = (np.asarray(g) for g in vjp(jnp.asarray(dy)))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    got = T8.int8_dot_batched(tx, tw)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    got.backward(torch.from_numpy(dy))
    _close(tx.grad.numpy(), jdx, 1e-6, "dx")
    _close(tw.grad.numpy(), jdw, 1e-6, "dw")


def test_expert_ffn_mlp_int8_equals_jax():
    import jax.numpy as jnp

    from dlnetbench_tpu.models import moe as JM
    from dlnetbench_tpu_torch.models import moe as TM
    ein, ws, _ = moe_inputs()
    want = JM.expert_ffn(jnp.asarray(ein[0]), *map(jnp.asarray, ws),
                         mlp_int8=True)
    got = TM.expert_ffn(torch.from_numpy(ein[0]),
                        *map(torch.from_numpy, ws), mlp_int8=True)
    _close(got.numpy(), np.asarray(want), 1e-5, "int8 expert FFN")


def test_seeded_routing_shard_invariant_and_equal_jax():
    """The dryrun's routing bar: one global token block routed whole and
    in per-shard slices (global token ids) keeps the same tokens, and
    every dispatch one-hot equals JAX's."""
    import jax.numpy as jnp

    from dlnetbench_tpu.models import moe as JM
    from dlnetbench_tpu_torch.models import moe as TM
    t, d, e, k, g = 64, 32, 4, 2, 16
    r = _rng(50)
    x = r.standard_normal((t, d)).astype(np.float32)
    wr = r.standard_normal((d, e)).astype(np.float32)

    def port(lo, hi):
        return TM.dispatch(torch.from_numpy(x[lo:hi]), torch.from_numpy(wr),
                           e, k, 1.0, drop_seed=11, group_tokens=g,
                           gids=torch.arange(lo, hi))[1].numpy()

    def jax_(lo, hi):
        return np.asarray(JM.dispatch(jnp.asarray(x[lo:hi]),
                                      jnp.asarray(wr), e, k, 1.0,
                                      drop_seed=11, group_tokens=g,
                                      gids=jnp.arange(lo, hi))[1])

    full = port(0, t)
    np.testing.assert_array_equal(full, jax_(0, t))
    h = t // 4
    ch = full.shape[2] // 4
    for s in range(4):
        part = port(s * h, (s + 1) * h)
        np.testing.assert_array_equal(part, jax_(s * h, (s + 1) * h))
        np.testing.assert_array_equal(
            full[s * h:(s + 1) * h, :, s * ch:(s + 1) * ch], part)


@pytest.mark.parametrize("kw,mesh", [
    (dict(), (1, 2, 2)),
    (dict(capacity_factor=1.0), (2, 1, 2)),
    (dict(capacity_factor=1.0, moe_group_tokens=8), (1, 2, 2)),
    (dict(batch=16, num_microbatches=4, top_k=1), (2, 2, 2)),
])
def test_spmd_a2a_elems_equal_jax(kw, mesh):
    from dlnetbench_tpu.models import moe as JM
    from dlnetbench_tpu.models import spmd as JS
    from dlnetbench_tpu_torch.models import moe as TM
    from dlnetbench_tpu_torch.models import spmd as TS
    dp, _, tp = mesh
    assert TM.spmd_a2a_elems(TS.SpmdConfig(**kw), dp, tp) == \
        JM.spmd_a2a_elems(JS.SpmdConfig(**kw), dp, tp)


VALIDATE_CASES = [
    (dict(num_layers=3), (2, 2, 2)),
    (dict(sp_mode="lattice"), (1, 1, 1)),
    (dict(tp_overlap="magic"), (2, 2, 2)),
    (dict(grad_sync="eager"), (2, 2, 2)),
    (dict(tp_overlap_chunks=0), (2, 2, 2)),
    (dict(grad_bucket_layers=0), (1, 1, 1)),
    (dict(attention_window=-1), (2, 2, 2)),
    (dict(attention_seg_avg=-2), (1, 1, 1)),
    (dict(moe_a2a="ring"), (1, 1, 1)),
    (dict(moe_chunks=0), (1, 1, 1)),
    (dict(moe_group_tokens=-1), (1, 1, 1)),
    (dict(moe_group_tokens=5), (1, 1, 2)),
    (dict(moe_ffn_impl="ragged"), (1, 1, 1)),
    (dict(moe_ffn_quant="int4"), (1, 1, 1)),
    (dict(moe_ffn_quant="int8"), (1, 1, 1)),
    (dict(mlp_int8=True, moe_ffn_impl="grouped"), (1, 1, 1)),
    (dict(batch=6), (2, 1, 1)),
    (dict(seq_len=30), (1, 1, 4)),
    (dict(num_heads=6, num_kv_heads=6, embed_dim=48), (1, 1, 4)),
    (dict(num_kv_heads=2), (1, 1, 4)),
    (dict(num_experts=6), (1, 1, 4)),
    (dict(vocab_size=126), (1, 1, 4)),
]


@pytest.mark.parametrize("kw,mesh", VALIDATE_CASES)
def test_validate_messages_equal_jax(kw, mesh):
    from dlnetbench_tpu.models import spmd as JS
    from dlnetbench_tpu_torch.models import spmd as TS
    msgs = []
    for mod in (JS, TS):
        with pytest.raises(ValueError) as exc:
            mod.SpmdConfig(**kw).validate(*mesh)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_ring_indivisible_heads_validates_like_jax():
    """Ring keeps every head local: heads need not divide tp."""
    from dlnetbench_tpu.models import spmd as JS
    from dlnetbench_tpu_torch.models import spmd as TS
    kw = dict(sp_mode="ring", num_heads=6, num_kv_heads=6, embed_dim=48)
    JS.SpmdConfig(**kw).validate(2, 2, 2)
    TS.SpmdConfig(**kw).validate(2, 2, 2)
    assert TS.SpmdConfig().ring_hop_stats(4) == \
        JS.SpmdConfig().ring_hop_stats(4)
    kw = dict(attention_window=8, sp_mode="ring")
    assert TS.SpmdConfig(**kw).ring_hop_stats(4) == \
        JS.SpmdConfig(**kw).ring_hop_stats(4)


def test_assemble_line_equals_jax():
    """The paired overlap line's schema (the JAX package's
    tests/test_bench_aux.py) and values."""
    from dlnetbench_tpu.models import overlap_bench as JO
    from dlnetbench_tpu_torch.models import overlap_bench as TO
    walls = {"baseline": [0.2, 0.22, 0.21],
             "overlapped": [0.1, 0.12, 0.11]}
    overlaps = {"baseline": [0.05, 0.0, 0.1],
                "overlapped": [0.8, 0.7, 0.9]}
    got = TO.assemble_line("spmd overlap A/B (test)", walls, overlaps)
    want = JO.assemble_line("spmd overlap A/B (test)", walls, overlaps)
    assert got == want
    assert set(got) >= {"metric", "value", "unit", "best", "band", "n",
                        "baseline", "overlapped",
                        "ratio_overlapped_vs_baseline", "overlap_fraction"}
    # a bimodal line carries the low-mode note in both (its wording is a
    # known difference: "host throughput states" for "tunnel/host")
    walls = {"baseline": [0.2, 0.2, 0.2], "overlapped": [0.05, 0.2, 0.2]}
    low = TO.assemble_line("x", walls, overlaps)
    jlow = JO.assemble_line("x", walls, overlaps)
    assert "note" in low and "note" in jlow
    low.pop("note"), jlow.pop("note")
    assert low == jlow


def test_factor_mesh_equals_jax():
    from dlnetbench_tpu.models import spmd as JS
    from dlnetbench_tpu_torch.models import spmd as TS
    for n in (1, 2, 3, 4, 6, 8, 12, 16):
        assert TS.factor_mesh(n) == JS.factor_mesh(n)


def test_dryrun_refuses_a_world_that_is_not_n():
    from dlnetbench_tpu_torch import entry
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4"):
        entry.dryrun_multichip(4, platform="cpu")


def test_dryrun_world_one_runs_and_lists_deadline_skips(monkeypatch):
    """At world 1 on the CPU every stage that one rank can run runs (9
    train steps, the three MoE stages) and none is listed as skipped;
    past its deadline a stage is listed in ``skipped`` and not run."""
    from dlnetbench_tpu_torch import entry
    monkeypatch.delenv("DLNB_DRYRUN_DEADLINE_S", raising=False)
    out = entry.dryrun_multichip(1, platform="cpu", shape="jax",
                                 log=lambda *_: None)
    assert out["skipped"] == [] and out["steps"] == 9
    assert list(out["moe"]) == ["moe_a2a=decomposed",
                                "moe_ffn_impl=grouped",
                                "moe_a2a=decomposed+grouped"]
    monkeypatch.setenv("DLNB_DRYRUN_DEADLINE_S", "-1")
    out = entry.dryrun_multichip(1, platform="cpu", shape="jax",
                                 log=lambda *_: None)
    assert "sp_mode=ring" in out["skipped"] and out["moe"] == {}
    assert out["steps"] == 1 and set(out["loss"]) == {"megatron"}


def test_param_specs_equal_jax():
    from dlnetbench_tpu.models import spmd as JS
    from dlnetbench_tpu_torch.models import spmd as TS
    for mode in ("megatron", "ring", "ulysses"):
        j, t = JS.param_specs(mode), TS.param_specs(mode)
        for key in ("embed", "final_norm", "head"):
            assert tuple(j[key]) == t[key]
        for key in TS.LAYER_KEYS:
            assert tuple(j["layers"][key]) == t["layers"][key]


@pytest.mark.parametrize("kw", [
    dict(num_layers=2, capacity_factor=8.0),
    dict(num_layers=2, capacity_factor=1.0, moe_drop_seed=11,
         moe_group_tokens=8, moe_ffn_impl="grouped"),
    dict(num_layers=2, sp_mode="ulysses", mlp_int8=True,
         grad_sync="bucketed"),
], ids=["megatron", "grouped+finite", "ulysses+mlp_int8+bucketed"])
def test_world1_step_equals_jax(eight_devices, kw):
    """Mesh (1, 1, 1): the tp = 1 branches (local attention, the plain
    loss over the whole vocabulary) against JAX's step on one device,
    under a one-rank gloo group in this process — the bars of
    ``tests/test_torch_spmd.py``."""
    import jax
    import jax.numpy as jnp

    from dlnetbench_tpu.models import spmd as J
    from dlnetbench_tpu.parallel.mesh import make_grid_mesh
    from dlnetbench_tpu_torch.models import spmd
    from dlnetbench_tpu_torch.parallel import multihost
    from test_torch_spmd import check_step, numpy_params, numpy_tokens
    jmesh = make_grid_mesh(dp=1, pp=1, tp=1, devices=jax.devices()[:1])
    jnew, jloss = J.make_train_step(jmesh, J.SpmdConfig(**kw))(
        jax.tree.map(jnp.asarray, numpy_params(kw)),
        jnp.asarray(numpy_tokens(kw)))
    want = (float(jloss), jax.tree.map(np.asarray, jnew))
    import torch.distributed as dist
    owned = not dist.is_initialized()
    device = multihost.initialize("cpu")
    try:
        mesh = spmd.grid_mesh(1, 1, 1, device)
        cfg = spmd.SpmdConfig(**kw)
        new, loss = spmd.make_train_step(mesh, cfg)(
            spmd.params_from_numpy(numpy_params(kw), mesh, cfg),
            torch.from_numpy(numpy_tokens(kw)).long())
        got = (float(loss), spmd.gather_params(new, mesh, cfg))
    finally:
        if owned:
            multihost.shutdown()
    check_step(str(kw), kw, got, want)
