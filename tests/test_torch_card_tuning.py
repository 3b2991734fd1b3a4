"""The tuner's knobs on the card: K11 and K12 under each cluster size and
K1/K2 under each split held against their plain PyTorch versions; the
default config bit-identical to the untuned launch (cluster 0: the
process-wide preference; no split: the kernel's ``split_pages``); a
config the kernel cannot take refused; a card record answering a consult
on the card.

This file imports neither jax nor the JAX package, so it runs on the
card machine: ``python -m pytest --noconftest -m cuda
tests/test_torch_card*.py`` (``chip_smoke.py`` runs it so).  Every case
takes the ``cuda_device`` fixture, which skips where no card is
visible; the tuner itself is held against the JAX package's in
tests/test_torch_tuning.py."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from dlnetbench_tpu_torch import tuning
from dlnetbench_tpu_torch.ops import grouped_matmul as GM
from dlnetbench_tpu_torch.ops import paged_attention as PA
from dlnetbench_tpu_torch.ops import paged_attention_quant as PAQ
from dlnetbench_tpu_torch.ops import quantized_matmul as Q

FMTS = ["int8", "float8"]
CLUSTERS = list(Q.CLUSTERS)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels run only "
                    "there (the tuner is tested against JAX in "
                    "tests/test_torch_tuning.py)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _untuned(monkeypatch):
    monkeypatch.delenv(tuning.ENV_DB_DIR, raising=False)
    tuning.reset()
    yield
    tuning.reset()


def arr(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def check(fmt, y, ref):
    """int8 bit-exact; e4m3 each row within 2^-6 of its max-abs and 1e-2
    relative Frobenius (K11's and K12's bars)."""
    if fmt == "int8":
        assert torch.equal(y, ref)
        return
    yf, rf = y.float(), ref.float()
    err = (yf - rf).abs().amax(dim=-1)
    assert (err <= 2.0 ** -6 * rf.abs().amax(dim=-1)).all()
    g, w = yf.double(), rf.double()
    assert float((g - w).norm() / w.norm().clamp_min(1e-9)) <= 1e-2


def k11_operands(dev, fmt, n=1024):
    x = torch.from_numpy(arr(31, (256, 192))).to(dev, torch.bfloat16)
    w = torch.from_numpy(arr(32, (192, n), 0.1)).to(dev, torch.bfloat16)
    wq, sw = Q.quantize_tensor(w, fmt)
    return x, wq, sw, Q.scale_from_amax(Q.amax_of(x), fmt)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("cluster", CLUSTERS)
def test_k11_under_each_cluster_matches_plain(cuda_device, fmt, cluster):
    x, wq, sw, sx = k11_operands(cuda_device, fmt)
    before = Q.fused_launches
    y = Q.fused_matmul(x, wq, sw, sx, fmt=fmt, cluster=cluster)
    torch.cuda.synchronize()
    assert Q.fused_launches == before + 1
    check(fmt, y, Q.plain_fused_matmul(x, wq, sw, sx, fmt, False)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 768])
def test_k11_default_is_the_untuned_launch(cuda_device, n):
    """The tuner's default config (``default_cluster``: 4 at N/256 = 4,
    1 at N/256 = 3) is bit-identical to the untuned launch (cluster 0,
    the preference of ``set_cluster``), which ``fused_matmul`` makes with
    the tuner off."""
    for fmt in FMTS:
        x, wq, sw, sx = k11_operands(cuda_device, fmt, n)
        w_t = Q.k_major(wq)
        untuned = Q.kernel_fused_matmul(x, w_t, sw, sx, fmt, False, 0)[0]
        named = Q.kernel_fused_matmul(x, w_t, sw, sx, fmt, False,
                                      Q.default_cluster(n))[0]
        site = Q.fused_matmul(x, wq, sw, sx, fmt=fmt)
        assert torch.equal(untuned, named) and torch.equal(untuned, site)
    assert tuning.provenance() is None


def k12_operands(dev, fmt, n=1024):
    x = torch.from_numpy(arr(33, (3, 200, 192))).to(dev, torch.bfloat16)
    w = torch.from_numpy(arr(34, (3, 192, n), 0.1)).to(dev, torch.bfloat16)
    counts = torch.tensor([200, 71, 0], dtype=torch.int32, device=dev)
    if fmt is None:
        return x, w, counts, {}
    wq, sw = GM.quantize_experts(w, fmt)
    sx = Q.scale_from_amax(GM.expert_amax(x), fmt)
    return x, wq, counts, {"fmt": fmt, "sx": sx, "sw": sw}


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("cluster", CLUSTERS)
def test_k12_under_each_cluster_matches_plain(cuda_device, fmt, cluster):
    x, w, counts, kw = k12_operands(cuda_device, fmt)
    before = GM.grouped_launches
    y = GM.grouped_matmul(x, w, counts=counts, cluster=cluster, **kw)
    torch.cuda.synchronize()
    assert GM.grouped_launches == before + 1
    ref = GM.plain_grouped_matmul(x, w, counts, kw["sx"], kw["sw"], fmt)
    assert not y[2].any() and not y[1, 71:].any()
    check(fmt, y[:2], ref[:2])


@pytest.mark.cuda
def test_k12_master_dtype_has_one_config(cuda_device):
    """bf16 K12 has no cluster knob: its one config (1) is the untuned
    launch bit for bit, and another is refused before a launch."""
    x, w, counts, _ = k12_operands(cuda_device, None)
    one = GM.grouped_matmul(x, w, counts=counts, cluster=1)
    assert torch.equal(one, GM.grouped_matmul(x, w, counts=counts))
    with pytest.raises(ValueError, match="one config cluster=1"):
        GM.grouped_matmul(x, w, counts=counts, cluster=2)


def decode_operands(dev, pages: str, pmax: int = 6):
    """Served-shape-like decode operands: 4 slots, GQA group 4, Dh 128,
    page 16, ``pmax`` pages a slot, lengths ragged."""
    rng = np.random.default_rng(35)
    b, hq, hkv, dh, psize = 4, 16, 4, 128, 16
    npages = b * pmax + 2
    q = torch.from_numpy((rng.standard_normal((b, hq, dh)) * dh ** -0.5)
                         .astype(np.float32)).to(dev, torch.bfloat16)
    kp = rng.standard_normal((hkv, npages, psize, dh)).astype(np.float32)
    vp = rng.standard_normal((hkv, npages, psize, dh)).astype(np.float32)
    bt = torch.from_numpy(rng.permutation(npages)[:b * pmax].reshape(
        b, pmax).astype(np.int32)).to(dev)
    ln = torch.tensor([1, 17, 64, pmax * psize], dtype=torch.int32,
                      device=dev)
    if pages == "bf16":
        return q, [torch.from_numpy(a).to(dev, torch.bfloat16)
                   for a in (kp, vp)], None, ln, bt
    out = []
    for p in (kp, vp):
        t = torch.from_numpy(p).to(dev)
        qp, s = Q.quantize_tensor(t, "int8" if pages == "int8" else
                                  "float8")
        out.append((qp, s.expand(hkv, npages).contiguous()))
    return q, [out[0][0], out[1][0]], [out[0][1], out[1][1]], ln, bt


def run_decode(q, pools, scales, ln, bt, pages, split):
    if scales is None:
        return (PA.paged_attention(q, *pools, ln, bt, split=split),
                PA.gather_attention(q, *pools, ln, bt))
    fmt = "int8" if pages == "int8" else "float8"
    return (PAQ.quant_paged_attention(q, *pools, *scales, ln, bt, fmt=fmt,
                                      split=split),
            PAQ.dequant_gather_attention(q, *pools, *scales, ln, bt))


@pytest.mark.cuda
@pytest.mark.parametrize("pages,split", [("bf16", 1), ("bf16", 2),
                                         ("bf16", 3), ("bf16", 6),
                                         ("int8", 1), ("int8", 4),
                                         ("fp8", 2), ("fp8", 5)])
def test_k1_k2_under_each_split_match_plain(cuda_device, pages, split):
    """K1/K2 with a tuned pages a split (a divisor of the 6 pages a slot,
    or a ragged last split) against their plain versions at K1's bf16
    bar, 2e-2."""
    q, pools, scales, ln, bt = decode_operands(cuda_device, pages)
    got, ref = run_decode(q, pools, scales, ln, bt, pages, split)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
def test_k1_default_split_is_the_untuned_launch(cuda_device):
    """No split (the untuned launch) and the tuner's default
    (``split_pages``) are the same launch, bit for bit."""
    for pages in ("bf16", "int8"):
        q, pools, scales, ln, bt = decode_operands(cuda_device, pages, 10)
        untuned, _ = run_decode(q, pools, scales, ln, bt, pages, None)
        named, _ = run_decode(q, pools, scales, ln, bt, pages,
                              PA.split_pages(16, 10))
        assert torch.equal(untuned, named)


@pytest.mark.cuda
def test_configs_the_kernels_cannot_take_raise(cuda_device):
    """No fall back: a cluster that does not divide N / 256 and a split
    outside 1..pmax raise before a launch."""
    x, wq, sw, sx = k11_operands(cuda_device, "int8", n=512)
    with pytest.raises(ValueError, match="dividing N/256"):
        Q.fused_matmul(x, wq, sw, sx, fmt="int8", cluster=4)
    q, pools, _, ln, bt = decode_operands(cuda_device, "bf16")
    for split in (0, 7):
        with pytest.raises(ValueError, match="pages a split"):
            PA.paged_attention(q, *pools, ln, bt, split=split)


@pytest.mark.cuda
def test_a_card_record_answers_the_card_site(cuda_device, monkeypatch,
                                             tmp_path):
    """With the tuner on, K11's site consults under the card's chip key:
    a record for this card is a hit (its cluster launched, the result
    the plain version's), a CPU record for the same key is not."""
    x, wq, sw, sx = k11_operands(cuda_device, "int8")
    key = tuning.params.quantized_matmul_key(256, 192, 1024, "int8",
                                             x.dtype)
    hw = tuning.hw_key(cuda_device)
    assert hw != "cpu"
    db = tuning.TuningDB(tmp_path)
    db.put("quantized_matmul", key, "cpu", {"cluster": 4})
    db.put("quantized_matmul", key, hw, {"cluster": 2})
    monkeypatch.setenv(tuning.ENV_DB_DIR, str(tmp_path))
    tuning.reset()
    y = Q.fused_matmul(x, wq, sw, sx, fmt="int8")
    site = tuning.provenance()["sites"][f"quantized_matmul|{key}"]
    assert site["hit"] and site["config"] == {"cluster": 2}
    check("int8", y, Q.plain_fused_matmul(x, wq, sw, sx, "int8", False)[0])
