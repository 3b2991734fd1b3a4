"""Per-model stat files — the interop surface between the stats
generator and the proxy workloads (the port's copy of the JAX package's
``core/model_stats.py``).

Format: flat ``key:value`` text, one stat per line, the keys of the
reference's committed ``model_stats/*.txt`` files.  Parsed by key,
case-insensitively, with presence validated, so the reference's files
whose lines drifted (lowercase ``Non_Expert_size``) load too;
``to_text`` writes the reference's line order byte for byte.  The
default directory is the port's own ``data/model_stats/``, whose files
``python -m dlnetbench_tpu_torch.stats_gen --all`` writes for the H100.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

_STATS_DIR = Path(__file__).resolve().parent.parent / "data" / "model_stats"

# canonical key -> attribute
_KEYMAP = {
    "forward_flops": "forward_flops",
    "backward_flops": "backward_flops",
    "model_size": "model_size",
    "non_expert_size": "non_expert_size",
    "average_forward_time (us)": "fwd_us",
    "average_backward_time (us)": "bwd_us",
    "batch_size": "batch_size",
    "ffn_average_forward_time (us)": "ffn_fwd_us",
    "ffn_average_backward_time (us)": "ffn_bwd_us",
    "experts": "experts",
    "seq_len": "seq_len",
    "embedded_dim": "embed_dim",
    "device": "device",
    "dtype": "dtype",
    "bytes_per_element": "bytes_per_element",
    # backward-aware step roofline (r4, core/roofline.py
    # train_step_time_s): absent from reference-era files, parsed as 0
    "train_step_time (us)": "step_us",
}

_REQUIRED = {"forward_flops", "backward_flops", "model_size", "fwd_us",
             "bwd_us", "batch_size", "seq_len", "embed_dim", "dtype"}


@dataclasses.dataclass(frozen=True)
class ModelStats:
    name: str                 # e.g. "llama3_8b_16_bfloat16"
    forward_flops: int
    backward_flops: int
    model_size: int           # parameter count
    fwd_us: float
    bwd_us: float
    batch_size: int
    seq_len: int
    embed_dim: int
    dtype: str
    non_expert_size: int = 0
    ffn_fwd_us: float = 0.0
    ffn_bwd_us: float = 0.0
    experts: int = 1
    device: str = "unknown"
    bytes_per_element: float = 2.0
    # backward-aware step roofline (weights x3 + saved-residual round
    # trip, core/roofline.py train_step_bytes); 0 in files predating r4
    step_us: float = 0.0

    @property
    def model_bytes(self) -> int:
        """Gradient/weight message sizing uses parameter count x element
        size (the reference sizes collective buffers in elements of
        ``_FLOAT``, reference cpp/data_parallel/dp.cpp:159-164)."""
        return int(self.model_size * self.bytes_per_element)

    def to_text(self) -> str:
        lines = [
            f"Forward_Flops:{self.forward_flops}",
            f"Backward_Flops:{self.backward_flops}",
            f"Model_Size:{self.model_size}",
            f"Non_Expert_size:{self.non_expert_size}",
            f"Average_Forward_Time (us):{self.fwd_us:.2f}",
            f"Average_Backward_Time (us):{self.bwd_us:.2f}",
            f"Batch_size:{self.batch_size}",
            f"FFN_Average_Forward_Time (us):{self.ffn_fwd_us:.2f}",
            f"FFN_Average_Backward_Time (us):{self.ffn_bwd_us:.2f}",
            f"Experts:{self.experts}",
            f"Seq_len:{self.seq_len}",
            f"Embedded_dim:{self.embed_dim}",
            f"Device:{self.device}",
            f"Dtype:{self.dtype}",
            f"Bytes_per_element:{self.bytes_per_element}",
        ]
        if self.step_us:
            lines.append(f"Train_Step_Time (us):{self.step_us:.2f}")
        return "\n".join(lines) + "\n"


def parse_stats_text(name: str, text: str) -> ModelStats:
    found: dict[str, str] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if ":" not in line:
            raise ValueError(f"{name}:{lineno}: malformed stat line {line!r}")
        key, _, value = line.partition(":")
        attr = _KEYMAP.get(key.strip().lower())
        if attr is not None:
            found[attr] = value.strip()

    missing = _REQUIRED - found.keys()
    if missing:
        raise ValueError(f"{name}: missing required stat keys: {sorted(missing)}")

    def _i(k, default=0):
        return int(float(found[k])) if k in found else default

    def _f(k, default=0.0):
        return float(found[k]) if k in found else default

    return ModelStats(
        name=name,
        forward_flops=_i("forward_flops"),
        backward_flops=_i("backward_flops"),
        model_size=_i("model_size"),
        non_expert_size=_i("non_expert_size"),
        fwd_us=_f("fwd_us"),
        bwd_us=_f("bwd_us"),
        batch_size=_i("batch_size"),
        ffn_fwd_us=_f("ffn_fwd_us"),
        ffn_bwd_us=_f("ffn_bwd_us"),
        experts=_i("experts", 1),
        seq_len=_i("seq_len"),
        embed_dim=_i("embed_dim"),
        device=found.get("device", "unknown"),
        dtype=found["dtype"],
        bytes_per_element=_f("bytes_per_element", 2.0),
        step_us=_f("step_us", 0.0),
    )


def stats_path(name: str, stats_dir: Path | str | None = None) -> Path:
    d = Path(stats_dir) if stats_dir else _STATS_DIR
    return d / f"{name}.txt"


def load_model_stats(name: str, stats_dir: Path | str | None = None) -> ModelStats:
    """Load ``<stats_dir>/<name>.txt`` where name is
    ``<model>_<batch>_<dtype>`` (reference CLI convention,
    cpp/data_parallel/dp.cpp:140-148)."""
    path = stats_path(name, stats_dir)
    if not path.exists():
        raise FileNotFoundError(
            f"model stats file not found: {path} "
            f"(generate it with: python -m dlnetbench_tpu_torch.stats_gen)")
    return parse_stats_text(name, path.read_text())


def save_model_stats(stats: ModelStats, stats_dir: Path | str | None = None) -> Path:
    path = stats_path(stats.name, stats_dir)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(stats.to_text())
    return path
