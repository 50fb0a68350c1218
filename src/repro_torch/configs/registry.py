"""Architectures x input shapes (the 40-cell grid of the JAX package).

Each architecture is one module here holding ``CONFIG`` with the published
dimensions: the dense-GQA Qwen3-1.7B, ChatGLM3-6B and Qwen2-72B, the MLA
MiniCPM3-4B, the MoE DeepSeekMoE-16B and Granite-MoE-1B, the attention-free
RWKV6-3B, the encoder-decoder Whisper-small, the VLM InternVL2-1B (their
frontends stubs, as in the JAX package) and the hybrid Jamba-1.5-Large
(attention, Mamba and MoE blocks): every architecture of the JAX package,
so ``PORTED_ARCHS`` is ``ARCHS``. ``long_500k`` needs a sub-quadratic token
mixer and is a skip for pure full-attention archs.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

ARCHS = (
    "qwen3-1.7b",
    "chatglm3-6b",
    "minicpm3-4b",
    "qwen2-72b",
    "deepseek-moe-16b",
    "granite-moe-1b-a400m",
    "internvl2-1b",
    "jamba-1.5-large-398b",
    "whisper-small",
    "rwkv6-3b",
)
PORTED_ARCHS = ARCHS  # every architecture runs in the port


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown architecture {name!r}; known: {ARCHS}")
    mod = importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_")
    )
    return mod.CONFIG


def arch_shape_cells(archs=PORTED_ARCHS):
    """The (arch, shape, skip reason or None) cells of ``archs`` (default:
    all of them, the JAX package's grid)."""
    cells = []
    for a in archs:
        cfg = get_config(a)
        for s in SHAPES.values():
            skip = None
            if s.name == "long_500k" and not cfg.subquadratic:
                skip = "pure full-attention arch: 500k decode needs a sub-quadratic mixer"
            cells.append((a, s.name, skip))
    return cells
