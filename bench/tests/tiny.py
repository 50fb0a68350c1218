"""Small copies of the benchmark's configurations and mixes for the CPU
tests: the same keys, tiny sizes."""

from __future__ import annotations

import copy
import time

import torch

from bench.harness import spec
from bench.harness.runner import run_cell

SMALL = {
    "qwen3-1.7b": {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
                   "head_dim": 16, "intermediate_size": 128, "vocab_size": 256,
                   "num_hidden_layers": 2},
    "deepseek-moe-16b-l8": {"hidden_size": 64, "num_attention_heads": 4,
                            "num_key_value_heads": 4, "moe_intermediate_size": 32,
                            "vocab_size": 256, "num_hidden_layers": 2, "n_routed_experts": 8,
                            "num_experts_per_tok": 2, "n_shared_experts": 2, "head_dim": 16},
}
MIXES = {
    "train-2k": {"batch": 4, "seq_len": 16},
    "train-4k": {"batch": 4, "seq_len": 24},
    "decode-32k": {"batch": 4, "prompt_len": 24, "max_len": 40, "checked_sequences": 2},
}


def config(name: str) -> dict:
    c = copy.deepcopy(spec.config(spec.load(), name))
    c.update(SMALL[name])
    c["program"]["sizes_from_file"] = True
    c["program"]["fields"]["head_dim"] = "head_dim"
    return c


def mix(name: str) -> dict:
    m = copy.deepcopy(spec.mix(name))
    m.update(MIXES[name])
    return m


def run(cell: str, seed: int = 7, seconds: float = 1.0, fault=None, control=False,
        limits=None, device=None) -> dict:
    """One run of a small copy of ``cell`` on the CPU, past the look for a
    card."""
    bench = spec.load()
    entry = spec.cell(bench, cell)
    lim = limits if limits is not None else spec.limits(cell)
    return run_cell(cell, config(entry["config"]), mix(entry["traffic"]), lim,
                    spec.metrics_for(bench, cell, False), seed, seconds, False,
                    device or torch.device("cpu"), time.perf_counter(), fault=fault,
                    control=control)
