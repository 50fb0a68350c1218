"""What the benchmark takes from the program (``repro_torch``): its model
configuration, its serve and train functions. The weights the program is
given are the benchmark's own (``weights.make``)."""

from __future__ import annotations

from dataclasses import replace

import torch


def model_config(config: dict):
    """The program's ``ModelConfig`` for a configuration file: the arch of
    ``repro_torch.configs`` with the file's sizes (``program.fields`` maps a
    published key to the program's field); a width that differs raises."""
    from repro_torch.configs import get_config

    cfg = get_config(config["arch"])
    want = {field: config[key] for key, field in config["program"]["fields"].items()}
    # a test's small copy of an arch takes every size from its file
    given = want if config["program"].get("sizes_from_file") else {"num_layers": want["num_layers"]}
    cfg = replace(cfg, tie_embeddings=config["tie_word_embeddings"], **given)
    wrong = {f: (getattr(cfg, f), v) for f, v in want.items() if getattr(cfg, f) != v}
    if wrong:
        raise ValueError(f"{config['arch']}: the program's config differs from the file: {wrong}")
    return cfg


def serve_fns(cfg, batch: int, max_len: int, device):
    from repro_torch.launch.serve import make_serve_fns

    return make_serve_fns(cfg, batch, max_len, device=device)


def prefill_into(params, cfg, tokens, state):
    """The port's one-forward state fill (``models.transformer.prefill``)."""
    from repro_torch.models.transformer import prefill

    return prefill(params, cfg, tokens, state)


def train_fns(cfg, mix: dict, config: dict, device):
    from repro_torch.launch.train import make_train_fns

    dt = getattr(torch, config["program"]["opt_state_dtype"])
    return make_train_fns(cfg, lr=mix["lr"], total_steps=mix["total_steps"],
                          warmup=mix["warmup"], remat=mix["remat"],
                          aux_weight=aux_weight(mix, config), opt_state_dtype=dt,
                          device=device)


def aux_weight(mix: dict, config: dict) -> float:
    key = mix.get("aux_weight_key")
    return float(config.get(key, 0.0)) if key else 0.0
