"""End-to-end trainer: data -> step -> checkpoint -> fault tolerance
(counterpart of :mod:`repro.launch.trainer`).

This is the driver :mod:`repro_torch.launch.train_lm` uses. It runs on one
device, ``device`` taking the place of the JAX trainer's ``mesh``, with the
same code paths: the counter-based data stream, the step watchdog,
transient-failure retry, async checkpoints and resume.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.launch.train import make_train_fns, width_scaled_lr
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import leaves
from repro_torch.runtime import StepWatchdog, StragglerMonitor, retry_step


@dataclass
class TrainReport:
    steps: int
    final_loss: float
    losses: list
    resumed_from: int | None
    step_times: list


def train(
    cfg: ModelConfig,
    steps: int = 20,
    global_batch: int = 8,
    seq_len: int = 64,
    ckpt_dir=None,
    ckpt_every: int = 10,
    step_timeout_s: float = 600.0,
    remat: str = "none",
    seed: int = 0,
    inject_failure_at: int | None = None,
    lr: float | None = None,
    warmup: int | None = None,
    total_steps: int = 10_000,
    device=None,
) -> TrainReport:
    """Train ``cfg`` from step 0 (or the latest checkpoint in ``ckpt_dir``)
    to ``steps`` on ``device`` (``None``: the card), with weights drawn
    from ``torch.Generator(seed)`` on the device.

    The lr and warmup defaults transfer the peak lr across width and
    shorten warmup at smoke widths, and stay functions of the global step
    only, so a resumed run replays the same schedule (the JAX trainer's
    defaults). Each step's time covers the whole step: the loss is read
    back inside the watchdog. ``inject_failure_at`` raises once, before
    that step runs, to exercise the retry path.
    """
    dev = resolve_device(device)
    if lr is None:
        lr = width_scaled_lr(cfg.d_model)
    if warmup is None:
        warmup = 3 if cfg.d_model <= 256 else 200
    fns = make_train_fns(cfg, lr=lr, warmup=warmup, total_steps=total_steps,
                         remat=remat, device=dev)
    ds = SyntheticLMDataset(cfg.vocab_size, seq_len, global_batch, seed=seed)

    mgr = CheckpointManager(ckpt_dir, keep=2) if ckpt_dir else None
    start_step = 0
    resumed_from = None
    params = opt_state = None
    if mgr is not None:
        restored, manifest = mgr.restore_latest(
            {"params": fns["param_shapes"], "opt": fns["opt_shapes"]}, device=dev)
        if restored is not None:
            params, opt_state = restored["params"], restored["opt"]
            for p in leaves(params):
                p.requires_grad_(True)
            start_step = manifest["step"]
            resumed_from = start_step
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params, opt_state = fns["init"](gen)

    monitor = StragglerMonitor()
    losses, step_times = [], []
    injected = {"done": False}

    for step in range(start_step, steps):
        batch = ds.batch_at(step)

        def one_step():
            if (
                inject_failure_at is not None
                and step == inject_failure_at
                and not injected["done"]
            ):
                injected["done"] = True
                raise RuntimeError("injected transient step failure")
            return fns["step"](params, opt_state, batch)

        t0 = time.perf_counter()
        with StepWatchdog(step_timeout_s):
            params, opt_state, metrics = retry_step(one_step, retries=2)
            loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        step_times.append(dt)
        monitor.observe({"host0": dt})
        losses.append(loss)
        if mgr is not None and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, {"params": params, "opt": opt_state})
    if mgr is not None:
        mgr.wait()
    return TrainReport(
        steps=steps,
        final_loss=losses[-1] if losses else float("nan"),
        losses=losses,
        resumed_from=resumed_from,
        step_times=step_times,
    )
