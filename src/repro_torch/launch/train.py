"""The training step: loss, gradients, global-norm clip and AdamW, with
remat (counterpart of :mod:`repro.launch.train`).

``make_train_fns`` returns the step the trainer (:mod:`repro_torch.launch.
trainer`) runs. The JAX function also returns parameter, optimizer, metric
and batch shardings for its FSDP x TP meshes; the port runs on one card and
has no mesh (``launch/sharding.py`` and ``launch/mesh.py`` are not ported),
so those entries are left out.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import forward, init_model
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import param_shapes
from repro_torch.optim import adamw, cosine_schedule, global_norm
from repro_torch.optim.adamw import from_leaves, leaves, tree_map


def cross_entropy(logits, labels):
    """Mean token cross-entropy in float32. The JAX function picks the
    label's logit with a one-hot contraction (for its vocab-sharded head);
    a gather picks the same term, and at 8,192 tokens x 151,936 a float32
    one-hot would be 5 GB."""
    lf = logits.float()
    m = lf.max(dim=-1, keepdim=True).values.detach()
    shifted = lf - m
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1))
    picked = torch.gather(shifted, -1, labels.long()[..., None])[..., 0]
    return (lse - picked).mean()


def width_scaled_lr(d_model: int, base_lr: float = 3e-4, base_width: int = 2048) -> float:
    """Adam peak lr transferred across model width: ``base_lr`` at
    ``base_width``, the exponent calibrated to 1.5 for the sub-256 smoke
    widths, clamped to a sane Adam range (the JAX function's)."""
    return float(min(5e-2, max(base_lr, base_lr * (base_width / d_model) ** 1.5)))


def make_train_fns(
    cfg: ModelConfig,
    lr: float = 3e-4,
    total_steps: int = 10_000,
    warmup: int = 200,
    remat: str = "full",
    aux_weight: float = 0.01,
    opt_state_dtype: torch.dtype = torch.float32,
    device=None,
):
    """``{"init", "step", "loss", "param_shapes", "opt_shapes"}`` on
    ``device`` (``None``: the card).

    * ``init(generator)`` -- (params, optimizer state), the weights drawn
      from ``generator`` (on the device), every parameter a leaf that
      requires a gradient;
    * ``step(params, opt_state, batch)`` -- one step on ``batch``
      (``{"tokens", "labels"}``, (B, S) integer arrays or tensors, and for
      a VLM ``"patches"`` (B, P, D), for an encoder arch ``"frames"`` (B,
      T, D): passed to ``forward`` as ``extra_embeds`` and ``frames``, as
      the JAX ``loss_fn`` passes them):
      ``(params, opt_state, {"loss", "step", "grad_norm"})`` (the
      gradients' global norm before the clip). The loss, the gradients
      and the clip scale are computed first and the update is written into
      ``params`` and ``opt_state`` last, so a step that raises leaves both
      as they were (the JAX step is a pure function);
    * ``loss(params, batch)`` -- the loss alone;
    * ``param_shapes`` / ``opt_shapes`` -- the two trees as meta tensors
      (shapes and dtypes, no memory), for restoring a checkpoint.
    """
    dev = resolve_device(device)
    opt = adamw(
        lr=cosine_schedule(lr, warmup=warmup, total=total_steps),
        state_dtype=opt_state_dtype,
    )

    def init_fn(generator: torch.Generator):
        params = init_model(cfg, generator=generator, device=dev)
        for p in leaves(params):
            p.requires_grad_(True)
        return params, opt.init(params)

    def _batch(batch):
        return {k: torch.as_tensor(batch[k]).to(dev)
                for k in ("tokens", "labels", "patches", "frames") if k in batch}

    def loss_fn(params, batch):
        batch = _batch(batch)
        logits, aux = forward(params, cfg, batch["tokens"], extra_embeds=batch.get("patches"),
                              frames=batch.get("frames"), remat=remat)
        return cross_entropy(logits, batch["labels"]) + aux_weight * aux

    def step_fn(params, opt_state, batch):
        ps = leaves(params)
        with torch.enable_grad():
            loss = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, ps)
        grad_tree = from_leaves(params, grads)
        grad_norm = global_norm(grad_tree)
        params, opt_state = opt.update_(grad_tree, opt_state, params)
        return params, opt_state, {"loss": loss.detach(), "step": opt_state["step"].clone(),
                                   "grad_norm": grad_norm}

    shapes = param_shapes(cfg)
    opt_shapes = {
        "m": tree_map(lambda t: torch.empty_like(t, dtype=opt_state_dtype), shapes),
        "v": tree_map(lambda t: torch.empty_like(t, dtype=opt_state_dtype), shapes),
        "step": torch.empty((), dtype=torch.int32, device="meta"),
    }
    return {
        "init": init_fn,
        "step": step_fn,
        "loss": loss_fn,
        "param_shapes": shapes,
        "opt_shapes": opt_shapes,
    }
