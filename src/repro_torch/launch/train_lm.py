"""End-to-end training driver (counterpart of ``examples/train_lm.py``):
train a reduced LM with the full code path of the port's trainer --
watchdog, transient-failure retry, async checkpoints and resume.

Run (on the card unless ``--device cpu``)::

    PYTHONPATH=src python -m repro_torch.launch.train_lm [--arch qwen3-1.7b]
        [--steps 200] [--batch 8] [--seq 128] [--d-model 256] [--layers 4]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile

from repro_torch.configs import get_config
from repro_torch.launch.trainer import train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=256, help="reduced width")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).scaled(
        d_model=args.d_model,
        num_heads=max(4, args.d_model // 64),
        head_dim=64,
        d_ff=args.d_model * 4,
        num_layers=args.layers,
        vocab_size=4096,
    )
    with tempfile.TemporaryDirectory() as ckpt:
        print(f"training {cfg.name} ({args.steps} steps) with checkpoints in {ckpt}")
        rep = train(
            cfg, steps=args.steps, global_batch=args.batch, seq_len=args.seq,
            ckpt_dir=ckpt, ckpt_every=50,
            inject_failure_at=min(7, args.steps - 1),  # exercise the retry path
            device=args.device,
        )
        print(f"loss: {rep.losses[0]:.3f} -> {rep.final_loss:.3f} "
              f"({rep.steps} steps, retry exercised, resumed_from={rep.resumed_from})")
        if not rep.final_loss < rep.losses[0]:
            raise SystemExit("loss did not go down")
        print("ok.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
