"""Checkpoints with a manifest, a commit marker, retention and async save
(counterpart of :mod:`repro.checkpoint.store`), in the JAX package's
on-disk format, so that each package reads the other's files.

Layout: ``<dir>/step_<n>/`` holds one ``.npy`` per tree leaf plus
``manifest.json`` (step, extra, and for each leaf its file, shape, logical
dtype and a sha1 digest). Leaves are keyed by their path joined with
``::`` in ``jax.tree_util`` order: dict keys sorted, list entries by index.
bfloat16 (which numpy has no type of its own for) is stored as its
``uint16`` bits with ``"bfloat16"`` in the manifest. A ``COMMIT`` marker
(the step and the manifest's sha256, nothing that depends on the clock) is
written last, and :func:`latest_step` only considers committed steps: a
crash mid-save never yields a checkpoint that restore would accept. For the
same tree at the same step both packages write byte-identical directories.

Restore returns torch tensors on the device the caller names. Async mode
copies the tensors to the host first (a consistent snapshot), then writes
on a background thread while training goes on.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.device import resolve_device

_SEP = "::"
_PLAIN = (np.float64, np.float32, np.float16, np.int64, np.int32, np.int16, np.int8,
          np.uint64, np.uint32, np.uint16, np.uint8, np.bool_)


def _flatten(tree, prefix=()) -> dict:
    """``{key: leaf}`` in ``jax.tree_util`` order (dict keys sorted, lists
    and tuples by index); ``None`` is an empty subtree, as in JAX."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (str(i),)))
        return out
    return {_SEP.join(prefix): tree}


def _unflatten(like, values: dict, prefix=()):
    """A tree of ``like``'s structure with the leaf at each key from
    ``values``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], values, prefix + (str(k),)) for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, values, prefix + (str(i),)) for i, v in enumerate(like))
    return values[_SEP.join(prefix)]


def _logical(leaf) -> tuple[np.ndarray, str]:
    """(the array to store, its logical dtype name) of a tensor or array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        leaf = t.numpy()
    arr = np.asarray(leaf)
    name = str(arr.dtype)
    if arr.dtype.kind == "V" or "bfloat16" in name or arr.dtype not in _PLAIN:
        return arr.view(np.dtype(f"u{arr.dtype.itemsize}")), name
    return arr, name


def save_checkpoint(ckpt_dir, step: int, tree, extra: dict | None = None) -> Path:
    """Write ``tree`` (torch tensors or numpy arrays) as step ``step``."""
    ckpt_dir = Path(ckpt_dir)
    tgt = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for key, leaf in _flatten(tree).items():
        stored, logical_dtype = _logical(leaf)
        fname = hashlib.sha1(key.encode()).hexdigest()[:16] + ".npy"
        np.save(tmp / fname, stored)
        manifest["leaves"][key] = {
            "file": fname,
            "shape": list(stored.shape),
            "dtype": logical_dtype,
            # the logical array's bytes: for bfloat16, its uint16 bits
            "digest": hashlib.sha1(stored.tobytes()).hexdigest()[:16],
        }
    manifest_text = json.dumps(manifest)
    (tmp / "manifest.json").write_text(manifest_text)
    (tmp / "COMMIT").write_text(
        json.dumps(
            {
                "step": step,
                "manifest_sha256": hashlib.sha256(manifest_text.encode()).hexdigest(),
            }
        )
    )
    if tgt.exists():
        shutil.rmtree(tgt)
    tmp.rename(tgt)
    return tgt


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if str(arr.dtype) == dtype:
        return torch.from_numpy(arr)
    if dtype == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    raise ValueError(f"cannot restore a {dtype} leaf stored as {arr.dtype}")


def load_checkpoint(ckpt_dir, step: int, like_tree, device=None, verify: bool = True):
    """Restore step ``step`` into the structure of ``like_tree`` as tensors
    on ``device`` (``None``: the card). Returns (tree, manifest). Raises
    for an uncommitted step, a missing leaf or (``verify``) a digest that
    does not match."""
    dev = resolve_device(device)
    src = Path(ckpt_dir) / f"step_{step:08d}"
    if not (src / "COMMIT").exists():
        raise FileNotFoundError(f"no committed checkpoint at {src}")
    manifest = json.loads((src / "manifest.json").read_text())
    out = {}
    for key in _flatten(like_tree):
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.load(src / meta["file"])
        if verify:
            dig = hashlib.sha1(arr.tobytes()).hexdigest()[:16]
            if dig != meta["digest"]:
                raise IOError(f"digest mismatch for {key!r} (corrupt leaf)")
        out[key] = _tensor(arr, meta["dtype"]).to(dev)
    return _unflatten(like_tree, out), manifest


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(
        int(p.name.split("_")[1])
        for p in ckpt_dir.glob("step_*")
        if (p / "COMMIT").exists()
    )
    return steps[-1] if steps else None


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree, copy=True)


class CheckpointManager:
    """Retention + optional async save, resume helper."""

    def __init__(self, ckpt_dir, keep: int = 3, async_save: bool = True):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree, extra: dict | None = None) -> None:
        self.wait()
        # copy to the host now (a consistent snapshot), write in the background
        host_tree = _to_host(tree)

        def work():
            try:
                save_checkpoint(self.dir, step, host_tree, extra)
                self._gc()
            except Exception as e:  # surfaced on the next wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            if self._error:
                err, self._error = self._error, None
                raise err

    def restore_latest(self, like_tree, device=None):
        step = latest_step(self.dir)
        if step is None:
            return None, None
        return load_checkpoint(self.dir, step, like_tree, device)

    def _gc(self) -> None:
        steps = sorted(
            int(p.name.split("_")[1])
            for p in self.dir.glob("step_*")
            if (p / "COMMIT").exists()
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
