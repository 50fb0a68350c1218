"""The port's training substrate against the JAX package's, on the CPU: the
data stream bit for bit, checkpoints byte for byte in both directions,
and the fault-tolerance and elastic cases of ``tests/test_substrate.py``
run on the port's copies."""

import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.data import SyntheticLMDataset as JaxDataset
from repro.runtime.elastic import plan_mesh as jax_plan_mesh
from repro_torch.checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
from repro_torch.checkpoint.store import latest_step
from repro_torch.data import SyntheticLMDataset, make_batch_iterator
from repro_torch.runtime import StepWatchdog, StragglerMonitor, retry_step
from repro_torch.runtime.elastic import ElasticMeshManager, plan_mesh
from repro_torch.runtime.fault_tolerance import StepTimeoutError


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("vocab,seq,batch,seed,step", [
    (1000, 32, 8, 3, 17), (151_936, 64, 4, 0, 0), (65_536, 16, 2, 12345, 999_999),
])
def test_stream_is_bit_identical_to_the_jax_package(vocab, seq, batch, seed, step):
    want = JaxDataset(vocab, seq, batch, seed=seed).batch_at(step)
    got = SyntheticLMDataset(vocab, seq, batch, seed=seed).batch_at(step)
    for key in ("tokens", "labels"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_labels_shifted_and_steps_differ():
    ds = SyntheticLMDataset(1000, 32, 4)
    b = ds.batch_at(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert not np.array_equal(b["tokens"], ds.batch_at(1)["tokens"])


def test_process_slices_partition_the_global_batch():
    ds = SyntheticLMDataset(1000, 16, 8)
    full = ds.batch_at(5)["tokens"]
    parts = [next(make_batch_iterator(ds, 5, process_index=i, process_count=4))["tokens"]
             for i in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), full)
    # no process group is up: the iterator yields the whole batch
    it = make_batch_iterator(ds, start_step=5)
    np.testing.assert_array_equal(next(it)["tokens"], full)
    np.testing.assert_array_equal(next(it)["tokens"], ds.batch_at(6)["tokens"])


# ------------------------------------------------------------ checkpoints
def _numpy_tree():
    rng = np.random.default_rng(0)
    return {
        "params": {
            "w": rng.normal(size=(3, 4)).astype(np.float32),
            "emb": rng.normal(size=(5, 2)).astype(ml_dtypes.bfloat16),
            "layers": [{"b": np.arange(4, dtype=np.int32)},
                       {"b": np.ones(4, dtype=np.int32)}],
        },
        "opt": {"m": rng.normal(size=(2, 2)).astype(np.float32),
                "step": np.asarray(7, dtype=np.int32)},
        "flag": np.array([True, False]),
    }


def test_checkpoint_directories_are_byte_identical(tmp_path):
    tree = _numpy_tree()
    a = jstore.save_checkpoint(tmp_path / "jax", 7, tree, extra={"note": "x"})
    b = save_checkpoint(tmp_path / "port", 7, tree, extra={"note": "x"})
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_port_tensors_write_the_same_bytes_as_numpy(tmp_path):
    tree = _numpy_tree()
    as_torch = {
        "params": {
            "w": torch.from_numpy(tree["params"]["w"]),
            "emb": torch.from_numpy(tree["params"]["emb"].view(np.int16)).view(torch.bfloat16),
            "layers": [{"b": torch.from_numpy(d["b"])} for d in tree["params"]["layers"]],
        },
        "opt": {"m": torch.from_numpy(tree["opt"]["m"]), "step": torch.tensor(7, dtype=torch.int32)},
        "flag": torch.tensor([True, False]),
    }
    a = jstore.save_checkpoint(tmp_path / "jax", 3, tree)
    b = save_checkpoint(tmp_path / "port", 3, as_torch)
    for p in a.iterdir():
        assert p.read_bytes() == (b / p.name).read_bytes(), p.name


def test_each_package_loads_the_others_checkpoint(tmp_path):
    tree = _numpy_tree()
    jstore.save_checkpoint(tmp_path / "jax", 4, tree)
    save_checkpoint(tmp_path / "port", 4, tree)
    got, manifest = load_checkpoint(tmp_path / "jax", 4, tree, device="cpu")
    assert manifest["step"] == 4
    assert got["params"]["emb"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["params"]["emb"].view(torch.int16).numpy(),
                                  tree["params"]["emb"].view(np.int16))
    np.testing.assert_array_equal(got["params"]["w"].numpy(), tree["params"]["w"])
    assert got["opt"]["step"].dtype == torch.int32 and int(got["opt"]["step"]) == 7
    back, _ = jstore.load_checkpoint(tmp_path / "port", 4, tree)
    assert back["params"]["emb"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(back["params"]["emb"], tree["params"]["emb"])
    np.testing.assert_array_equal(back["params"]["layers"][1]["b"],
                                  tree["params"]["layers"][1]["b"])


def test_roundtrip_commit_and_corruption(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4)}}
    save_checkpoint(tmp_path, 7, tree)
    assert latest_step(tmp_path) == 7
    out, manifest = load_checkpoint(tmp_path, 7, tree, device="cpu")
    assert torch.equal(out["a"], tree["a"]) and manifest["step"] == 7
    npy = next(p for p in (tmp_path / "step_00000007").glob("*.npy")
               if np.load(p).shape == (4,))
    arr = np.load(npy)
    arr[0] = 999.0
    np.save(npy, arr)
    with pytest.raises(IOError):
        load_checkpoint(tmp_path, 7, tree, device="cpu")
    with pytest.raises(FileNotFoundError):
        load_checkpoint(tmp_path, 8, tree, device="cpu")


def test_manager_retention_async_and_resume(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=True)
    for s in (10, 20, 30):
        mgr.save(s, {"x": torch.full((3,), float(s))})
    mgr.wait()
    assert sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*")) == [20, 30]
    restored, manifest = mgr.restore_latest({"x": torch.zeros(3)}, device="cpu")
    assert manifest["step"] == 30
    assert torch.equal(restored["x"], torch.full((3,), 30.0))
    empty = CheckpointManager(tmp_path / "none")
    assert empty.restore_latest({"x": torch.zeros(3)}, device="cpu") == (None, None)


def test_manager_snapshot_is_taken_at_save(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=1, async_save=True)
    x = torch.zeros(1000)
    mgr.save(1, {"x": x})
    x += 1.0  # the write in the background must see the tree as it was
    mgr.wait()
    restored, _ = mgr.restore_latest({"x": x}, device="cpu")
    assert not bool(restored["x"].any())


# ------------------------------------------------------------ fault tolerance
def test_retry_recovers_transient():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return "ok"

    assert retry_step(flaky, retries=3, backoff_s=0.0) == "ok"
    assert calls["n"] == 3


def test_retry_exhausts():
    def dead():
        raise RuntimeError("permanent")

    with pytest.raises(RuntimeError):
        retry_step(dead, retries=1, backoff_s=0.0)


def test_watchdog_fires_and_passes_a_fast_step():
    with pytest.raises(StepTimeoutError):
        with StepWatchdog(timeout_s=0.05):
            time.sleep(0.2)
    with StepWatchdog(timeout_s=5.0):
        pass


def test_straggler_flagged():
    mon = StragglerMonitor(patience=2)
    flagged = []
    for _ in range(3):
        flagged = mon.observe({f"h{i}": 1.0 for i in range(8)} | {"slow": 3.0})
    assert flagged == ["slow"]


# ------------------------------------------------------------------ elastic
@pytest.mark.parametrize("n,tp,batch", [(224, 16, 256), (256, 16, 256), (240, 16, 256),
                                        (7, 1, 12), (8, 2, 6)])
def test_plan_mesh_equals_the_jax_package(n, tp, batch):
    assert vars(plan_mesh(n, tp, batch)) == vars(jax_plan_mesh(n, tp, batch))


def test_plan_rejects_too_few():
    with pytest.raises(ValueError):
        plan_mesh(n_devices=8, model_parallel=16, global_batch=64)


def test_elastic_manager_builds_a_device_grid():
    mgr = ElasticMeshManager(model_parallel=2, global_batch=6)
    grid = mgr.build(["cpu"] * 5)
    assert grid.shape == {"data": 2, "model": 2}
    assert mgr.plan.dropped_devices == 1
    assert all(d == torch.device("cpu") for d in grid.devices.flat)
    assert mgr.on_membership_change(["cpu"] * 2).shape == {"data": 1, "model": 2}


def test_jnp_trees_save_like_numpy(tmp_path):
    tree = {"a": jnp.arange(6.0).reshape(2, 3)}
    a = jstore.save_checkpoint(tmp_path / "j", 1, tree)
    b = save_checkpoint(tmp_path / "p", 1, {"a": np.asarray(tree["a"])})
    assert (a / "manifest.json").read_bytes() == (b / "manifest.json").read_bytes()
