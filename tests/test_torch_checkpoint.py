"""The port's checkpoint package (copies of repro/checkpoint/{serialization,
manager}.py) against the JAX package's: the same on-disk format, so a
checkpoint crosses between the two byte for byte (bfloat16 leaves
included); atomic commits, retention, the remote tier with its fallback,
SIGKILL mid-write, and measured write costs, as tests/test_checkpoint.py
checks them in JAX."""
import os
import shutil
import signal
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jax_load_pytree
from repro.checkpoint import save_pytree as jax_save_pytree
from repro_torch.checkpoint import (
    CheckpointConfig,
    CheckpointManager,
    load_pytree,
    measure_checkpoint_cost,
    measured_system_config,
    save_pytree,
    system_config_from_measurement,
    tree_nbytes,
)
from repro_torch.convert import host_array, to_tensor

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _tree(step):
    return {
        "params": {"w": np.full((4, 4), float(step), np.float32)},
        "opt": {"mu": np.arange(8, dtype=np.float32) * step},
        "step": np.asarray(step),
    }


def _jax_tree():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((5, 7)).astype(np.float32)
    return {
        "params": {"w": np.asarray(jnp.asarray(w, jnp.bfloat16)),
                   "b": rng.standard_normal(6).astype(np.float32)},
        "opt": {"count": np.asarray(3, np.int32)},
        "step": np.asarray(9, np.int32),
    }


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else to_tensor(v, "cpu")
            for k, v in tree.items()}


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


def test_jax_checkpoint_loads_in_port_byte_for_byte(tmp_path):
    tree = _jax_tree()
    jax_save_pytree(tree, str(tmp_path / "j"))
    back = load_pytree(str(tmp_path / "j"))
    w = back["params"]["w"]
    assert w.dtype.kind == "V" and w.dtype.itemsize == 2  # no ml_dtypes needed
    t = to_tensor(w, "cpu")
    assert t.dtype == torch.bfloat16
    assert host_array(t).tobytes() == tree["params"]["w"].tobytes()
    for k in ("b",):
        assert back["params"][k].tobytes() == tree["params"][k].tobytes()
    assert back["step"].dtype == np.int32 and int(back["step"]) == 9
    assert back["step"].shape == ()


def test_port_checkpoint_is_the_jax_files_and_loads_in_jax(tmp_path):
    """The port writes, from tensors, the very files JAX writes from the
    same arrays (np.save headers included), and JAX loads them back."""
    tree = _jax_tree()
    jax_save_pytree(tree, str(tmp_path / "j"))
    save_pytree(_torch_tree(tree), str(tmp_path / "p"))
    assert _files(tmp_path / "j") == _files(tmp_path / "p")
    back = jax_load_pytree(str(tmp_path / "p"))
    assert back["params"]["w"].dtype == jnp.bfloat16
    assert back["params"]["w"].tobytes() == tree["params"]["w"].tobytes()
    # and from numpy: a void-typed bfloat16 array writes the same file
    host = dict(tree, params=dict(tree["params"],
                                  w=tree["params"]["w"].view(np.int16).view(np.dtype("V2"))))
    save_pytree(host, str(tmp_path / "v"))
    assert _files(tmp_path / "j") == _files(tmp_path / "v")


def test_tree_nbytes_counts_tensors_without_copying():
    tree = _torch_tree(_jax_tree())
    assert tree_nbytes(tree) == 5 * 7 * 2 + 6 * 4 + 4 + 4 == tree_nbytes(_jax_tree())


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(local_dir=str(tmp_path / "l")))
    mgr.save(7, _torch_tree(_tree(7)))
    step, tree = mgr.restore()
    assert step == 7
    assert np.all(tree["params"]["w"] == 7.0)
    assert np.all(tree["opt"]["mu"] == np.arange(8) * 7)


def test_retention(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(local_dir=str(tmp_path / "l"), keep=2))
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.list_steps(str(tmp_path / "l")) == [3, 4]


def test_remote_tier_drain_and_fallback(tmp_path):
    cfg = CheckpointConfig(local_dir=str(tmp_path / "l"),
                           remote_dir=str(tmp_path / "r"), keep=1)
    mgr = CheckpointManager(cfg)
    mgr.save(4, _tree(4))
    mgr.save(5, _torch_tree(_tree(5)))
    mgr.close()
    assert mgr.list_steps(str(tmp_path / "r")) == [5]
    # local tier destroyed (node lost): restore falls back to remote
    shutil.rmtree(str(tmp_path / "l"))
    os.makedirs(str(tmp_path / "l"))
    mgr2 = CheckpointManager(cfg)
    step, tree = mgr2.restore()
    assert step == 5 and np.all(tree["params"]["w"] == 5.0)
    assert _files(tmp_path / "r" / "step_0000000005")["manifest.json"]


def test_sigkill_mid_write_restores_last_complete_checkpoint(tmp_path):
    """Kill -9 a writer (which imports only the port) mid-checkpoint: the
    manager comes back with the newest complete checkpoint, every leaf from
    the same step; a torn in-flight directory is never listed."""
    local = str(tmp_path / "l")
    code = f"""
import os, sys
sys.path.insert(0, {SRC!r})
import numpy as np
import torch
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager

assert not any(m == "jax" or m.startswith(("jax.", "repro.")) for m in sys.modules)
mgr = CheckpointManager(CheckpointConfig(local_dir={local!r}, keep=3))
for step in range(1, 200):
    tree = {{
        "params": {{"w": torch.full((1 << 20,), float(step)).to(torch.bfloat16)}},
        "opt": {{"mu": torch.full((1 << 20,), float(step))}},
        "step": torch.tensor(step, dtype=torch.int32),
    }}
    mgr.save(step, tree)
    print(f"SAVED {{step}}", flush=True)
"""
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, text=True,
                            env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        saved = 0
        for line in proc.stdout:
            if line.startswith("SAVED"):
                saved = int(line.split()[1])
            if saved >= 2:
                break
        assert saved >= 2, "writer died before producing two checkpoints"
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        proc.stdout.close()
        proc.wait()
    assert proc.returncode == -signal.SIGKILL

    mgr2 = CheckpointManager(CheckpointConfig(local_dir=local))
    restored = mgr2.restore()
    assert restored is not None, "no complete checkpoint survived the kill"
    step, tree = restored
    assert step >= 2
    w = to_tensor(tree["params"]["w"], "cpu")
    assert w.dtype == torch.bfloat16 and bool((w == float(step)).all())
    assert np.all(tree["opt"]["mu"] == float(step))
    assert int(tree["step"]) == step
    for s in mgr2.list_steps(local):
        assert os.path.exists(os.path.join(local, f"step_{s:010d}", "manifest.json"))
    mgr2.save(step + 1, _tree(step + 1))
    s2, t2 = mgr2.restore()
    assert s2 == step + 1 and np.all(t2["params"]["w"] == float(step + 1))


def test_measured_checkpoint_cost_and_system_config(tmp_path):
    tree = _torch_tree(_tree(3))
    mgr = CheckpointManager(CheckpointConfig(local_dir=str(tmp_path / "l")))
    assert mgr.mean_save_seconds() == 0.0
    mgr.save(1, tree)
    mgr.save(2, tree)
    assert len(mgr.save_seconds) == 2 and mgr.mean_save_seconds() > 0.0

    secs, nbytes = measure_checkpoint_cost(tree, repeats=2)
    assert secs > 0.0 and nbytes == tree_nbytes(tree) > 0

    cfg = system_config_from_measurement(0.25, 1 << 20, mtbf=7200.0)
    assert cfg.t_chk == 0.25 and cfg.mtbf == 7200.0
    cfg2 = system_config_from_measurement(0.25, 1 << 20, mtbf=7200.0, target_bytes=1 << 30)
    assert cfg2.t_chk == pytest.approx(0.25 * 1024)
    with pytest.raises(ValueError):
        system_config_from_measurement(0.0, 1 << 20, mtbf=7200.0)
    with pytest.raises(ValueError):
        measure_checkpoint_cost(tree, repeats=0)

    measured = measured_system_config(tree, mtbf=7200.0, repeats=2)
    assert measured.t_chk > 0.0 and measured.mtbf == 7200.0
