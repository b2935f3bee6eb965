"""The port's dry-run (launch/dryrun.py), the counterpart of test_system.py's
test_dryrun_tiny_mesh_compiles: stablelm-1.6b's train step counted on the
tiny (data=2, model=4) and tiny-multi (pod=2, data=2, model=2) meshes of
fake devices, without loading jax; and its prefill_32k FLOPs per device on
tiny against the JAX dry-run's (the port counts 1.045 times JAX's there;
neither remats in a prefill).  The train cell is not compared: JAX remats
the layer scan, the port does not."""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.launch.mesh import release

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ROOT = os.path.dirname(SRC)

_RUN = (
    "import runpy, sys\n"
    "sys.argv = ['dryrun'] + ARGS\n"
    "try:\n"
    "    runpy.run_module('repro_torch.launch.dryrun', run_name='__main__')\n"
    "finally:\n"
    "    bad = sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
    "                 or m.startswith(('jax.', 'jaxlib', 'repro.')))\n"
    "    print('LOADED', bad)\n"
)


@pytest.fixture(autouse=True, scope="module")
def _fake_group_released():
    yield
    release()


def _port_dryrun(args, timeout=600):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", f"ARGS = {args!r}\n" + _RUN],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout
    return out.stdout


def test_dryrun_tiny_meshes_count_the_train_step(tmp_path):
    stdout = _port_dryrun(["--arch", "stablelm-1.6b", "--shape", "train_4k",
                           "--mesh", "tiny,tiny-multi", "--out", str(tmp_path)])
    assert stdout.count("[ok]") == 2, stdout
    for mesh in ("tiny", "tiny-multi"):
        d = json.load(open(tmp_path / f"stablelm-1.6b_train_4k_{mesh}.json"))
        assert d["status"] == "ok" and d["n_devices"] == 8
        r = d["roofline"]
        assert r["flops_per_device"] > 0
        assert r["collective_bytes"] > 0
        assert r["trip_counts"] == [2, 24]
        assert d["bytes_per_device"] == r["memory_stats"]["peak_hbm_bytes"] > 0
        assert set(d["collective_bytes_by_dim"]) <= {"data", "model", "pod", "pod+data",
                                                     "data+model", "pod+data+model"}
        # eager counts every op on the local shards; 6ND is a lower bound
        assert r["flops_per_device"] > r["model_flops"] / 8


def test_dryrun_skips_and_errors_are_recorded(tmp_path, monkeypatch):
    """A cell the shape does not apply to prints [skip]; an existing JSON is
    kept with --skip-existing; a step that fails on the mesh records the op:
    here the decode step's embedded token goes through an op made for the
    test, which has no DTensor sharding strategy."""
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer

    @torch.library.custom_op("test_dryrun::no_rule", mutates_args=())
    def no_rule(x: torch.Tensor) -> torch.Tensor:
        return x.clone()

    no_rule.register_fake(lambda x: torch.empty_like(x))
    take = transformer._take_rows
    monkeypatch.setattr(transformer, "_take_rows", lambda *a: no_rule(take(*a)))

    stdout = _port_dryrun(["--arch", "stablelm-1.6b", "--shape", "long_500k",
                           "--mesh", "tiny", "--out", str(tmp_path)])
    assert "[skip] stablelm-1.6b_long_500k_tiny: pure full-attention" in stdout
    d = json.load(open(tmp_path / "stablelm-1.6b_long_500k_tiny.json"))
    assert d["status"] == "skipped"
    stdout = _port_dryrun(["--arch", "stablelm-1.6b", "--shape", "long_500k", "--mesh", "tiny",
                           "--out", str(tmp_path), "--skip-existing"])
    assert "[skip] stablelm-1.6b_long_500k_tiny\n" in stdout
    res = dryrun.run_cell("stablelm-1.6b", "decode_32k", "tiny")
    assert res["status"] == "error" and "test_dryrun.no_rule" in res["error"], res.get("error")


def test_prefill_flops_within_a_quarter_of_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC, DRYRUN_DEVICES="8", JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "repro.launch.dryrun", "--arch", "stablelm-1.6b",
         "--shape", "prefill_32k", "--mesh", "tiny", "--out", str(tmp_path / "jax")],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    jax_cell = json.load(open(tmp_path / "jax" / "stablelm-1.6b_prefill_32k_tiny.json"))
    _port_dryrun(["--arch", "stablelm-1.6b", "--shape", "prefill_32k", "--mesh", "tiny",
                  "--out", str(tmp_path / "port")])
    port_cell = json.load(open(tmp_path / "port" / "stablelm-1.6b_prefill_32k_tiny.json"))
    ratio = port_cell["roofline"]["flops_per_device"] / jax_cell["roofline"]["flops_per_device"]
    # a global (unsharded) count would be 8x off
    assert 0.75 <= ratio <= 1.25, ratio
    assert port_cell["roofline"]["model_flops"] == jax_cell["roofline"]["model_flops"]
    assert port_cell["param_counts"] == jax_cell["param_counts"]
