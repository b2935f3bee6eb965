"""The port stands alone: it never imports jax or the JAX package, and its
entry points run on the card unless the caller asks for the CPU."""
import os
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.device import resolve_device

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax\b|ml_dtypes\b|repro(?:\.|\s|$))", re.M)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    examples = os.path.join(ROOT, "examples")
    files += [os.path.join(examples, n) for n in sorted(os.listdir(examples))
              if n.startswith("torch_") and n.endswith(".py")]
    return files


def test_no_jax_or_reference_imports_in_port_sources():
    files = _port_files()
    assert len(files) > 20
    names = {os.path.relpath(f, SRC) for f in files}
    for mod in ("hpc/heat.py", "hpc/cg.py", "hpc/pagerank.py", "hpc/kmeans.py",
                "models/train_app.py", "hpc/mg.py", "hpc/montecarlo.py", "hpc/threefry.py",
                "core/lane_driver.py", "optim/adamw.py", "optim/schedule.py",
                "optim/compression.py", "data/pipeline.py", "checkpoint/serialization.py",
                "checkpoint/manager.py", "launch/train.py", "launch/steps.py",
                "core/fleetsim.py", "models/moe.py", "core/artifacts.py",
                "analysis/__init__.py", "analysis/fx_walk.py", "analysis/classify.py",
                "analysis/determinism_lint.py", "analysis/lint.py",
                "distributed/sharding.py", "launch/mesh.py", "checkpoint/reshard.py",
                "launch/op_cost.py", "launch/analysis.py", "launch/dryrun.py"):
        assert os.path.join("repro_torch", mod) in names, mod
    for name in ("quickstart", "crash_campaign", "workflow_orchestrate", "system_efficiency",
                 "train_lm", "serve_recovery"):
        assert os.path.join("..", "examples", f"torch_{name}.py") in names, name
    for path in files:
        with open(path) as f:
            hits = FORBIDDEN.findall(f.read())
        assert not hits, f"{path} imports {hits}"


def test_port_campaign_leaves_jax_unloaded():
    """A 4-test sor campaign in a fresh interpreter loads neither jax nor
    anything of the JAX package."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import repro_torch\n"
        "from repro_torch.core import CrashTester, PersistPlan\n"
        "from repro_torch.hpc.suite import ci_app, default_cache\n"
        "app = ci_app('sor', device='cpu')\n"
        "camp = CrashTester(app, PersistPlan.none(), default_cache(app), seed=0).run_campaign(4)\n"
        "assert len(camp.records) == 4\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print('LOADED', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout, out.stdout


def test_port_campaigns_of_the_new_apps_leave_jax_unloaded():
    """A 2-test campaign of each app of slices 6 and 7 (heat, cg, pagerank,
    kmeans, lm-train, mg, montecarlo) in a fresh interpreter loads neither
    jax nor anything of the JAX package."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from repro_torch.core import CrashTester, PersistPlan\n"
        "from repro_torch.hpc.suite import ci_app, default_cache\n"
        "for name in ('heat', 'cg', 'pagerank', 'kmeans', 'lm-train', 'mg', 'montecarlo'):\n"
        "    app = ci_app(name, device='cpu')\n"
        "    camp = CrashTester(app, PersistPlan.none(), default_cache(app), seed=0).run_campaign(2)\n"
        "    assert len(camp.records) == 2, name\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'ml_dtypes', 'repro')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'ml_dtypes.', 'repro.')))\n"
        "print('LOADED', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout, out.stdout


def test_port_static_workflows_leave_jax_unloaded(tmp_path):
    """The static analyzer, the static, static+verify and adaptive plan
    sources, the lint and the artifacts, in a fresh interpreter, load
    neither jax nor anything of the JAX package."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from repro_torch.analysis import analyze_app, lint_app\n"
        "from repro_torch.core import load_static_plan, load_workflow, save_static_plan, save_workflow\n"
        "from repro_torch.core.workflow import WorkflowConfig, run_workflow\n"
        "from repro_torch.hpc.suite import ci_app, default_cache\n"
        "app = ci_app('sor', device='cpu')\n"
        "for src in ('static', 'static+verify', 'adaptive'):\n"
        "    wf = run_workflow(app, WorkflowConfig(n_tests=8, seed=0, cache=default_cache(app),\n"
        "                                          plan_source=src))\n"
        "    assert wf.plan.objects == ('u',), (src, wf.plan)\n"
        f"    save_workflow({str(tmp_path / 'wf.json')!r}, wf)\n"
        f"    assert load_workflow({str(tmp_path / 'wf.json')!r}).plan_source == src\n"
        f"save_static_plan({str(tmp_path / 'sp.json')!r}, analyze_app(app))\n"
        f"assert load_static_plan({str(tmp_path / 'sp.json')!r}).static_plan().persist_objects() == ('u',)\n"
        "assert all(f == [] for f in lint_app(ci_app('montecarlo', device='cpu')).values())\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'ml_dtypes', 'repro')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'ml_dtypes.', 'repro.')))\n"
        "print('LOADED', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout, out.stdout


def test_port_serving_leaves_jax_unloaded(tmp_path):
    """The decode app and the server (a dense and an MoE arch), in a fresh
    interpreter, load neither jax, ml_dtypes nor anything of the JAX package."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from repro_torch.hpc.suite import ci_app\n"
        "from repro_torch.launch import serve\n"
        "app = ci_app('decode', device='cpu')\n"
        "s = app.run_iteration(app.init(0))\n"
        f"serve.main(['--device', 'cpu', '--decode-steps', '8', '--workdir', {str(tmp_path)!r}])\n"
        "serve.main(['--device', 'cpu', '--arch', 'qwen2-moe-a2.7b', '--decode-steps', '4',\n"
        f"            '--workdir', {str(tmp_path / 'moe')!r}])\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'ml_dtypes', 'repro')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'ml_dtypes.', 'repro.')))\n"
        "print('LOADED', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout, out.stdout


def test_port_training_and_fleet_leave_jax_unloaded(tmp_path):
    """The trainer (a crash and an EasyCrash restore, a checkpoint) and a
    --fleet server run, in a fresh interpreter, load neither jax, ml_dtypes
    nor anything of the JAX package."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from repro_torch.launch import serve, train\n"
        "st = train.main(['--device', 'cpu', '--steps', '10', '--inject-failure-every', '6',\n"
        "                 '--width', '64', '--seq', '16', '--batch', '2', '--mtbf', '6',\n"
        f"                 '--t-chk', '1', '--workdir', {str(tmp_path / 't')!r}])\n"
        "assert st['final_step'] == 10 and st['restore_source'] == 'easycrash', st\n"
        "serve.main(['--device', 'cpu', '--decode-steps', '4', '--fleet',\n"
        f"            '--fleet-horizon', '300', '--workdir', {str(tmp_path / 's')!r}])\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'ml_dtypes', 'repro')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'ml_dtypes.', 'repro.')))\n"
        "print('LOADED', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout, out.stdout


def test_entry_points_raise_without_cuda(monkeypatch):
    """Without a CUDA device, an entry point not told device='cpu' raises."""
    from repro_torch.hpc.sor import SORApp
    from repro_torch.hpc.suite import ci_app

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SORApp(grid=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ci_app("sor")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ci_app("decode")
    for name in ("heat", "cg", "pagerank", "kmeans", "lm-train", "mg", "montecarlo"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ci_app(name)
        assert ci_app(name, device="cpu").device == "cpu"
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--decode-steps", "1"])
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--steps", "1"])
    from repro_torch.configs import get_arch
    from repro_torch.models import init_cache, scaled_down
    from repro_torch.models.attention import init_kv_cache

    for arch in ("stablelm-1.6b", "rwkv6-3b", "recurrentgemma-9b"):
        cfg = scaled_down(get_arch(arch), width=64)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_cache(cfg, 2, 8)
        assert init_cache(cfg, 2, 8, device="cpu")["t"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_kv_cache(cfg, 1, 2, 8)
    assert init_kv_cache(cfg, 1, 2, 8, device="cpu")["k"].device.type == "cpu"
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert ci_app("sor", device="cpu").device == "cpu"


def test_resolve_device():
    assert resolve_device("cpu") == "cpu"
    assert resolve_device(torch.device("cpu")) == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_unported_apps_name_their_roadmap_item():
    """Every app of the JAX suite is registered; none is left unported."""
    from repro.hpc.suite import app_names as jax_app_names
    from repro_torch.hpc.suite import CI_SIZES, NOT_PORTED, app_names, ci_app

    assert app_names() == ("cg", "decode", "heat", "kmeans", "lm-train", "mg", "montecarlo",
                           "pagerank", "sor")
    assert NOT_PORTED == {}
    assert set(app_names()) == set(CI_SIZES) == set(jax_app_names())
    for name in app_names():
        assert ci_app(name, device="cpu").name == name
