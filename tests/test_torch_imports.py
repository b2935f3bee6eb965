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
    return files


def test_no_jax_or_reference_imports_in_port_sources():
    files = _port_files()
    assert len(files) > 20
    names = {os.path.relpath(f, SRC) for f in files}
    for mod in ("hpc/heat.py", "hpc/cg.py", "hpc/pagerank.py", "hpc/kmeans.py",
                "models/train_app.py", "hpc/mg.py", "hpc/montecarlo.py", "hpc/threefry.py",
                "core/lane_driver.py"):
        assert os.path.join("repro_torch", mod) in names, mod
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


def test_port_serving_leaves_jax_unloaded(tmp_path):
    """The decode app and the server, in a fresh interpreter, load neither
    jax, ml_dtypes nor anything of the JAX package."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from repro_torch.hpc.suite import ci_app\n"
        "from repro_torch.launch import serve\n"
        "app = ci_app('decode', device='cpu')\n"
        "s = app.run_iteration(app.init(0))\n"
        f"serve.main(['--device', 'cpu', '--decode-steps', '8', '--workdir', {str(tmp_path)!r}])\n"
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
