"""The port's sharding layer against the JAX package's: the logical spec
trees of all ten archs, ShardingRules.resolve on every mesh's axes, and the
local shard shapes on the tiny meshes (JAX's from NamedSharding.shard_shape
in a subprocess with 8 host devices, the port's from DTensor placements on
a fake process group)."""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_arch as jax_arch
from repro.distributed import sharding as jax_sharding
from repro.launch import steps as jax_steps
from repro.models import SHAPES as JAX_SHAPES
from repro.models import cache_specs as jax_cache_specs
from repro.models import param_specs as jax_param_specs
from repro.optim.adamw import opt_state_specs as jax_opt_state_specs
from repro_torch.configs import ARCHS, get_arch
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import MESH_DEVICE_COUNT, mesh_for_name, release
from repro_torch.models import SHAPES, cache_specs, get_shape, param_specs
from repro_torch.optim.adamw import opt_state_specs

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESH_AXES = {"single": ("data", "model"), "multi": ("pod", "data", "model"),
             "tiny": ("data", "model"), "tiny-multi": ("pod", "data", "model")}
SHARD_ARCHS = ("stablelm-1.6b", "qwen2-moe-a2.7b")


@pytest.fixture(autouse=True, scope="module")
def _fake_group_released():
    yield
    release()


def _spec_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def test_arch_and_shape_registries_match():
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    assert [s.name for s in SHAPES] == [s.name for s in JAX_SHAPES]
    assert MESH_DEVICE_COUNT["tiny"] == 8 and MESH_DEVICE_COUNT["multi"] == 512


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_spec_trees_equal_jax(arch):
    """param_specs, cache_specs, train_state_specs, opt_state_specs and
    input_spec_names (every shape) equal JAX's, dict by dict (by key)."""
    cfg, jcfg = get_arch(arch), jax_arch(arch)
    for tp in (16, 4, 2, 1):
        assert param_specs(cfg, tp) == jax_param_specs(jcfg, tp)
        assert cache_specs(cfg, tp) == jax_cache_specs(jcfg, tp)
        assert steps.train_state_specs(cfg, tp) == jax_steps.train_state_specs(jcfg, tp)
    pspecs = param_specs(cfg)
    assert opt_state_specs(pspecs) == jax_opt_state_specs(jax_param_specs(jcfg))
    for shape in JAX_SHAPES:
        assert steps.input_spec_names(cfg, get_shape(shape.name)) == \
            jax_steps.input_spec_names(jcfg, shape)


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_abstract_trees_match_jax_shapes(arch):
    """abstract_train_state and input_specs: meta tensors of JAX's shapes
    and dtypes, leaf by leaf (paired by key)."""
    import numpy as np

    cfg, jcfg = get_arch(arch), jax_arch(arch)
    jstate = jax_steps.abstract_train_state(jcfg)
    state = steps.abstract_train_state(cfg)

    def check(port, ref, path=""):
        if isinstance(ref, dict):
            assert set(port) == set(ref), path
            for k in ref:
                check(port[k], ref[k], f"{path}/{k}")
            return
        assert port.device.type == "meta", path
        assert tuple(port.shape) == tuple(ref.shape), path
        assert str(port.dtype).replace("torch.", "") == np.dtype(ref.dtype).name, path

    check(state, jstate)
    for shape in JAX_SHAPES:
        check(steps.input_specs(cfg, get_shape(shape.name)), jax_steps.input_specs(jcfg, shape))


def test_resolve_equals_jax_on_every_mesh():
    rules, jrules = sharding.get_rules(), jax_sharding.get_rules()
    assert rules.rules == jrules.rules
    n = 0
    for arch in sorted(JAX_ARCHS):
        cfg = get_arch(arch)
        trees = (param_specs(cfg), cache_specs(cfg),
                 steps.train_state_specs(cfg, 4), steps.input_spec_names(cfg, get_shape("train_4k")))
        for tree in trees:
            for _, spec in _spec_leaves(tree):
                for axes in MESH_AXES.values():
                    got = rules.resolve(axes, *spec)
                    assert isinstance(got, sharding.PartitionSpec)
                    assert tuple(got) == tuple(jrules.resolve(axes, *spec)), (spec, axes)
                    n += 1
    assert n > 1000
    replaced = rules.replace(seq=None, batch="data")
    assert tuple(replaced.resolve(("pod", "data", "model"), "batch", "seq")) == \
        tuple(jrules.replace(seq=None, batch="data").resolve(("pod", "data", "model"),
                                                            "batch", "seq"))


def test_placements_for_orders_axes_major_first():
    from torch.distributed.tensor import Replicate, Shard

    mesh = mesh_for_name("tiny-multi")
    got = sharding.placements_for(mesh, sharding.P(("pod", "data"), None, "model"), 3)
    assert got == [Shard(0), Shard(0), Shard(2)]
    assert sharding.placements_for(mesh, (None,), 2) == [Replicate()] * 3
    with pytest.raises(ValueError):
        sharding.placements_for(mesh, (("data", "pod"),), 1)
    with pytest.raises(ValueError):
        sharding.placements_for(mesh, ("model", "model"), 2)
    assert sharding.named_sharding(mesh, "batch", None)[1] == [Shard(0), Shard(0), Replicate()]
    assert tuple(sharding.spec_for(mesh, "vocab", "fsdp")) == ("model", ("pod", "data"))


def test_with_logical_redistributes_only_a_dtensor():
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    x = torch.ones(4, 8)
    assert sharding.with_logical(x, "batch", "ff") is x
    mesh = mesh_for_name("tiny")
    d = distribute_tensor(torch.empty(8, 16, device="meta"), mesh, [Replicate(), Replicate()],
                          src_data_rank=None)
    out = sharding.with_logical(d, "batch", "ff")
    assert isinstance(out, DTensor) and out.placements == (Shard(0), Shard(1))
    assert tuple(out.to_local().shape) == (4, 4)


_JAX_SHARD_SHAPES = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, SRC)
import jax
from repro.configs import get_arch
from repro.launch import steps
from repro.launch.dryrun import _resolve_tree
from repro.launch.mesh import mesh_for_name
from repro.models import cache_specs, get_shape, param_specs
out = {}
for arch in ARCHS:
    cfg = get_arch(arch)
    for name in ("tiny", "tiny-multi"):
        mesh = mesh_for_name(name)
        tp = dict(zip(mesh.axis_names, mesh.devices.shape))["model"]
        shape = get_shape("decode_32k")
        trees = {"state": (steps.train_state_specs(cfg, tp), steps.abstract_train_state(cfg)),
                 "cache": (cache_specs(cfg, tp), steps.abstract_cache(cfg, shape))}
        for tname, (specs, avals) in trees.items():
            sh = _resolve_tree(mesh, specs, avals)
            flat, _ = jax.tree_util.tree_flatten_with_path(avals)
            shards = jax.tree.leaves(sh)
            for (path, aval), s in zip(flat, shards):
                key = "/".join([arch, name, tname] + [str(p.key) for p in path])
                out[key] = list(s.shard_shape(aval.shape))
print("SHAPES", json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_shard_shapes():
    code = f"SRC = {SRC!r}\nARCHS = {SHARD_ARCHS!r}\n" + _JAX_SHARD_SHAPES
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(l for l in out.stdout.splitlines() if l.startswith("SHAPES "))
    return json.loads(line[len("SHAPES "):])


@pytest.mark.parametrize("mesh_name", ["tiny", "tiny-multi"])
@pytest.mark.parametrize("arch", SHARD_ARCHS)
def test_local_shard_shapes_equal_jax(jax_shard_shapes, arch, mesh_name):
    """dryrun._resolve_tree's placements give every rank-0 local shard the
    shape JAX's NamedSharding gives after the same pruning."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    cfg = get_arch(arch)
    mesh = mesh_for_name(mesh_name)
    tp = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
    trees = {"state": (steps.train_state_specs(cfg, tp), steps.abstract_train_state(cfg)),
             "cache": (cache_specs(cfg, tp), steps.abstract_cache(cfg, get_shape("decode_32k")))}
    n = 0
    for tname, (specs, avals) in trees.items():
        placements = dryrun._resolve_tree(mesh, specs, avals)
        for path, aval in _spec_leaves(avals):
            pl = placements
            for k in path.strip("/").split("/"):
                pl = pl[k]
            local, _ = compute_local_shape_and_global_offset(aval.shape, mesh, pl)
            key = "/".join([arch, mesh_name, tname]) + path
            assert list(local) == jax_shard_shapes[key], key
            n += 1
    assert n == sum(1 for k in jax_shard_shapes if k.startswith(f"{arch}/{mesh_name}/"))
    sharded = [k for k in jax_shard_shapes if k.startswith(f"{arch}/{mesh_name}/")]
    assert n > 20 and sharded
