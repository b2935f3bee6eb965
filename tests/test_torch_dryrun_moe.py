"""The port's dry-run of the MoE archs against JAX's, cell by cell, on the
tiny mesh at one layer each (tests/torch_dryrun_pairs.py): Qwen1.5-MoE's
expert-sharded group buffers (dispatch_groups 32, experts over "model")
and Llama-4-Scout's, in train_4k and prefill_32k.  Their decode cells are
in test_torch_dryrun_decode.py."""
import pytest

from torch_dryrun_pairs import check_cell, run_pairs

ARCHS = ("qwen2-moe-a2.7b", "llama4-scout-17b-a16e")
SHAPES = ("train_4k", "prefill_32k")
CELLS = [(a, s) for a in ARCHS for s in SHAPES]


@pytest.fixture(scope="module")
def pairs():
    return run_pairs(CELLS, [[c for c in CELLS if c[0] == a] for a in ARCHS])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_is_held_to_jax(pairs, arch, shape):
    jax, port = pairs
    key = f"{arch}:{shape}"
    check_cell(key, jax[key], port[key])


def test_moe_layer_constrains_at_jax_sites(monkeypatch):
    """On the tiny mesh the sort route's token groups split on "data", its
    capacity buffer on ("data", "model") and the expert hidden state on
    experts ("model") and groups ("data"), as JAX's with_logical sites
    resolve there (expert_ff and experts share "model", and experts come
    first); the layer's output keeps JAX's ("batch", "seq")."""
    import dataclasses

    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import mesh_for_name, release
    from repro_torch.models import moe, scaled_down

    cfg = scaled_down(get_arch("qwen2-moe-a2.7b"), width=64)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=8,
                                                           dispatch_groups=4))
    seen = []
    real = sharding.with_logical

    def recording(x, *names):
        out = real(x, *names)
        seen.append((names, tuple(out.placements)))
        return out

    monkeypatch.setattr(moe, "with_logical", recording)
    sharding.register_op_strategies()
    try:
        mesh = mesh_for_name("tiny")
        p = moe.moe_params(cfg, torch.Generator().manual_seed(0), 1)
        p = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict) else v[0])
             for k, v in p.items()}
        p = {k: ({kk: DTensor.from_local(vv, mesh, [Replicate(), Replicate()])
                  for kk, vv in v.items()} if isinstance(v, dict)
                 else DTensor.from_local(v, mesh, [Replicate(), Replicate()]))
             for k, v in p.items()}
        x = DTensor.from_local(torch.randn(2, 16, 64).to(torch.bfloat16), mesh,
                               [Shard(0), Replicate()], run_check=False)
        with implicit_replication():
            moe.moe_apply(p, x, cfg)
    finally:
        release()
    got = dict(seen)
    assert got[("batch", None)] == (Shard(0), Replicate())                     # token groups
    assert got[("batch", "experts", None, None)] == (Shard(0), Shard(1))       # (G, E, cap, d)
    assert got[("experts", "batch", "expert_ff")] == (Shard(1), Shard(0))      # (E, G*cap, f)
    assert got[("batch", "seq", None)] == (Shard(0), Shard(1))
