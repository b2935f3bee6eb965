"""The port's dry-run of the recurrent archs on the three-axis tiny-multi
mesh (pod 2 x data 2 x model 2) against JAX's, cell by cell, at one
repetition of each layer group (tests/torch_dryrun_pairs.py): RWKV6-3B's
and RecurrentGemma-9B's train_4k and prefill_32k, each held to JAX's FLOPs
per device and at most 4 times its collective bytes (on the old greedy
ranking RWKV6-3B's prefill moved 14 times JAX's).  The MoE cells are in
test_torch_dryrun_multi.py, the decode cells in
test_torch_dryrun_multi_decode.py."""
import pytest

from torch_dryrun_pairs import check_cell, run_pairs

ARCHS = ("rwkv6-3b", "recurrentgemma-9b")
CELLS = [(a, s) for a in ARCHS for s in ("train_4k", "prefill_32k")]


@pytest.fixture(scope="module")
def pairs():
    return run_pairs(CELLS, [[c for c in CELLS if c[0] == a] for a in ARCHS],
                     mesh="tiny-multi")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_is_held_to_jax(pairs, arch, shape):
    jax, port = pairs
    key = f"{arch}:{shape}"
    check_cell(key, jax[key], port[key], mesh_gates=True)
