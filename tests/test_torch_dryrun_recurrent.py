"""The port's dry-run of the recurrent archs against JAX's, cell by cell,
on the tiny mesh at one repetition of each layer group
(tests/torch_dryrun_pairs.py): RWKV6-3B's scan and RecurrentGemma-9B's
RG-LRU scan each one op per layer, split over batch and heads (channels),
in train_4k (through the plain version's backward) and prefill_32k.
Their decode cells are in test_torch_dryrun_decode.py."""
import pytest

from torch_dryrun_pairs import check_cell, run_pairs

ARCHS = ("rwkv6-3b", "recurrentgemma-9b")
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
