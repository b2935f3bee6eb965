"""The port's decode cells on the three-axis tiny-multi mesh (pod 2 x data
2 x model 2) against JAX's, at one repetition of each layer group
(tests/torch_dryrun_pairs.py): decode_32k for the MoE and recurrent archs
and StableLM-2-1.6B, long_500k (one sequence) for the two recurrent archs,
and the MoE archs' long_500k, which both dry-runs skip.  Each is held to
JAX's dots per device and at most 4 times its collective bytes."""
import pytest

from torch_dryrun_pairs import check_cell, run_pairs

CELLS = [("qwen2-moe-a2.7b", "decode_32k"), ("llama4-scout-17b-a16e", "decode_32k"),
         ("rwkv6-3b", "decode_32k"), ("rwkv6-3b", "long_500k"),
         ("recurrentgemma-9b", "decode_32k"), ("recurrentgemma-9b", "long_500k"),
         ("stablelm-1.6b", "decode_32k")]
SKIPPED = [("qwen2-moe-a2.7b", "long_500k"), ("llama4-scout-17b-a16e", "long_500k")]


@pytest.fixture(scope="module")
def pairs():
    return run_pairs(CELLS + SKIPPED, [CELLS[:3] + SKIPPED, CELLS[3:]], mesh="tiny-multi")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_is_held_to_jax(pairs, arch, shape):
    jax, port = pairs
    key = f"{arch}:{shape}"
    check_cell(key, jax[key], port[key], mesh_gates=True)


@pytest.mark.parametrize("arch,shape", SKIPPED)
def test_cell_jax_skips_is_skipped(pairs, arch, shape):
    jax, port = pairs
    key = f"{arch}:{shape}"
    assert jax[key]["status"] == port[key]["status"] == "skipped"
    assert port[key]["reason"] == jax[key]["reason"]
