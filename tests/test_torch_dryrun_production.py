"""The port's dry-run on the production meshes against JAX's, cell by cell
(tests/torch_dryrun_pairs.py), where the port used to do more work per
device than JAX's step:

* "single" (data 16 x model 16): Llama-4-Scout's 40 q heads and
  musicgen-medium's 24 do not divide the 16-way "model" axis; the port
  pads them to 48 and 32 (models/padding.py), as XLA pads them, where it
  used to gather them (7.63 and 9.61 times JAX's dots in a prefill).
  Their prefill_32k at one repetition of each layer group; RWKV6-3B's 40
  heads in decode_32k at full depth (at one layer the vocab product hides
  the layers' 4.49 times);
* "multi" (pod 2 x data 16 x model 16): StableLM-2-1.6B's and
  Qwen1.5-MoE-A2.7B's train_4k and RWKV6-3B's prefill_32k at one
  repetition, the step on the (pod·data, model) view (launch/dryrun.py,
  _step_mesh), where greedy strategy ranking made 18, 13 and 2 times
  JAX's FLOPs with 17, 14 and 68 times its collective bytes.

Each cell is held to JAX's FLOPs per device (prefill and decode within
[0.75, 1.25] of its dots, train at most 1.25 times its record) and moves
at most 4 times its collective bytes.  The three comparisons run at once."""
import pytest

from torch_dryrun_pairs import check_cell, finish_pairs, start_pairs

SINGLE_CUT = [("llama4-scout-17b-a16e", "prefill_32k"), ("musicgen-medium", "prefill_32k")]
SINGLE_FULL = [("rwkv6-3b", "decode_32k")]
MULTI_CUT = [("stablelm-1.6b", "train_4k"), ("qwen2-moe-a2.7b", "train_4k"),
             ("rwkv6-3b", "prefill_32k")]
CELLS = ([("single", a, s) for a, s in SINGLE_CUT + SINGLE_FULL]
         + [("multi", a, s) for a, s in MULTI_CUT])


@pytest.fixture(scope="module")
def pairs():
    runs = {
        "single-cut": start_pairs(SINGLE_CUT, [[c] for c in SINGLE_CUT], mesh="single"),
        "single-full": start_pairs(SINGLE_FULL, [SINGLE_FULL], cut=False, mesh="single"),
        "multi-cut": start_pairs(MULTI_CUT, [[c] for c in MULTI_CUT], mesh="multi"),
    }
    out = {"single": ({}, {}), "multi": ({}, {})}
    try:
        for name in list(runs):
            jax, port = finish_pairs(runs.pop(name))
            mesh = name.split("-")[0]
            out[mesh][0].update(jax)
            out[mesh][1].update(port)
    finally:
        for started in runs.values():  # a run left when another failed
            for proc, _, _ in started:
                proc.kill()
                proc.wait()
    return out


@pytest.mark.parametrize("mesh,arch,shape", CELLS)
def test_cell_is_held_to_jax(pairs, mesh, arch, shape):
    jax, port = pairs[mesh]
    key = f"{arch}:{shape}"
    check_cell(key, jax[key], port[key], mesh_gates=True)
