"""The port's dry-run on the three-axis tiny-multi mesh (pod 2 x data 2 x
model 2) against JAX's, cell by cell, at one repetition of each layer group
(tests/torch_dryrun_pairs.py): the MoE archs' train_4k and prefill_32k and
StableLM-2-1.6B's train_4k.  The step runs on a two-axis view of the same
ranks whose "data" is the flattened (pod, data) (launch/dryrun.py,
_step_mesh), so DTensor ranks its strategies as on a two-axis mesh; each
cell is held to JAX's FLOPs per device and moves at most 4 times its
collective bytes.  The recurrent and decode cells are in
test_torch_dryrun_multi_{recurrent,decode}.py."""
import pytest

from torch_dryrun_pairs import check_cell, run_pairs

CELLS = [(a, s) for a in ("qwen2-moe-a2.7b", "llama4-scout-17b-a16e")
         for s in ("train_4k", "prefill_32k")]
CELLS.append(("stablelm-1.6b", "train_4k"))


@pytest.fixture(scope="module")
def pairs():
    groups = [[c for c in CELLS if c[0] == a] for a in dict.fromkeys(a for a, _ in CELLS)]
    return run_pairs(CELLS, groups, mesh="tiny-multi")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_is_held_to_jax(pairs, arch, shape):
    jax, port = pairs
    key = f"{arch}:{shape}"
    check_cell(key, jax[key], port[key], mesh_gates=True)


@pytest.mark.parametrize("arch,shape", [c for c in CELLS if c[1] == "train_4k"])
def test_batch_collectives_book_to_pod_and_data(pairs, arch, shape):
    """The flattened axis's collectives are booked to "pod+data", so the
    roofline prices them at the link a group over both dims crosses; no
    collective runs over one of the two alone."""
    _, port = pairs
    dims = port[f"{arch}:{shape}"]["collective_bytes_by_dim"]
    assert dims.get("pod+data", 0) > 0 and set(dims) <= {"pod+data", "model",
                                                        "pod+data+model"}, dims


def test_step_mesh_flattens_pod_and_data():
    """tiny-multi runs the step on a ("data", "model") mesh of the same ranks,
    pod major; a two-axis mesh is left as it is, and so is a three-axis one
    under rules that use "pod" without "data"."""
    import torch

    from repro_torch.distributed.sharding import get_rules, set_rules
    from repro_torch.launch.dryrun import _step_mesh
    from repro_torch.launch.mesh import mesh_for_name, release

    try:
        multi = mesh_for_name("tiny-multi")
        view = _step_mesh(multi)
        assert view.mesh_dim_names == ("data", "model")
        assert torch.equal(view.mesh, torch.arange(8).reshape(4, 2))
        rules = get_rules()
        set_rules(rules.replace(batch="pod"))
        try:
            assert _step_mesh(multi) is multi
        finally:
            set_rules(rules)
        tiny = mesh_for_name("tiny")
        assert _step_mesh(tiny) is tiny
    finally:
        release()
