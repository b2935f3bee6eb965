"""Elastic restore on the port (checkpoint/reshard.py), the counterpart of
test_checkpoint.py's test_elastic_reshard_restores_onto_new_mesh: a tree
saved by the JAX package's save_pytree loads in the port and is placed on
the tiny (data=2, model=4) mesh, a mesh the writer never saw; rank by rank
on the fake process group, each local shard is its slice of the tree."""
import numpy as np
import pytest

from repro.checkpoint import save_pytree as jax_save_pytree
from repro_torch.checkpoint import load_pytree, reshard_restore
from repro_torch.launch.mesh import make_tiny_mesh, release


@pytest.fixture(autouse=True, scope="module")
def _fake_group_released():
    yield
    release()


def test_reshard_restore_gives_each_rank_its_slice(tmp_path):
    from torch.distributed.tensor import DTensor, Replicate

    d = str(tmp_path / "c")
    tree = {"w": np.arange(64, dtype=np.float32).reshape(8, 8),
            "opt": {"count": np.array(3, dtype=np.int32),
                    "b": np.arange(8, dtype=np.float32)}}
    jax_save_pytree(tree, d)
    loaded = load_pytree(d)
    specs = {"w": ("fsdp", "ff"), "opt": {"b": ("ff",), "count": ()}}
    for rank in range(8):
        mesh = make_tiny_mesh(rank=rank)  # (data=2, model=4)
        placed = reshard_restore(loaded, specs, mesh)
        w = placed["w"]
        assert isinstance(w, DTensor)
        assert not all(isinstance(p, Replicate) for p in w.placements)
        data, model = divmod(rank, 4)
        np.testing.assert_array_equal(w.to_local().numpy(),
                                      tree["w"][4 * data:4 * data + 4, 2 * model:2 * model + 2])
        np.testing.assert_array_equal(placed["opt"]["b"].to_local().numpy(),
                                      tree["opt"]["b"][2 * model:2 * model + 2])
        count = placed["opt"]["count"]
        assert all(isinstance(p, Replicate) for p in count.placements)
        assert int(count.to_local()) == 3
        assert tuple(w.shape) == (8, 8)


def test_reshard_restore_pairs_trees_by_key(tmp_path):
    """A spec tree written in another key order pairs by key; a spec tree
    with other keys is refused."""
    mesh = make_tiny_mesh()
    tree = {"a": np.zeros((8, 4), np.float32), "b": np.zeros((4, 8), np.float32)}
    placed = reshard_restore(tree, {"b": (None, "ff"), "a": ("fsdp", None)}, mesh)
    assert tuple(placed["a"].to_local().shape) == (4, 4)
    assert tuple(placed["b"].to_local().shape) == (4, 2)
    with pytest.raises(ValueError):
        reshard_restore(tree, {"a": ("fsdp", None)}, mesh)
