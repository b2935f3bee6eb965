"""The port's op counter (launch/op_cost.py) and roofline helpers
(launch/analysis.py): per-device FLOPs of a sharded product counted on the
local shards, collective wire bytes, and the analytic parameter and model
FLOP counts, each against the JAX package's."""
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_arch as jax_arch
from repro.launch import analysis as jax_analysis
from repro.launch import hlo_cost
from repro.models import SHAPES as JAX_SHAPES
from repro_torch.configs import get_arch
from repro_torch.launch import analysis, op_cost
from repro_torch.launch.mesh import make_h100_mesh, mesh_for_name, release
from repro_torch.models import get_shape


@pytest.fixture(autouse=True, scope="module")
def _fake_group_released():
    yield
    release()


def _count(mesh, fn):
    from torch.distributed.tensor.experimental import implicit_replication

    counter = op_cost.OpCounter(mesh, "meta")
    with counter, implicit_replication():
        fn()
    return counter.cost


def test_sharded_matmul_counts_global_over_eight():
    """64x128x1024 @ 1024x4096 sharded [Shard(0), Shard(1)] on (2, 4): each
    device computes exactly an eighth of the product."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode

    mesh = mesh_for_name("tiny")
    x = distribute_tensor(torch.empty(64, 128, 1024, device="meta"), mesh,
                          [Shard(0), Replicate()], src_data_rank=None)
    w = distribute_tensor(torch.empty(1024, 4096, device="meta"), mesh,
                          [Replicate(), Shard(1)], src_data_rank=None)
    total = 2.0 * 64 * 128 * 1024 * 4096
    cost = _count(mesh, lambda: x @ w)
    assert cost.flops == total / 8
    assert cost.collective_bytes == 0.0 and cost.n_collectives == 0
    # inputs read and output written once, on the local shards
    assert cost.bytes_accessed == 4 * (32 * 128 * 1024 + 1024 * 1024 + 32 * 128 * 1024)
    with FlopCounterMode(display=False) as fc:  # counted above DTensor: the global op
        x @ w
    assert fc.get_total_flops() == total


def test_partial_product_counts_an_all_reduce_over_model():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = mesh_for_name("tiny")
    a = distribute_tensor(torch.empty(16, 256, device="meta"), mesh, [Replicate(), Shard(1)],
                          src_data_rank=None)
    b = distribute_tensor(torch.empty(256, 32, device="meta"), mesh, [Replicate(), Shard(0)],
                          src_data_rank=None)
    cost = _count(mesh, lambda: (a @ b).redistribute(mesh, [Replicate(), Replicate()]))
    assert cost.flops == 2.0 * 16 * 32 * 256 / 4
    want = hlo_cost._collective_wire_bytes("all-reduce", 16 * 32 * 4, 4)
    assert cost.collective_breakdown == {"all-reduce": want}
    assert cost.collective_bytes_by_dim == {"model": want}
    assert cost.n_collectives == 1
    terms = analysis.roofline_from_counts(cost, 8, 0.0, mesh)
    assert terms.collective_s == want / analysis.NVLINK_BW  # 8 ranks: one node
    assert terms.compute_s == cost.flops / analysis.PEAK_FLOPS
    assert terms.memory_s == cost.bytes_accessed / analysis.HBM_BW


def test_production_mesh_links():
    """On 256 devices a 16-rank model group spans two 8-GPU nodes and a
    data group (stride 16) sixteen: both take the network's rate."""
    mesh = mesh_for_name("single")
    assert analysis.link_bandwidth(mesh, "model") == analysis.NETWORK_BW
    assert analysis.link_bandwidth(mesh, "data") == analysis.NETWORK_BW
    tiny = mesh_for_name("tiny-multi")
    assert analysis.link_bandwidth(tiny, "pod+data") == analysis.NVLINK_BW


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_collective_wire_bytes_equal_hlo_cost(kind):
    for g in (1, 2, 8, 16):
        for nbytes in (0, 64, 12345, 1 << 30):
            assert op_cost._collective_wire_bytes(kind, nbytes, g) == \
                hlo_cost._collective_wire_bytes(kind, nbytes, g)


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_param_counts_and_model_flops_equal_jax(arch):
    cfg, jcfg = get_arch(arch), jax_arch(arch)
    assert analysis.param_counts(cfg) == jax_analysis.param_counts(jcfg)
    for shape in JAX_SHAPES:
        assert analysis.model_flops_for(cfg, get_shape(shape.name)) == \
            jax_analysis.model_flops_for(jcfg, shape)


def test_data_sheet_constants_are_the_h100s():
    assert analysis.PEAK_FLOPS == 989.4e12 and analysis.HBM_BW == 3.35e12
    assert analysis.NVLINK_BW == 450e9 and analysis.NETWORK_BW == 50e9
    assert not hasattr(analysis, "ICI_BW")
    assert set(analysis.RooflineTerms.__dataclass_fields__) == \
        set(jax_analysis.RooflineTerms.__dataclass_fields__)


def test_h100_mesh_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_h100_mesh()
