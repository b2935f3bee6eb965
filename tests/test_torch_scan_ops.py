"""The model kernels as torch.library custom ops (repro_torch::rwkv6_scan,
::rglru_scan, ::flash_attention, and the plain versions' ::rwkv6_scan_ref
and ::rglru_scan_ref with their backward ops): each op on the CPU gives
its plain version's bits; its fake gives its outputs' shapes and dtypes;
split over batch or heads (channels) and put back together it gives the
whole call's bits, the premise of its sharding rule; on a DTensor over the
fake tiny mesh it runs per shard with the rule's local shapes and no
collective; the op counter counts it by its rule in launch/op_cost.py.
The plain versions' backward ops are held to autograd through the token
loop.  Also the MoE router's scatter_reduce rule, and the sharding
helpers the dry-run's decode uses."""
import numpy as np
import pytest
import torch

from repro_torch.distributed import sharding
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_reference
from repro_torch.kernels.rglru_scan import ops as rglru_ops
from repro_torch.kernels.rglru_scan.ref import rglru_reference
from repro_torch.kernels.rwkv6_scan import ops as rwkv_ops
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_reference
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import mesh_for_name, release

OPS = torch.ops.repro_torch
B, S, H, D = 4, 32, 8, 16


@pytest.fixture(autouse=True, scope="module")
def _fake_group_released():
    yield
    release()


def _rwkv_inputs(seed=0, b=B, s=S, h=H, d=D):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.5, 1.0, (b, s, h, d)).astype(np.float32)
    u = rng.standard_normal((h, d)).astype(np.float32)
    return [torch.from_numpy(x) for x in (r, k, v, w, u)]


def _rglru_inputs(seed=0, b=B, t=S, d=64):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (b, t, d)).astype(np.float32)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(x)


def _qkv(seed=0, b=B, s=S, h=H, d=64):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
            for _ in range(3)]


def _rwkv_plain(r, k, v, w, u):
    y, S_ = rwkv6_reference(*(x.transpose(1, 2) for x in (r, k, v, w)), u, return_state=True)
    return y.transpose(1, 2), S_


def _flash_plain(q, k, v, window=0):
    return attention_reference(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               causal=True, window=window or None).transpose(1, 2)


# the ops on the CPU: the plain version's bits ---------------------------------
@pytest.mark.parametrize("op", ["rwkv6_scan", "rwkv6_scan_ref"])
def test_rwkv_ops_give_the_plain_bits(op):
    r, k, v, w, u = _rwkv_inputs(1)
    y, S_ = getattr(OPS, op)(r, k, v, w, u, True)
    want_y, want_S = _rwkv_plain(r, k, v, w, u)
    assert torch.equal(y, want_y) and torch.equal(S_, want_S)
    y0, S0 = getattr(OPS, op)(r, k, v, w, u, False)
    assert torch.equal(y0, want_y) and tuple(S0.shape) == (B, H, 0, 0)


@pytest.mark.parametrize("op", ["rglru_scan", "rglru_scan_ref"])
def test_rglru_ops_give_the_plain_bits(op):
    a, x = _rglru_inputs(2)
    assert torch.equal(getattr(OPS, op)(a, x), rglru_reference(a, x))


@pytest.mark.parametrize("window", [0, 8])
def test_flash_op_gives_the_plain_bits(window):
    q, k, v = _qkv(3)
    assert torch.equal(OPS.flash_attention(q, k, v, True, window, 32),
                       _flash_plain(q, k, v, window))


def test_wrappers_launch_nothing_on_the_cpu():
    before = (rwkv_ops.rwkv6_scan.launches, rglru_ops.rglru_scan.launches,
              flash_attention.launches)
    rwkv_ops.rwkv6_scan(*_rwkv_inputs(4), return_state=True)
    rglru_ops.rglru_scan(*_rglru_inputs(4))
    flash_attention(*_qkv(4))
    assert before == (rwkv_ops.rwkv6_scan.launches, rglru_ops.rglru_scan.launches,
                      flash_attention.launches)


# the fakes: the real outputs' shapes and dtypes ---------------------------------
def _calls():
    r, k, v, w, u = _rwkv_inputs(5)
    a, x = _rglru_inputs(5)
    q, kk, vv = _qkv(5)
    dy = torch.ones_like(r)
    return {
        "rwkv6_scan": (r, k, v, w, u, True),
        "rwkv6_scan_ref": (r, k, v, w, u, False),
        "rwkv6_scan_ref_backward": (r, k, v, w, u, dy, torch.ones(B, H, D, D)),
        "rglru_scan": (a, x),
        "rglru_scan_ref": (a, x),
        "rglru_scan_ref_backward": (a, x, torch.ones_like(a)),
        "flash_attention": (q, kk, vv, True, 0, 32),
    }


@pytest.mark.parametrize("op", sorted(_calls()))
def test_fake_gives_the_outputs_shapes_and_dtypes(op):
    from torch._subclasses.fake_tensor import FakeTensorMode

    args = _calls()[op]
    real = getattr(OPS, op)(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = getattr(OPS, op)(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                                  for a in args))
    meta = getattr(OPS, op)(*(a.to("meta") if isinstance(a, torch.Tensor) else a
                              for a in args))
    real, fake, meta = ([t] if isinstance(t, torch.Tensor) else list(t)
                        for t in (real, fake, meta))
    assert [(t.shape, t.dtype) for t in real] == [(t.shape, t.dtype) for t in fake]
    assert [(t.shape, t.dtype) for t in real] == [(t.shape, t.dtype) for t in meta]
    assert all(t.device.type == "meta" for t in meta)


# the sharding premise: split, run, put back = the whole call -------------------
@pytest.mark.parametrize("dim", [0, 2])
def test_rwkv_op_on_shards_is_the_whole_call(dim):
    r, k, v, w, u = _rwkv_inputs(6)
    y, S_ = OPS.rwkv6_scan(r, k, v, w, u, True)
    parts = [OPS.rwkv6_scan(*(x.chunk(2, dim)[i] for x in (r, k, v, w)),
                            u.chunk(2, 0)[i] if dim == 2 else u, True) for i in range(2)]
    assert torch.equal(torch.cat([p[0] for p in parts], dim), y)
    assert torch.equal(torch.cat([p[1] for p in parts], 0 if dim == 0 else 1), S_)


@pytest.mark.parametrize("dim", [0, 2])
def test_rglru_op_on_shards_is_the_whole_call(dim):
    a, x = _rglru_inputs(7)
    parts = [OPS.rglru_scan(a.chunk(2, dim)[i], x.chunk(2, dim)[i]) for i in range(2)]
    assert torch.equal(torch.cat(parts, dim), OPS.rglru_scan(a, x))


@pytest.mark.parametrize("dim", [0, 2])
def test_flash_op_on_shards_is_the_whole_call(dim):
    q, k, v = _qkv(8)
    parts = [OPS.flash_attention(q.chunk(2, dim)[i], k.chunk(2, dim)[i], v.chunk(2, dim)[i],
                                 True, 0, 32) for i in range(2)]
    assert torch.equal(torch.cat(parts, dim), OPS.flash_attention(q, k, v, True, 0, 32))


# on DTensors over the fake tiny mesh (data 2 x model 4) -------------------------
def _dtensor(shape, placements, mesh, dtype=torch.float32):
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    local, _ = compute_local_shape_and_global_offset(shape, mesh, placements)
    return DTensor.from_local(torch.empty(local, dtype=dtype, device="meta"), mesh,
                              placements, run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _counted(mesh, fn):
    from torch.distributed.tensor.experimental import implicit_replication

    counter = op_cost.OpCounter(mesh, "meta")
    with counter, implicit_replication():
        out = fn()
    return out, counter.cost


def test_ops_on_dtensors_run_per_shard_by_the_rules():
    """Batch on "data", heads (channels) on "model": each op runs on its
    local shards, with the rule's local shapes, no collective, and the
    FLOPs of its rule on the local shard."""
    from torch.distributed.tensor import Replicate, Shard

    sharding.register_op_strategies()
    mesh = mesh_for_name("tiny")
    b, s, h, d = 4, 64, 8, 64
    bhd = [Shard(0), Shard(2)]
    r, k, v, w = (_dtensor((b, s, h, d), bhd, mesh) for _ in range(4))
    u = _dtensor((h, d), [Replicate(), Shard(0)], mesh)
    (y, S_), cost = _counted(mesh, lambda: rwkv_ops.rwkv6_scan(r, k, v, w, u,
                                                               return_state=True))
    assert tuple(y.to_local().shape) == (2, s, 2, d) and tuple(y.placements) == tuple(bhd)
    assert tuple(S_.to_local().shape) == (2, 2, d, d)
    assert cost.collective_bytes == 0 and cost.flops == 2.0 * 2 * s * 2 * d * d
    y, cost = _counted(mesh, lambda: rwkv_ops.rwkv6_scan_reference(r, k, v, w, u))
    assert tuple(y.to_local().shape) == (2, s, 2, d) and cost.collective_bytes == 0
    a, x = (_dtensor((b, s, 256), [Shard(0), Shard(2)], mesh) for _ in range(2))
    hh, cost = _counted(mesh, lambda: rglru_ops.rglru_scan(a, x))
    assert tuple(hh.to_local().shape) == (2, s, 64)
    assert cost.collective_bytes == 0 and cost.flops == 0
    hh, cost = _counted(mesh, lambda: rglru_ops.rglru_scan_reference(a, x))
    assert tuple(hh.to_local().shape) == (2, s, 64) and cost.collective_bytes == 0
    q, kk, vv = (_dtensor((b, s, h, d), bhd, mesh, torch.bfloat16) for _ in range(3))
    out, cost = _counted(mesh, lambda: flash_attention(q, kk, vv, window=16))
    assert tuple(out.to_local().shape) == (2, s, 2, d) and cost.collective_bytes == 0
    pairs = 16 * 17 / 2 + (s - 16) * 16
    assert cost.flops == 4.0 * 2 * 2 * d * pairs


def test_plain_version_backward_on_dtensors_is_one_op_per_scan():
    """The train step's backward through a scan on DTensors: one backward
    op per scan, split as the forward, counted at twice its dot."""
    from torch.distributed.tensor import Replicate, Shard

    sharding.register_op_strategies()
    mesh = mesh_for_name("tiny")
    b, s, h, d = 4, 64, 8, 16
    bhd = [Shard(0), Shard(2)]
    r, k, v, w = (_dtensor((b, s, h, d), bhd, mesh).requires_grad_(True) for _ in range(4))
    u = _dtensor((h, d), [Replicate(), Shard(0)], mesh).requires_grad_(True)
    y, cost_f = _counted(mesh, lambda: rwkv_ops.rwkv6_scan_reference(r, k, v, w, u))
    grads, cost_b = _counted(mesh, lambda: torch.autograd.grad(y.sum(), (r, k, v, w, u)))
    assert tuple(grads[0].to_local().shape) == (2, s, 2, d)
    assert tuple(grads[4].shape) == (h, d)
    assert cost_b.flops >= 2 * cost_f.flops == 2 * 2.0 * 2 * s * 2 * d * d


def test_scatter_reduce_rule_keeps_the_groups_split():
    """The router's run starts: (G, E) scatter_reduce along the experts, the
    groups split over "data", run per shard with no collective."""
    from torch.distributed.tensor import Replicate, Shard

    sharding.register_op_strategies()
    mesh = mesh_for_name("tiny")
    se = _dtensor((8, 96), [Shard(0), Replicate()], mesh, torch.int64)
    pos = _dtensor((8, 96), [Shard(0), Replicate()], mesh, torch.int64)
    base = _dtensor((8, 12), [Shard(0), Replicate()], mesh, torch.int64)
    out, cost = _counted(mesh, lambda: base.scatter_reduce(1, se, pos, "amin"))
    assert tuple(out.to_local().shape) == (4, 12) and cost.collective_bytes == 0


def test_op_counter_counts_each_op_by_its_rule():
    mesh = mesh_for_name("tiny")
    r, k, v, w, u = (x.to("meta") for x in _rwkv_inputs(9))
    a, x = (t.to("meta") for t in _rglru_inputs(9))
    q, kk, vv = (t.to("meta") for t in _qkv(9))
    _, cost = _counted(mesh, lambda: OPS.rwkv6_scan(r, k, v, w, u, False))
    assert cost.flops == 2.0 * B * S * H * D * D
    _, cost = _counted(mesh, lambda: OPS.rwkv6_scan_ref_backward(r, k, v, w, u, r, None))
    assert cost.flops == 4.0 * B * S * H * D * D
    _, cost = _counted(mesh, lambda: OPS.rglru_scan_ref(a, x))
    assert cost.flops == 0 and cost.bytes_accessed == 3 * a.numel() * 4
    _, cost = _counted(mesh, lambda: OPS.flash_attention(q, kk, vv, True, 0, 32))
    assert cost.flops == 4.0 * B * H * 64 * S * (S + 1) / 2
    assert cost.bytes_accessed == 4 * q.numel() * 4


# the plain versions' backward ------------------------------------------------------
def test_rglru_backward_is_autograd_through_the_loop_bitwise():
    a, x = _rglru_inputs(10)
    g = torch.from_numpy(np.random.default_rng(10).standard_normal(a.shape).astype(np.float32))

    def grads(fn):
        ins = [a.clone().requires_grad_(True), x.clone().requires_grad_(True)]
        return torch.autograd.grad((fn(*ins) * g).sum(), ins)

    for got, want in zip(grads(rglru_ops.rglru_scan_reference), grads(rglru_reference)):
        assert torch.equal(got, want)


def test_rwkv_backward_matches_autograd_through_the_loop():
    """The reverse scan sums in another order than autograd's graph of the
    token loop: f32, held to 1e-5 relative to the largest gradient."""
    ins0 = _rwkv_inputs(11)
    rng = np.random.default_rng(11)
    gy = torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(np.float32))
    gS = torch.from_numpy(rng.standard_normal((B, H, D, D)).astype(np.float32))

    def grads(fn):
        ins = [t.clone().requires_grad_(True) for t in ins0]
        y, S_ = fn(ins)
        return torch.autograd.grad((y * gy).sum() + (S_ * gS).sum(), ins)

    got = grads(lambda t: rwkv_ops.rwkv6_scan_reference(*t, return_state=True))
    want = grads(lambda t: _rwkv_plain(*t))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * float(b.abs().max()))


# the sharding helpers the decode step uses ----------------------------------------
def test_with_logical_replicates_a_dim_its_axes_do_not_divide():
    from torch.distributed.tensor import Replicate, Shard

    mesh = mesh_for_name("tiny")
    one = _dtensor((1, 8, 64), [Replicate(), Replicate()], mesh)
    assert tuple(sharding.with_logical(one, "batch", None, "heads").placements) == (
        Replicate(), Shard(2))
    two = _dtensor((2, 8, 64), [Replicate(), Replicate()], mesh)
    assert tuple(sharding.with_logical(two, "batch", None, "heads").placements) == (
        Shard(0), Shard(2))


def test_gathered_and_is_sharded():
    from torch.distributed.tensor import Replicate, Shard

    mesh = mesh_for_name("tiny")
    x = _dtensor((4, 1024), [Shard(0), Shard(1)], mesh)
    assert sharding.is_sharded(x, 1) and sharding.is_sharded(x, -1)
    g = sharding.gathered(x, -1)
    assert tuple(g.placements) == (Shard(0), Replicate()) and not sharding.is_sharded(g, 1)
    plain = torch.zeros(2, 3)
    assert sharding.gathered(plain, 1) is plain and not sharding.is_sharded(plain, 0)


def test_head_views_gather_a_split_that_cuts_a_head():
    """6 heads of 16 over the 4-way "model" axis: a q view refuses the
    split (the heads are padded to the split instead, as XLA pads them)
    and a kv view (gather=True: kv heads are never padded) gathers the last
    dim first; the 6 heads padded to 8 (models/padding.py) stay split, 2
    to a shard, their zero heads where pad_heads put them, and the
    backward views the gradient back through the same placements; a plain
    tensor is reshaped as it is."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.padding import pad_heads

    mesh = mesh_for_name("tiny")
    x = _dtensor((4, 8, 96), [Shard(0), Shard(2)], mesh)
    with pytest.raises(ValueError, match="6 heads split 4 ways"):
        sharding.heads_split(x, 6, 16)
    assert tuple(sharding.heads_split(x, 6, 16, gather=True).placements) == (
        Shard(0), Replicate())
    full = torch.arange(4 * 8 * 96, dtype=torch.float32).reshape(4, 8, 96) + 1
    padded = pad_heads(full, -1, 1, 6, 8)
    assert tuple(padded.shape) == (4, 8, 128)
    assert torch.equal(padded[..., :96], full) and not padded[..., 96:].any()
    x8 = _dtensor((4, 8, 128), [Shard(0), Shard(2)], mesh).requires_grad_(True)
    with implicit_replication():
        h = sharding.heads_split(x8, 8, 16)
        assert tuple(h.placements) == (Shard(0), Shard(2))
        y = sharding.heads_merged(h * 2)
        (g,) = torch.autograd.grad(y.sum(), x8)
    assert tuple(y.shape) == (4, 8, 128) and tuple(g.placements) == (Shard(0), Shard(2))
    plain = torch.arange(96.0).reshape(1, 1, 96)
    assert torch.equal(sharding.heads_split(plain, 6, 16), plain.reshape(1, 1, 6, 16))
    assert torch.equal(sharding.heads_merged(plain.reshape(1, 1, 6, 16)), plain)
