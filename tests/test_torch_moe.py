"""The port's MoE layer against the JAX package's, on the CPU.

Both packages get the same weights (JAX's ``moe_params`` converted leaf for
leaf) and the same inputs, made by numpy from a seed.  Tolerances: 1e-6 for
the float32 router (gates and aux loss; the two sum in other orders), 1e-5
for a float32 layer's output; bfloat16 is held to JAX's jitted
``moe_apply`` bit for bit (each product rounded once, the SiLU op by op, the
combine's adds one rounding each in the order of the stable sort).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import moe as jax_moe
from repro.models import scaled_down as jax_scaled_down
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.models import moe, scaled_down

ROUTER_TOL, F32_TOL = 1e-6, 1e-5
ARCHS = ("qwen2-moe-a2.7b", "llama4-scout-17b-a16e")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _cfgs(arch="qwen2-moe-a2.7b", dtype="float32", **moe_changes):
    """The same scaled config in both packages, its MoE fields changed."""
    jcfg = jax_scaled_down(jax_get_arch(arch), width=64)
    tcfg = scaled_down(get_arch(arch), width=64)
    m = dataclasses.replace(jcfg.moe, **moe_changes)
    return (dataclasses.replace(jcfg, moe=m, dtype=dtype),
            dataclasses.replace(tcfg, moe=m, dtype=dtype))


def _weights(jcfg, seed=2):
    """One layer of JAX's MoE weights as numpy, and the same as the port's."""
    jp = jax.tree.map(lambda a: np.asarray(a[0]), jax_moe.moe_params(jcfg, jax.random.PRNGKey(seed), 1))
    return jp, params_from_jax(jp, "cpu")


def _x(cfg, b=4, s=32, seed=0):
    x = np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if cfg.dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def _jax_keep(experts: np.ndarray, G: int, cap: int) -> np.ndarray:
    """Which (token, rank) slots JAX's sort route keeps: per group, a stable
    sort of the slots by expert, each slot's position within its expert's
    run, kept below ``cap``.  experts: (T, k) -> keep (T, k)."""
    T, k = experts.shape
    keep = np.zeros(T * k, bool)
    for g, flat in enumerate(experts.reshape(G, -1)):
        order = np.argsort(flat, kind="stable")
        se = flat[order]
        pos = np.arange(se.size)
        run_start = {e: int(np.argmax(se == e)) for e in np.unique(se)}
        in_e = pos - np.array([run_start[e] for e in se])
        keep[g * se.size + order] = in_e < cap
    return keep.reshape(T, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_layout_and_byte_exact_conversion(arch):
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    jp = jax.tree.map(np.asarray, jax_moe.moe_params(jcfg, jax.random.PRNGKey(0), 3))
    own = moe.moe_params(tcfg, torch.Generator().manual_seed(0), 3)
    conv = params_from_jax(jp, "cpu")
    leaves = jax.tree_util.tree_leaves_with_path(jp)
    assert {jax.tree_util.keystr(p) for p, _ in leaves} == {
        "['router']", "['w_gate']", "['w_up']", "['w_down']",
        "['shared']['w_gate']", "['shared']['w_up']", "['shared']['w_down']"}
    m = tcfg.moe
    assert own["router"].shape == (3, tcfg.d_model, m.num_experts)
    assert own["router"].dtype == torch.float32
    assert own["w_down"].shape == (3, m.num_experts, m.d_ff_expert, tcfg.d_model)
    for path, leaf in leaves:
        mine, got = own, conv
        for key in path:
            mine, got = mine[key.key], got[key.key]
        assert tuple(mine.shape) == tuple(got.shape) == leaf.shape
        assert mine.dtype == got.dtype
        if leaf.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16
            assert _bits(got).tobytes() == leaf.view(np.uint16).tobytes()
        else:
            assert got.numpy().tobytes() == leaf.tobytes()


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _weights(jcfg)
    jx, tx = _x(jcfg)
    jg, je, jaux = jax_moe._route(jx.reshape(-1, jcfg.d_model), jnp.asarray(jp["router"]),
                                  jcfg.moe)
    tg, te, taux = moe._route(tx.reshape(-1, tcfg.d_model), tp["router"], tcfg.moe)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=ROUTER_TOL, rtol=ROUTER_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=ROUTER_TOL, rtol=ROUTER_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("route", ["dense", "sort-g1", "sort-g4", "decode"])
def test_moe_apply_f32_matches_jax_and_drops_the_same_slots(arch, route):
    """capacity_factor 0.5: the sort routes drop slots, the same as JAX's."""
    impl = "dense" if route == "dense" else "sort"
    G = 4 if route == "sort-g4" else 1
    jcfg, tcfg = _cfgs(arch, impl=impl, dispatch_groups=G, capacity_factor=0.5)
    jp, tp = _weights(jcfg)
    jx, tx = _x(jcfg)
    decode = route == "decode"
    want, want_aux = jax_moe.moe_apply(jax.tree.map(jnp.asarray, jp), jx, jcfg, decode=decode)
    got, aux = moe.moe_apply(tp, tx, tcfg, decode=decode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=ROUTER_TOL, rtol=ROUTER_TOL)
    if impl == "sort" and not decode:
        m = tcfg.moe
        T = tx.shape[0] * tx.shape[1]
        cap = int(max(1, round(T // G * m.top_k / m.num_experts * m.capacity_factor)))
        _, je, _ = jax_moe._route(jx.reshape(T, -1), jnp.asarray(jp["router"]), m)
        _, te, _ = moe._route(tx.reshape(T, -1), tp["router"], m)
        _, _, keep = moe._dispatch(tx.reshape(T, -1), te, m, G, cap)
        want_keep = _jax_keep(np.asarray(je), G, cap)
        assert not want_keep.all()  # the capacity drops slots
        np.testing.assert_array_equal(keep.reshape(T, -1).numpy(), want_keep)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("route", ["dense", "sort-g1", "sort-g32", "decode"])
def test_moe_apply_bf16_equals_jitted_jax_bitwise(arch, route):
    impl = "dense" if route == "dense" else "sort"
    G = 32 if route == "sort-g32" else 1
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16", impl=impl, dispatch_groups=G)
    jp, tp = _weights(jcfg)
    jx, tx = _x(jcfg)
    decode = route == "decode"
    want, want_aux = jax.jit(lambda p, x: jax_moe.moe_apply(p, x, jcfg, decode=decode))(jp, jx)
    got, aux = moe.moe_apply(tp, tx, tcfg, decode=decode)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), np.asarray(want).view(np.uint16))
    np.testing.assert_allclose(float(aux), float(want_aux), atol=ROUTER_TOL, rtol=ROUTER_TOL)


def test_grouped_moe_matches_ungrouped():
    """tests/test_chunked_impls.py's case: at capacity factor 8 nothing
    drops, so 4 dispatch groups give the ungrouped result (bf16, 1e-2)."""
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    _, tp = _weights(jcfg)
    _, tx = _x(tcfg, b=4, s=16, seed=3)
    hi = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=8.0,
                                                           dispatch_groups=1))
    grp = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=8.0,
                                                            dispatch_groups=4))
    y1, _ = moe.moe_apply(tp, tx, hi)
    y2, _ = moe.moe_apply(tp, tx, grp)
    np.testing.assert_allclose(y1.float().numpy(), y2.float().numpy(), atol=1e-2)


def test_group_count_must_divide_the_tokens():
    jcfg, tcfg = _cfgs(dispatch_groups=32)
    _, tp = _weights(jcfg)
    _, tx = _x(tcfg, b=1, s=48)
    with pytest.raises(AssertionError):
        moe.moe_apply(tp, tx, tcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_is_deterministic(dtype):
    """Two runs of the sort route give the same bits with torch's
    deterministic algorithms on: the combine gathers, it does not scatter-add."""
    _, tcfg = _cfgs(dtype=dtype, dispatch_groups=4, capacity_factor=0.5)
    p = moe.moe_params(tcfg, torch.Generator().manual_seed(5), 1)
    p = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict) else v[0])
         for k, v in p.items()}
    _, tx = _x(tcfg, seed=6)
    old = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        a, aux_a = moe.moe_apply(p, tx, tcfg)
        b, aux_b = moe.moe_apply(p, tx, tcfg)
    finally:
        torch.use_deterministic_algorithms(old)
    assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    assert torch.equal(aux_a, aux_b)
