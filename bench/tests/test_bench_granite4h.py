"""The granite-4.0-h-micro cell's own parts at small shapes: the counts
against sums written out by hand, the weights' tree against the port's,
the traffic as the cell states it, and the output check failing a run
whose decode leaves the Mamba-2 state as it was or whose arena image is
altered."""
import numpy as np
import pytest
import torch
from _tiny import harness, run_tiny, tiny

from bench.counts import granite4h as counts

CELL = "granite-4.0-h-micro-decode16k-flush8"

SMALL = {"hidden_size": 8, "num_attention_heads": 2, "num_key_value_heads": 1,
         "shared_intermediate_size": 16, "vocab_size": 10, "mamba_n_heads": 2,
         "mamba_d_head": 8, "mamba_d_state": 4, "mamba_n_groups": 1, "mamba_d_conv": 4,
         "layer_types": ["mamba", "attention", "mamba"]}


def test_weight_bytes_by_hand():
    # mamba: in_proj 8 x (2*16 + 2*4 + 2) = 336, conv 24 x 4 = 96, conv_b 24, norm 16,
    # out_proj 16 x 8 = 128 -> 600 bf16 and 3 x 2 float32 (A_log, dt_bias, D)
    # attn: q, o 8 x 8 each, k, v 8 x 4 each -> 192 bf16
    # every layer: 2 norms of 8 and 3 x 8 x 16 -> 400 bf16; embed 80 and final norm 8
    want = 2 * (2 * 600 + 192 + 3 * 400 + 88) + 2 * 3 * 2 * 4
    assert counts.weight_bytes(SMALL) == want == 5408


def test_decode_step_counts_by_hand():
    ops, nbytes = counts.decode_step_counts(SMALL, batch=3, length=5)
    mamba = 2 * 8 * 42 + 2 * 24 * 4 + 5 * 2 * 8 * 4 + 2 * 16 * 8     # 1440
    attn = 2 * 8 * 4 * 4 + 2 * 8 * 8 + 4 * 2 * 4 * 5                 # 544
    mlp, logits = 6 * 8 * 16, 2 * 8 * 10                               # 768, 160
    assert ops == 3 * (2 * mamba + attn + 3 * mlp + logits) == 17664
    state = 2 * 3 * (2 * 64 * 4 + 2 * 24 * 3 * 2)                    # ssm f32, conv bf16
    kv = 3 * 2 * 4 * 2 * 6                                             # K and V to 5, new one
    assert nbytes == 5408 + state + kv + 3 * 10 * 2 == 5408 + 4800 + 288 + 60
    bound = counts.decode_step_bound_s(SMALL, 3, 5)
    assert bound == pytest.approx(max(17664 / 989.4e12, 10556 / 3.35e12))


def test_ssm_update_bytes_by_hand():
    # state 2 x 2*3*4*5, x and y 2 x 2*3*4, dt 2*3, A and D 2 x 3, B and C 2 x 2*1*5
    assert counts.ssm_update_bytes(2, 3, 4, 5, 1) == 4 * (240 + 48 + 6 + 6 + 20) == 1280
    assert counts.ssm_update_bound_s(SMALL, 3) == pytest.approx(
        counts.ssm_update_bytes(3, 2, 8, 4, 1) / 3.35e12)


def test_published_config_counts():
    cfg = harness.load_json(harness.HERE / "configs" / "granite-4.0-h-micro.json")
    # about 3.19 B parameters, 6.4 GB in bf16
    assert 6.3e9 < counts.weight_bytes(cfg) < 6.5e9
    # weights, the Mamba-2 state read and written (2 x 2.42 GB), K and V at 16k (4.3 GB)
    _, nbytes = counts.decode_step_counts(cfg, 32, 16385)
    assert 6.3e9 + 4.8e9 + 4.2e9 < nbytes < 6.5e9 + 4.9e9 + 4.4e9


def test_weights_take_the_ports_tree():
    from repro_torch.models import init_params

    from bench.inputs import granite4h as inputs

    cfg_json, _ = tiny(CELL)
    cfg = inputs.port_config(cfg_json)
    got = inputs.make_weights(cfg, cfg_json, 7, "cpu")
    want = init_params(cfg, torch.Generator().manual_seed(0))

    def shapes(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(shapes(v, f"{prefix}{k}/"))
            else:
                out[prefix + k] = (tuple(v.shape), v.dtype)
        return out

    assert shapes(got) == shapes(want)
    again = inputs.make_weights(cfg, cfg_json, 7, "cpu")
    assert torch.equal(got["group0"]["pos0"]["mamba"]["in_proj"],
                       again["group0"]["pos0"]["mamba"]["in_proj"])
    assert len(inputs.layer_views(cfg, got)["layers"]) == cfg.n_layers


def test_traffic_is_the_cells():
    w = harness.workload(harness.load_spec(), CELL)
    tr = harness.load_json(harness.HERE / "traffic" / f"{w['traffic']}.json")
    assert (tr["sessions"], tr["context"], tr["extra_positions"]) == (32, 16384, 4096)
    assert (tr["flush_every"], tr["warm_steps"], tr["trace_units"], tr["restore_reps"],
            tr["check_sessions"]) == (8, 8, 8, 8, 2)
    assert tr["flush_leaves"] == ["cache", "tokens"] and tr["persist_mode"] == "delta"
    cfg = harness.load_json(harness.HERE / "configs" / f"{w['config']}.json")
    assert cfg["reduced"] == [] and cfg["num_hidden_layers"] == len(cfg["layer_types"]) == 40


def _failed(*names):
    out = run_tiny(CELL)
    assert not out["correct"], out["checks"]
    failed = {c.name for c in out["_checks"] if not c.ok}
    assert failed & set(names), (failed, names)


def test_decode_that_leaves_the_state_unchanged_fails(monkeypatch):
    from repro_torch.kernels.ssm_update import ops

    orig = ops.ssm_update_reference
    monkeypatch.setattr(ops, "ssm_update_reference", lambda h, *a: orig(h.clone(), *a))
    _failed("state_gap", "logit_gap")


def test_arena_image_altered_fails(monkeypatch):
    from repro_torch.core.arena import NVMArena

    orig = NVMArena.flush

    def flush(self, name, live, dirty_resident_mask=None):
        n = orig(self, name, live, dirty_resident_mask)
        if name.endswith("ssm"):  # one byte of the image off the flushed one
            img = self._store[name].reshape(-1).view("uint8")
            img[5] = np.asarray(live).reshape(-1).view("uint8")[5] ^ 1
        return n

    monkeypatch.setattr(NVMArena, "flush", flush)
    _failed("image_bytes_differ", "restore_bytes_differ")


def test_a_run_past_the_capacity_fails_loudly():
    cfg, tr = tiny(CELL)
    with pytest.raises(RuntimeError, match="capacity"):
        harness.run_cell(CELL, 1, 60.0, False, device="cpu", config=cfg,
                         traffic=dict(tr, extra_positions=12))
