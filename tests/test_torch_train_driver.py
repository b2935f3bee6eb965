"""The port's training driver (repro_torch.launch.train) on the CPU: a run
under injected failures recovers from the NVM arena (EasyCrash), falls back
to the checkpoint when the arena is lost or rejected, and restores exactly
the bytes it flushed; its stats hold the JAX driver's keys."""
import os
import re
import shutil

import numpy as np
import pytest
import torch

from repro_torch.convert import host_array
from repro_torch.core.arena import NVMArena
from repro_torch.core.manager import flatten_state
from repro_torch.launch import train

SMALL = ["--device", "cpu", "--width", "64", "--seq", "32", "--batch", "4"]
#: checkpoints every 8 steps: sqrt(2 * 1 * 6 / (1 - 0.82)) = 8.16
CKPT = ["--mtbf", "6", "--t-chk", "1", "--recomputability", "0.82"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_cli_recovers_from_the_arena(tmp_path, capsys):
    """Every restart restores from the arena.  The flush at the crash step
    may have been skipped (a flush every step outruns the writer thread, and
    beyond max_pending the manager skips), so a restart may resume some steps
    before the crash, and strike the same crash step again."""
    stats = train.main(SMALL + ["--steps", "30", "--inject-failure-every", "14",
                                "--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    crashes = [int(x) for x in re.findall(r"\[failure\] injected failure at step (\d+)", out)]
    restores = re.findall(r"\[restore\] source=(\w+) step=(\d+)", out)
    assert restores[0] == ("fresh", "0") and crashes[:1] == [14], out
    assert len(restores) == len(crashes) + 1 and {14, 28} <= set(crashes), out
    resumed = 0
    for crash, (source, step) in zip(crashes, restores[1:]):
        assert source == "easycrash" and resumed < int(step) <= crash, out
        resumed = int(step)
    assert "'final_step': 30" in out
    assert stats["final_step"] == 30 and stats["restore_source"] == "easycrash"
    assert stats["easycrash_restores"] == 1 and np.isfinite(stats["final_loss"])


def test_arena_lost_or_rejected_falls_back_to_checkpoint(tmp_path, capsys):
    base = SMALL + CKPT + ["--flush-every", "4", "--workdir", str(tmp_path)]
    first = train.main(base + ["--steps", "16"])
    assert first["checkpoints"] == 2 and first["checkpoint_every"] == 8
    assert len(first["checkpoint_save_s"]) == 2 and first["checkpoint_bytes"] > 0
    # the arena lost: the newest checkpoint (16)
    shutil.rmtree(tmp_path / "arena")
    lost = train.main(base + ["--steps", "20"])
    assert (lost["restore_source"], lost["restore_step"]) == ("checkpoint", 16)
    assert lost["final_step"] == 20
    # the arena back (flushed at 20), but verification rejects it
    rejected = train.main(base + ["--steps", "20", "--verify-loss-max", "0"])
    assert (rejected["restore_source"], rejected["restore_step"]) == ("checkpoint", 16)
    out = capsys.readouterr().out
    assert "[verify] step=20" in out and "-> REJECT" in out
    # the local tier lost too: the remote tier
    shutil.rmtree(tmp_path / "arena")
    shutil.rmtree(tmp_path / "ckpt_local")
    remote = train.main(base + ["--steps", "16"])
    assert (remote["restore_source"], remote["restore_step"]) == ("checkpoint", 16)


def test_restored_params_equal_the_last_flushed_image(tmp_path):
    """Every flush lands the bytes it cloned (on the writer thread), and the
    restart after a crash restores the parameters of the last flush, byte
    for byte, with the step it flushed."""
    args = train.parser().parse_args(SMALL + ["--steps", "12", "--flush-every", "3",
                                              "--inject-failure-every", "8",
                                              "--persist-mode", "delta",
                                              "--workdir", str(tmp_path)])
    landed = {}

    def on_flushed(step, payload, arena):
        for name, leaf in payload.items():
            if isinstance(leaf, torch.Tensor):
                assert arena.peek(name).tobytes() == host_array(leaf).tobytes(), name
        landed[step] = {k: host_array(v) for k, v in payload.items()
                        if isinstance(v, torch.Tensor)}

    with pytest.raises(train.SimulatedFailure):
        train.run(args, on_flushed=on_flushed)
    assert sorted(landed) == [3, 6]  # the crash at 8 comes after the flush at 6
    restored = {}

    def on_restore(state, step, source):
        restored.update(step=step, source=source,
                        flat={k: host_array(v) for k, v in flatten_state(state).items()})

    args.inject_failure_every = 0
    stats = train.run(args, on_flushed=on_flushed, on_restore=on_restore)
    assert (restored["source"], restored["step"]) == ("easycrash", 6)
    image = landed[6]
    params = {k: v for k, v in restored["flat"].items() if k.startswith("params/")}
    assert set(params) == {k for k in image if k.startswith("params/")}
    for k, v in params.items():
        assert v.tobytes() == image[k].tobytes(), k
    arena = NVMArena.reattach(str(tmp_path / "arena"))
    assert int(arena.get("__step__")) == 12 == stats["final_step"]
    assert sorted(landed) == [3, 6, 9, 12]
    # the delta flushes after the restore compared against the restored
    # image: each wrote only what changed
    assert stats["flushes"] == 2 and stats["bytes_written"] > 0


def test_stats_hold_the_jax_drivers_keys(tmp_path, monkeypatch):
    from repro.launch import train as jax_train

    argv = ["--width", "64", "--seq", "32", "--batch", "4", "--steps", "2",
            "--flush-every", "1", "--sync-flush"]
    parsed = []  # the JAX launcher's flags: its main() parses, then calls run()
    monkeypatch.setattr(jax_train, "run", parsed.append)
    jax_train.main(argv + ["--workdir", str(tmp_path / "j")])
    monkeypatch.undo()
    want = jax_train.run(parsed[0])
    got = train.main(argv + ["--device", "cpu", "--workdir", str(tmp_path / "p")])
    assert set(want) <= set(got)
    for k in ("final_step", "flushes", "flushes_skipped", "checkpoints", "easycrash_restores",
              "checkpoint_restores", "restore_source"):
        assert got[k] == want[k], k


def test_trainer_raises_without_cuda_unless_told_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--steps", "1", "--width", "64", "--workdir", str(tmp_path)])
    assert train.parser().parse_args([]).device == "cuda"
    assert os.path.basename(train.parser().parse_args([]).workdir) == "repro_torch_train"
