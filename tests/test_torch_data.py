"""The port's data pipeline (a copy of repro/data/pipeline.py) gives the JAX
package's batches byte for byte: step by step, after a seek, with frontend
patches, and for a host's shard of the global batch."""
import numpy as np
import pytest

from repro.data import pipeline as jax_pipeline
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.data import pipeline


def _jax_cfg(cfg: DataConfig):
    return jax_pipeline.DataConfig(**cfg.__dict__)


def _same(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("frontend", [0, 5])
def test_batches_equal_jax_step_by_step(frontend):
    cfg = DataConfig(seq_len=24, global_batch=4, vocab=1000, seed=3,
                     frontend_tokens=frontend, d_model=8 if frontend else 0)
    stream = SyntheticLMStream(cfg, start_step=2)
    try:
        for want_step in range(2, 9):
            step, batch = next(stream)
            assert step == want_step
            _same(batch, jax_pipeline._batch_for_step(_jax_cfg(cfg), step, 0, cfg.global_batch))
            _same(batch, pipeline._batch_for_step(cfg, step, 0, cfg.global_batch))
    finally:
        stream.close()
    if frontend:
        assert batch["patches"].shape == (4, frontend, 8)
        assert batch["tokens"].shape == (4, 24 - frontend + 1)


def test_seek_resumes_at_any_step():
    cfg = DataConfig(seq_len=16, global_batch=2, vocab=500, seed=1)
    stream = SyntheticLMStream(cfg)
    try:
        for _ in range(3):
            next(stream)
        stream.seek(40)
        for want_step in (40, 41, 42):
            step, batch = next(stream)
            assert step == want_step
            _same(batch, jax_pipeline._batch_for_step(_jax_cfg(cfg), step, 0, 2))
        stream.seek(1)
        step, batch = next(stream)
        assert step == 1
        _same(batch, jax_pipeline._batch_for_step(_jax_cfg(cfg), 1, 0, 2))
    finally:
        stream.close()


def test_host_shards_tile_the_global_batch():
    cfg = DataConfig(seq_len=12, global_batch=6, vocab=300, seed=2)
    full = jax_pipeline._batch_for_step(_jax_cfg(cfg), 5, 0, 6)["tokens"]
    rows = []
    for pi in range(3):
        stream = SyntheticLMStream(cfg, process_index=pi, process_count=3, start_step=5)
        try:
            step, batch = next(stream)
        finally:
            stream.close()
        assert step == 5 and (stream.lo, stream.hi) == (2 * pi, 2 * pi + 2)
        rows.append(batch["tokens"])
    assert np.concatenate(rows).tobytes() == full.tobytes()
    one = SyntheticLMStream(cfg)  # one process per card by default
    one.close()
    assert (one.lo, one.hi) == (0, 6)
    with pytest.raises(AssertionError):
        SyntheticLMStream(cfg, process_index=0, process_count=4)
