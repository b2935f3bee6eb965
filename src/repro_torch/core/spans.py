"""Profiler ranges at the EasyCrash runtime's layer boundaries.

Each range is a ``torch.profiler.record_function`` range named
``easycrash.<name>``.  Under ``torch.profiler.profile`` it lands in the trace
on the same timeline as the kernels and copies issued inside it, so an idle
stretch of the device can be put down to the step of a flush or restore the
host was in.  With no profiler active a range costs one dispatcher call.  A
range that names a ``ManagerStats`` field also adds its host seconds there,
so the counter and the trace time the same interval.

The ranges (children nest in their parents):

* ``flush`` ⊃ ``flush.mask`` (``mask_seconds``), ``flush.to_host``
  (``copy_seconds``), ``arena.flush`` (``arena_seconds``) ⊃ ``arena.mix``,
  ``arena.persist``; then ``arena.manifest``.  ``arena.mix`` is the write
  of a flush's dirty blocks into the arena's image in place
  (``arena.write_blocks``); a first flush copies the whole image outside it;
* ``restore`` ⊃ ``restore.read`` (``restore_read_seconds``),
  ``restore.to_device`` (``restore_h2d_seconds``), ``restore.shadow``.

The profiler records only the threads it knows: ranges opened on the
manager's writer thread (an async flush) are missing from the trace, though
their counters still add up.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Iterator, Optional

import torch

PREFIX = "easycrash."


@contextlib.contextmanager
def span(name: str, stats: Any = None, field: Optional[str] = None) -> Iterator[None]:
    """The range ``easycrash.<name>``; on leaving it, adds its host seconds to
    ``stats.<field>`` if ``field`` is given."""
    with torch.profiler.record_function(PREFIX + name):
        t0 = time.perf_counter()
        yield
        if field is not None:
            setattr(stats, field, getattr(stats, field) + time.perf_counter() - t0)
