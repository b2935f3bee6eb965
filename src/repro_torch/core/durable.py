# Port copy of repro/core/durable.py, unchanged apart from this header; its relative imports resolve inside repro_torch.
"""Durable file-write primitives shared by every persistence layer.

One protocol, three users (:mod:`~repro.core.arena` backing files,
:mod:`~repro.core.campaign_store` JSONL stores,
:mod:`~repro.core.artifacts` plan artifacts): write the new content to a
temp file, flush+fsync the *data*, atomically rename over the target, then
fsync the *directory* so the rename itself survives power loss.  A rename
without the two fsyncs is only atomic against process crashes: the journal
may commit the rename before the data blocks land, leaving an empty or torn
file behind — unacceptable in a repo whose premise is NVM durability.
"""
from __future__ import annotations

import os


def fsync_dir(path: str) -> None:
    """Persist a directory entry (create/rename durability)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def durable_replace(tmp: str, path: str) -> None:
    """``os.replace(tmp, path)`` whose rename survives power loss.

    The caller must already have flushed+fsynced ``tmp``'s contents.
    """
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))
