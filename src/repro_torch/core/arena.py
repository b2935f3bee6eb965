# Port copy of repro/core/arena.py; its relative imports resolve inside
# repro_torch.  What differs:
# * flush and writeback_blocks write the masked blocks into the arena's own
#   image in place (write_blocks: the dirty block indices, a (blocks,
#   block_bytes) byte view each side, the partial last block on its own)
#   instead of building a new image with mix_blocks.  The result is
#   mix_blocks' byte for byte, and a peek() view now shows later flushes.
#   So every stored image is the arena's own C-contiguous, writable array:
#   install and a first flush copy in C order, reattach makes what it loads
#   so.  WriteStats.inplace_flushes counts the flushes written in place.
#   With adopt, a first flush keeps the caller's buffer as the image (the
#   manager's page-locked copy of a device leaf) instead of copying it.
# * A delta flush can come without a host copy of the whole leaf:
#   flush_blocks takes the dirty blocks gathered on the device with their
#   indices, rewrite lets the caller write every block of the image in
#   place (a device-to-host copy straight into it).  Both are counted as
#   flush counts its writes.
# * flush's block write, the backing file's rewrite and the manifest's each
#   run in a profiler range (core/spans.py: easycrash.arena.mix,
#   easycrash.arena.persist, easycrash.arena.manifest).
"""NVM arena: the persistent image of application data objects.

The arena emulates NVM-as-main-memory in *app-direct* mode (paper §2.3):
a byte-addressable persistent region that survives crashes.  Two concerns
live here:

* value storage — one numpy array per named data object (the "NVM image"),
  optionally backed by memory-mapped files so a killed process can reattach
  (the memory-mapped-file offset mechanism the paper describes);
* write accounting — every block written back (by eviction, by an explicit
  flush, or by a checkpoint copy) is counted, reproducing the paper's Fig 9
  endurance comparison.  Flushing a clean or non-resident block costs no
  NVM write, which is the asymmetry EasyCrash exploits.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Mapping, Optional

import numpy as np

from .blocks import DEFAULT_BLOCK_BYTES, block_diff_mask, obj_num_blocks
from .durable import durable_replace
from .spans import span


@dataclass
class WriteStats:
    """NVM write counters, in units of blocks."""

    eviction_writes: int = 0     # natural write-backs from the (emulated) cache
    flush_writes: int = 0        # EasyCrash persistence operations
    checkpoint_writes: int = 0   # C/R data copies
    flush_ops: int = 0           # number of persistence operations issued
    flushed_clean_blocks: int = 0  # blocks flushed that caused no write
    inplace_flushes: int = 0     # flushes that wrote blocks into the existing image

    @property
    def total(self) -> int:
        return self.eviction_writes + self.flush_writes + self.checkpoint_writes

    def as_dict(self) -> Dict[str, int]:
        return {
            "eviction_writes": self.eviction_writes,
            "flush_writes": self.flush_writes,
            "checkpoint_writes": self.checkpoint_writes,
            "flush_ops": self.flush_ops,
            "flushed_clean_blocks": self.flushed_clean_blocks,
            "total": self.total,
        }


def write_blocks(
    image: np.ndarray,
    live: np.ndarray,
    block_mask: np.ndarray,
    block_bytes: int = DEFAULT_BLOCK_BYTES,
) -> None:
    """Blockwise ``image[b] = live[b]`` where ``block_mask[b]``, in place.

    Leaves ``image`` equal to ``mix_blocks(image, live, block_mask)`` with
    no whole-image copy: only the masked blocks' bytes move.  ``image`` must
    be C-contiguous and writable, so that its byte view is itself; ``live``
    is read once and not kept.  Raises ``mix_blocks``' ``ValueError`` on a
    shape, dtype or mask-length mismatch.
    """
    live = np.asarray(live)
    if image.shape != live.shape or image.dtype != live.dtype:
        raise ValueError(f"mix_blocks shape/dtype mismatch: {image.shape}/{image.dtype} vs {live.shape}/{live.dtype}")
    nb = obj_num_blocks(image, block_bytes)
    mask = np.asarray(block_mask, dtype=bool)
    if mask.shape != (nb,):
        raise ValueError(f"mask must have {nb} blocks, got {mask.shape}")
    if not (image.flags.c_contiguous and image.flags.writeable):
        raise ValueError("write_blocks needs a C-contiguous, writable image")
    if nb == 0:
        return
    dst = image.reshape(-1).view(np.uint8)
    src = np.ascontiguousarray(live).reshape(-1).view(np.uint8)
    full = dst.size // block_bytes           # blocks of block_bytes bytes
    idx = np.flatnonzero(mask)
    body = idx[: np.searchsorted(idx, full)]  # idx is sorted
    cut = full * block_bytes
    dst[:cut].reshape(full, block_bytes)[body] = src[:cut].reshape(full, block_bytes)[body]
    if full < nb and mask[full]:  # the partial last block
        dst[cut:] = src[cut:]


class NVMArena:
    """Persistent store for named data objects at block granularity."""

    def __init__(
        self,
        block_bytes: int = DEFAULT_BLOCK_BYTES,
        backing_dir: Optional[str] = None,
    ):
        self.block_bytes = int(block_bytes)
        self.backing_dir = backing_dir
        self._store: Dict[str, np.ndarray] = {}
        self.stats = WriteStats()
        if backing_dir:
            os.makedirs(backing_dir, exist_ok=True)

    # ------------------------------------------------------------------ values
    def names(self) -> Iterable[str]:
        return self._store.keys()

    def __contains__(self, name: str) -> bool:
        return name in self._store

    def get(self, name: str) -> np.ndarray:
        """Read the NVM image of an object (copy: loads survive app writes)."""
        return self._store[name].copy()

    def peek(self, name: str) -> Optional[np.ndarray]:
        """No-copy view of the current NVM image (delta-mask computation).

        Callers must not mutate the result; ``None`` if never persisted.
        The view is the arena's own array, which later flushes of the same
        size write in place: it shows them, so read it after the flush you
        mean, and while an async flush may run, only after the manager's
        ``barrier()``.  :meth:`get` returns a copy that stays as it is.
        """
        return self._store.get(name)

    def snapshot(self) -> Dict[str, np.ndarray]:
        return {k: v.copy() for k, v in self._store.items()}

    def install(self, name: str, value: np.ndarray, count_writes: bool = False) -> None:
        """Install a full image (initialization / checkpoint restore path)."""
        value = np.array(value, copy=True, order="C")
        if count_writes:
            self.stats.checkpoint_writes += obj_num_blocks(value, self.block_bytes)
        self._store[name] = value
        self._persist_to_backing(name)

    # ------------------------------------------------------------ block writes
    def writeback_blocks(
        self, name: str, new_value: np.ndarray, block_mask: np.ndarray
    ) -> None:
        """Natural cache eviction: masked blocks of ``new_value`` reach NVM."""
        cur = self._store[name]
        n = int(np.count_nonzero(block_mask))
        if n == 0:
            return
        self.stats.eviction_writes += n
        write_blocks(cur, new_value, block_mask, self.block_bytes)

    def flush(
        self,
        name: str,
        live_value: np.ndarray,
        dirty_resident_mask: Optional[np.ndarray] = None,
        adopt: bool = False,
    ) -> int:
        """EasyCrash persistence operation (CLWB semantics).

        Every block of the object is *issued*, but only blocks that are dirty
        and resident in the cache cause an NVM write.  When no cache model is
        attached (production runtime), ``dirty_resident_mask=None`` falls back
        to a value diff against the current NVM image — the delta_snapshot
        kernel's behaviour, which is a superset of "dirty and resident"
        (an evicted-then-clean block diffs as unchanged).
        Returns the number of blocks actually written.

        A first flush, or one whose image changed byte size, copies the
        whole of ``live_value`` (in C order); with ``adopt`` the caller hands
        ``live_value`` over and, if C-contiguous and writable, it becomes the
        image itself.  Otherwise the written blocks go into the existing
        image in place (:func:`write_blocks`), which stays the same array;
        ``live_value`` is read, never kept, so the caller may reuse its
        buffer.
        """
        live_value = np.asarray(live_value)
        cur = self._store.get(name)
        if cur is not None and cur.nbytes != live_value.nbytes:
            cur = None  # object was reallocated/grown: full rewrite
        if cur is None:
            # first flush: everything is logically dirty
            nb = obj_num_blocks(live_value, self.block_bytes)
            keep = adopt and live_value.flags.c_contiguous and live_value.flags.writeable
            self._store[name] = live_value if keep else np.array(live_value, copy=True, order="C")
            self.stats.flush_writes += nb
            self.stats.flush_ops += 1
            self._persist_to_backing(name)
            return nb
        if dirty_resident_mask is None:
            dirty_resident_mask = block_diff_mask(cur, live_value, self.block_bytes)
        mask = np.asarray(dirty_resident_mask, dtype=bool)
        written = int(np.count_nonzero(mask))
        return self._written(name, written, mask.size,
                             lambda: write_blocks(cur, live_value, mask, self.block_bytes))

    def flush_blocks(self, name: str, index: np.ndarray, blocks: np.ndarray) -> int:
        """A flush of an existing image given as its dirty blocks: block
        ``index[i]`` (ascending) becomes row ``i`` of ``blocks``, uint8
        ``(len(index), block_bytes)``; a partial last block takes the head
        of its row.  Counted as :meth:`flush` counts a mask with those
        blocks dirty.  Returns the number of blocks written."""
        cur = self._store[name]
        bb = self.block_bytes
        index = np.asarray(index, dtype=np.int64)
        blocks = np.asarray(blocks, dtype=np.uint8)
        total = obj_num_blocks(cur, bb)
        if blocks.shape != (index.size, bb) or (index.size and not 0 <= index[0] <= index[-1] < total):
            raise ValueError(f"{index.size} block indices in [0, {total}) and their "
                             f"({index.size}, {bb}) rows expected, got rows {blocks.shape}")

        def write() -> None:
            dst = cur.reshape(-1).view(np.uint8)
            full = dst.size // bb
            body = int(np.searchsorted(index, full))
            cut = full * bb
            dst[:cut].reshape(full, bb)[index[:body]] = blocks[:body]
            if body < index.size:  # the partial last block
                dst[cut:] = blocks[body, : dst.size - cut]

        return self._written(name, index.size, total, write)

    def rewrite(self, name: str, fill: Callable[[np.ndarray], None]) -> int:
        """A flush of an existing image with every block dirty, written in
        place by ``fill(image)`` (say, a device leaf's copy straight into
        the image).  Counted as :meth:`flush` counts it.  Returns the number
        of blocks written."""
        cur = self._store[name]
        total = obj_num_blocks(cur, self.block_bytes)
        return self._written(name, total, total, lambda: fill(cur))

    def _written(self, name: str, written: int, total: int, write: Callable[[], None]) -> int:
        """Run a flush's in-place ``write`` of ``written`` of the image's
        ``total`` blocks, and count it."""
        self.stats.flush_writes += written
        self.stats.flushed_clean_blocks += total - written
        self.stats.flush_ops += 1
        if written:
            with span("arena.mix"):
                write()
            self.stats.inplace_flushes += 1
            self._persist_to_backing(name)
        return written

    def checkpoint_copy(self, name: str, value: np.ndarray) -> None:
        """Traditional C/R data copy: every block of the object is written."""
        value = np.asarray(value)
        self.stats.checkpoint_writes += obj_num_blocks(value, self.block_bytes)
        self._store[f"__chk__/{name}"] = np.array(value, copy=True)

    # -------------------------------------------------------------- durability
    # Backing files follow the shared durable-replace protocol
    # (:mod:`repro.core.durable`): ``reattach`` must never see an empty or
    # torn image, even after power loss mid-rename.
    def _backing_path(self, name: str) -> str:
        safe = name.replace("/", "__")
        return os.path.join(self.backing_dir, f"{safe}.npy")  # type: ignore[arg-type]

    def _persist_to_backing(self, name: str) -> None:
        if not self.backing_dir:
            return
        with span("arena.persist"):
            path = self._backing_path(name)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                np.save(f, self._store[name])
                f.flush()
                os.fsync(f.fileno())
            durable_replace(tmp, path)

    def save_manifest(self) -> None:
        if not self.backing_dir:
            return
        with span("arena.manifest"):
            manifest = {
                "block_bytes": self.block_bytes,
                "objects": {k: str(v.dtype) for k, v in self._store.items()},
            }
            path = os.path.join(self.backing_dir, "manifest.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            durable_replace(tmp, path)

    @classmethod
    def reattach(cls, backing_dir: str) -> "NVMArena":
        """Reload a persisted arena after a crash (the restart path)."""
        path = os.path.join(backing_dir, "manifest.json")
        with open(path) as f:
            manifest = json.load(f)
        arena = cls(block_bytes=manifest["block_bytes"], backing_dir=backing_dir)
        objects = manifest["objects"]
        if isinstance(objects, list):  # legacy manifests without dtypes
            objects = {name: None for name in objects}
        for name, dtype_s in objects.items():
            arr = np.load(arena._backing_path(name))
            if dtype_s is not None and str(arr.dtype) != dtype_s:
                want = np.dtype(dtype_s)
                # np.load round-trips extension dtypes (bfloat16) as void
                if arr.dtype.kind == "V" and arr.dtype.itemsize == want.itemsize:
                    arr = arr.view(want)
                else:
                    arr = arr.astype(want)
            # later flushes write into it in place
            arena._store[name] = np.require(arr, requirements="CW")
        return arena
