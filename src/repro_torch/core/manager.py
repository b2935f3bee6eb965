# Port of repro/core/manager.py.  What differs:
# * flatten_state keeps torch tensors as they are; maybe_flush clones a
#   tensor leaf on its own device.
# * In persist_mode="delta" a tensor leaf's mask is computed on its device
#   (the delta_snapshot CUDA kernel on the card) against a shadow of the last
#   image this manager flushed for that name, and the clone becomes the
#   shadow.  For a leaf on the card only what the mask asks for leaves it:
#   a leaf with every block dirty is copied straight into the arena's image
#   (arena.rewrite), else its dirty blocks are gathered on the card and go
#   to the host with their indices (arena.flush_blocks).  A first flush
#   goes to the host whole, and the arena keeps the page-locked copy as its
#   image, so a later whole-leaf copy lands in it directly.  A CPU leaf goes
#   to arena.flush with its mask, as before.
# * ManagerStats also times each flush's parts: mask, device-to-host copy,
#   arena write.
# * The flush, the restore and their parts run in profiler ranges
#   (core/spans.py, named easycrash.*), so a torch.profiler trace shows them
#   on the kernels' timeline; the timed parts' ranges feed ManagerStats'
#   seconds.  ManagerStats also counts the blocks the flushes issue
#   (blocks_issued, beside blocks_written) and times each restore's reads
#   out of the arena into host memory (restore_read_seconds) and its
#   host-to-device copies, waited for (restore_h2d_seconds).
# * restore returns tensors on the device of init_state's tensor leaves and,
#   in delta mode, seeds the shadows with what it restored.
# * An async flush of a CUDA leaf runs on a stream of the manager's own (one
#   per device), which first waits for an event recorded on the caller's
#   stream after the clones: the mask kernel and the device-to-host copy
#   then overlap the steps that follow instead of queueing among them.  A
#   synchronous flush runs on the caller's stream.  A CUDA leaf's whole
#   copy reaches the host through a page-locked buffer the manager keeps per
#   leaf until the arena keeps it.
# * on_flushed(step, payload, arena), if given, runs after each flush has
#   landed in the arena (on the writer thread for an async flush), with the
#   flushed leaves as the flush cloned them.
# * A bfloat16 tensor leaf goes to the host, and into the arena, as the int16
#   of the same bits (numpy has no bfloat16 without ml_dtypes); restore views
#   those bytes back as bfloat16 on the leaf's device.
"""EasyCrash production runtime for distributed training loops.

This is the framework-facing layer: given a train-state pytree and a
:class:`PersistPlan`-style policy, the manager

* flushes the plan's state leaves to a host-local :class:`NVMArena`
  (asynchronously, on a writer thread — a straggling host never blocks the
  step, and a skipped flush only increases staleness, which EasyCrash
  tolerates by construction);
* performs delta flushes: only blocks that changed since the last flush move
  (the mask of a CUDA leaf comes from the ``delta_snapshot`` CUDA kernel);
* takes full coordinated checkpoints at the Young interval stretched by the
  measured recomputability (MTBF' = MTBF / (1 - R));
* on restart, tries the EasyCrash path (arena image + acceptance
  verification) before falling back to the last full checkpoint.

Every host persists only its own shards: the mechanism is O(local bytes) and
has zero cross-host traffic, so it scales to arbitrarily many nodes.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert import bf16_bits, host_array, to_tensor
from .arena import NVMArena
from .blocks import num_blocks
from .delta_persist import _byte_tensor, delta_block_mask, persist_mask_for
from .efficiency import young_interval
from .spans import span


def _cast_like(img: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Cast a loaded array to the target dtype; np.load round-trips extension
    dtypes (bfloat16) as raw void bytes, which only ``view`` can recover."""
    if img.dtype == target.dtype:
        return img
    if img.dtype.kind == "V" and img.dtype.itemsize == target.dtype.itemsize:
        return img.view(target.dtype)
    return img.astype(target.dtype)


def _staged(img: np.ndarray, target: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """An arena image copied into host memory as a tensor that
    :func:`_to_device` turns into ``target``'s dtype on its device, and
    whether it holds the image's bytes unchanged (no dtype conversion)."""
    if target.dtype == torch.bfloat16:  # the image holds its bits, or is cast to it
        if bf16_bits(img):
            return to_tensor(img, "cpu", torch.bfloat16), True
        return torch.from_numpy(np.array(img, copy=True)), False
    cast = _cast_like(img, torch.empty(0, dtype=target.dtype).numpy())
    same_bytes = cast.dtype == img.dtype or img.dtype.kind == "V"
    # ascontiguousarray would make a 0-d image (a step counter) 1-d
    return torch.from_numpy(np.array(cast, order="C", copy=True)), same_bytes


def _to_device(host: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """A staged image on ``target``'s device, in its dtype; a copy to a CUDA
    device is waited for."""
    out = host.to(target.device, target.dtype)
    if out.is_cuda:
        torch.cuda.current_stream(out.device).synchronize()
    return out


def _off_host(t: torch.Tensor) -> bool:
    """Whether a tensor lives off the host, so that a delta flush moves
    only what its mask asks for across to it."""
    return t.device.type != "cpu"


def _host_dtype(t: torch.Tensor) -> np.dtype:
    """The numpy dtype of a tensor's bytes on the host (int16 for bfloat16,
    as :func:`host_array` gives them)."""
    return torch.empty(0, dtype=torch.int16 if t.dtype == torch.bfloat16 else t.dtype).numpy().dtype


def _gathered(src: torch.Tensor, index: torch.Tensor, block_bytes: int) -> Tuple[np.ndarray, np.ndarray]:
    """The blocks ``index`` (ascending) of the flat byte tensor ``src``,
    gathered on its device and copied to the host, as ``arena.flush_blocks``
    takes them: the indices (int64) and a ``(len(index), block_bytes)``
    uint8 row each, a partial last block zero-padded."""
    full = src.numel() // block_bytes
    rows = src[: full * block_bytes].view(full, block_bytes)
    if index.numel() and src.numel() % block_bytes and int(index[-1]) == full:
        tail = src.new_zeros((1, block_bytes))
        tail[0, : src.numel() - full * block_bytes] = src[full * block_bytes:]
        rows = torch.cat([rows.index_select(0, index[:-1]), tail])
    else:
        rows = rows.index_select(0, index)
    return index.cpu().numpy(), rows.cpu().numpy()


def flatten_state(state: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Flatten a nested dict pytree into 'a/b/c' -> leaf; a torch tensor
    stays a tensor, anything else becomes an ndarray."""
    out: Dict[str, Any] = {}
    for k, v in state.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten_state(v, key + "/"))
        else:
            out[key] = v if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def unflatten_state(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in flat.items():
        parts = k.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


@dataclass
class FlushPolicy:
    """Production analogue of :class:`PersistPlan`.

    ``leaves``: state leaves (flat names, prefix match allowed) to persist.
    ``every_steps``: flush cadence in optimizer steps (the 'frequency x').
    ``async_flush``: persist on a background thread (drops to sync in tests).
    ``max_pending``: back-pressure bound; beyond it flushes are *skipped*
    (bounded staleness instead of a stalled step — straggler mitigation).
    ``persist_mode``: which blocks a flush moves to NVM —
    ``"auto"`` (arena's own byte diff), ``"delta"`` (incremental: changed
    blocks only, detected by the ``delta_snapshot`` kernel for a CUDA leaf,
    its plain version on the CPU otherwise) or ``"full"`` (whole-object
    rewrite, the C/R-style baseline).  All
    three produce byte-identical NVM images; they differ only in write
    traffic, which ``ManagerStats.bytes_written`` measures.
    """

    leaves: Tuple[str, ...]
    every_steps: int = 1
    async_flush: bool = True
    max_pending: int = 2
    persist_mode: str = "auto"

    def __post_init__(self):
        if self.persist_mode not in ("auto", "delta", "full"):
            raise ValueError(
                f"unknown persist_mode {self.persist_mode!r}; use 'auto', 'delta' or 'full'"
            )


@dataclass
class ManagerStats:
    flushes_issued: int = 0
    flushes_skipped: int = 0
    #: blocks of every leaf the flushes covered; blocks_written of them
    #: were dirty and written
    blocks_issued: int = 0
    blocks_written: int = 0
    bytes_written: int = 0
    checkpoints_taken: int = 0
    easycrash_restores: int = 0
    checkpoint_restores: int = 0
    #: host seconds spent in flushes on the mask (for a device leaf in delta
    #: mode: its kernel and its dirty count and indices), on the leaf's
    #: device-to-host copy (its dirty blocks in delta mode), and in arena
    #: writes (with a delta leaf's whole-leaf copy into the image)
    mask_seconds: float = 0.0
    copy_seconds: float = 0.0
    arena_seconds: float = 0.0
    #: host seconds spent in restores reading the images out of the arena
    #: into host memory, and copying them to the device (waited for)
    restore_read_seconds: float = 0.0
    restore_h2d_seconds: float = 0.0


class EasyCrashManager:
    def __init__(
        self,
        arena: NVMArena,
        policy: FlushPolicy,
        checkpoint_save: Optional[Callable[[int, Mapping[str, Any]], None]] = None,
        checkpoint_restore: Optional[Callable[[], Optional[Tuple[int, Dict[str, Any]]]]] = None,
        mtbf: Optional[float] = None,
        t_chk: Optional[float] = None,
        recomputability: float = 0.0,
        step_time: float = 1.0,
        on_flushed: Optional[Callable[[int, Mapping[str, Any], NVMArena], None]] = None,
    ):
        self.arena = arena
        self.on_flushed = on_flushed
        self.policy = policy
        self.checkpoint_save = checkpoint_save
        self.checkpoint_restore = checkpoint_restore
        self.stats = ManagerStats()
        #: per tensor leaf, the last image this manager flushed or restored,
        #: on the leaf's device (delta mode only)
        self._shadow: Dict[str, torch.Tensor] = {}
        self._q: "queue.Queue[Optional[Tuple[int, Dict[str, Any], Dict[torch.device, Any]]]]" = (
            queue.Queue()
        )
        self._worker: Optional[threading.Thread] = None
        #: per CUDA device, the stream async flushes run on
        self._streams: Dict[torch.device, Any] = {}
        #: per CUDA leaf, the page-locked host buffer its flushes copy into
        self._pinned: Dict[str, torch.Tensor] = {}
        self._last_error: Optional[BaseException] = None
        if policy.async_flush:
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()
        # checkpoint cadence in *steps*, from Young's formula on the stretched
        # MTBF (paper §7); None disables periodic checkpoints.
        self.checkpoint_every: Optional[int] = None
        if mtbf is not None and t_chk is not None:
            mtbf_ec = mtbf / max(1e-9, (1.0 - min(recomputability, 0.999999)))
            self.checkpoint_every = max(1, int(young_interval(t_chk, mtbf_ec) / step_time))

    # ------------------------------------------------------------------ flush
    @staticmethod
    def _match(name: str, leaf: str) -> bool:
        if leaf.endswith("*"):
            return name.startswith(leaf[:-1])
        return name == leaf or name.startswith(leaf + "/")

    def _selected(self, flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return {
            name: arr
            for name, arr in flat.items()
            if any(self._match(name, l) for l in self.policy.leaves)
        }

    def maybe_flush(self, step: int, state: Mapping[str, Any]) -> bool:
        """Issue an EasyCrash persistence op if the cadence says so.

        Returns True if a flush was issued (or enqueued)."""
        if step % self.policy.every_steps != 0:
            return False
        flat = flatten_state(state)
        sel = self._selected(flat)
        sel["__step__"] = np.asarray(step, dtype=np.int64)
        payload: Dict[str, Any] = {}
        for k, v in sel.items():
            if isinstance(v, torch.Tensor):
                payload[k] = v.detach().clone(memory_format=torch.contiguous_format)
            else:
                payload[k] = np.array(v, copy=True)
        if self.policy.async_flush:
            if self._q.qsize() >= self.policy.max_pending:
                self.stats.flushes_skipped += 1   # straggler mitigation: skip
                return False
            #: per CUDA device, the point on the caller's stream after the
            #: clones, which the writer's stream waits for
            ready: Dict[torch.device, Any] = {}
            for v in payload.values():
                if isinstance(v, torch.Tensor) and v.is_cuda and v.device not in ready:
                    ready[v.device] = torch.cuda.Event()
                    ready[v.device].record(torch.cuda.current_stream(v.device))
            self._q.put((step, payload, ready))
        else:
            self._flush_now(step, payload)
        self.stats.flushes_issued += 1
        return True

    def _writer_stream(self, device: torch.device, ready) -> Any:
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device=device)
        stream.wait_event(ready)
        return stream

    def _flush_now(self, step: int, payload: Mapping[str, Any],
                   ready: Optional[Mapping[torch.device, Any]] = None) -> None:
        with span("flush"):
            streams = {dev: self._writer_stream(dev, ev) for dev, ev in (ready or {}).items()}
            for name, arr in payload.items():
                if isinstance(arr, torch.Tensor):
                    on_stream = (torch.cuda.stream(streams[arr.device]) if arr.device in streams
                                 else contextlib.nullcontext())
                    with on_stream:
                        written = self._flush_tensor(name, arr)
                else:
                    with span("flush.mask", self.stats, "mask_seconds"):
                        mask = persist_mask_for(
                            self.policy.persist_mode, self.arena.peek(name), arr,
                            self.arena.block_bytes,
                        )
                    with span("arena.flush", self.stats, "arena_seconds"):
                        written = self.arena.flush(name, arr, dirty_resident_mask=mask)
                nbytes = arr.numel() * arr.element_size() if isinstance(arr, torch.Tensor) else arr.nbytes
                self.stats.blocks_issued += num_blocks(nbytes, self.arena.block_bytes)
                self.stats.blocks_written += written
                self.stats.bytes_written += written * self.arena.block_bytes
            self.arena.save_manifest()
        if self.on_flushed is not None and payload:
            self.on_flushed(step, payload, self.arena)

    def _flush_tensor(self, name: str, live: torch.Tensor) -> int:
        """Flush a tensor leaf into the arena; returns the blocks written.

        In delta mode, once the arena holds an image of the leaf's size, the
        mask is computed on the leaf's device against the shadow of the last
        image this manager flushed or restored.  That is exact: every flush
        leaves the arena image equal to the flushed bytes.  A manager with
        no shadow of the right size (a fresh one over a used arena) copies
        the arena image to the device first.  For a leaf off the host
        (:func:`_off_host`) whose image has its shape and dtype, only what
        the mask asks for then leaves the device: with every block dirty,
        the whole leaf straight into the image (``arena.rewrite``); else the
        dirty blocks, gathered on the device, and their indices
        (``arena.flush_blocks``).  Otherwise the whole leaf goes to the host
        and through ``arena.flush`` with the mask (auto and full modes, a
        first flush and a reallocation take the arena's own rule), which in
        delta mode keeps a CUDA leaf's page-locked copy as a new image.
        """
        mode = self.policy.persist_mode
        bb = self.arena.block_bytes
        cur = self.arena.peek(name)
        shadow = self._shadow.pop(name, None)
        nbytes = live.numel() * live.element_size()
        if live.is_cuda:  # the caching allocator must not hand these to
            # the caller's stream while this (writer's) stream reads them
            stream = torch.cuda.current_stream(live.device)
            for t in (live, shadow):
                if t is not None and t.device == live.device:
                    t.record_stream(stream)
        if mode == "delta":
            self._shadow[name] = live
        mask = None
        if mode == "delta" and cur is not None and cur.nbytes == nbytes:
            direct = _off_host(live) and cur.shape == tuple(live.shape) \
                and cur.dtype == _host_dtype(live)
            with span("flush.mask", self.stats, "mask_seconds"):
                if shadow is None or shadow.numel() * shadow.element_size() != nbytes:
                    # a copy on the CPU too: the arena writes its image in place
                    shadow = _byte_tensor(cur).to(live.device, copy=True)
                mask = delta_block_mask(shadow, live, bb)
                if direct:
                    dense = int(torch.count_nonzero(mask)) == mask.numel()
                    index = None if dense else torch.nonzero(mask).squeeze(1)
                else:
                    mask = mask.cpu().numpy()
            if direct:
                src = _byte_tensor(live)
                if dense:
                    with span("arena.flush", self.stats, "arena_seconds"):
                        return self.arena.rewrite(name, lambda image: _byte_tensor(image).copy_(src))
                with span("flush.to_host", self.stats, "copy_seconds"):
                    index, blocks = _gathered(src, index, bb)
                with span("arena.flush", self.stats, "arena_seconds"):
                    return self.arena.flush_blocks(name, index, blocks)
        with span("flush.to_host", self.stats, "copy_seconds"):
            host = self._host_copy(name, live)
        if mask is None:  # auto, full, or a first flush / reallocation: no compare
            with span("flush.mask", self.stats, "mask_seconds"):
                mask = persist_mask_for(mode, cur, host, bb)
        with span("arena.flush", self.stats, "arena_seconds"):
            if live.is_cuda and mode == "delta":  # the page-locked copy may become the image
                written = self.arena.flush(name, host, dirty_resident_mask=mask, adopt=True)
            else:
                written = self.arena.flush(name, host, dirty_resident_mask=mask)
        if self.arena.peek(name) is host:  # the image now: the next flush stages elsewhere
            self._pinned.pop(name, None)
        return written

    def _host_copy(self, name: str, live: torch.Tensor) -> np.ndarray:
        """The leaf's bytes on the host, as :func:`host_array` gives them.

        A CUDA leaf goes through a page-locked buffer this manager keeps per
        leaf (a DMA on the current stream, waited for), valid until the
        leaf's next flush, unless the arena keeps it as the image."""
        if not live.is_cuda:
            return host_array(live)
        src = live.view(torch.int16) if live.dtype == torch.bfloat16 else live
        buf = self._pinned.get(name)
        if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
            buf = self._pinned[name] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        buf.copy_(src, non_blocking=True)
        torch.cuda.current_stream(live.device).synchronize()
        return buf.numpy()

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                self._flush_now(*item)
            except BaseException as e:  # surfaced on barrier()
                self._last_error = e

    def barrier(self) -> None:
        """Wait for all pending flushes (checkpoint/shutdown boundary)."""
        if self.policy.async_flush:
            while not self._q.empty():
                time.sleep(0.001)
            # one more roundtrip so an in-flight item finishes
            self._q.put((int(-1), {}))
            while not self._q.empty():
                time.sleep(0.001)
        if self._last_error is not None:
            raise self._last_error

    def close(self) -> None:
        if self._worker is not None:
            self.barrier()
            self._q.put(None)
            self._worker.join(timeout=5)
            self._worker = None

    # ------------------------------------------------------------- checkpoint
    def maybe_checkpoint(self, step: int, state: Mapping[str, Any]) -> bool:
        if (
            self.checkpoint_save is None
            or self.checkpoint_every is None
            or step == 0
            or step % self.checkpoint_every != 0
        ):
            return False
        self.barrier()
        self.checkpoint_save(step, state)
        self.stats.checkpoints_taken += 1
        return True

    # ---------------------------------------------------------------- restore
    def restore(
        self,
        init_state: Mapping[str, Any],
        verify: Optional[Callable[[Dict[str, Any], int], bool]] = None,
    ) -> Tuple[Dict[str, Any], int, str]:
        """Recovery: EasyCrash path first, checkpoint fallback second.

        ``verify(state, step)`` is the acceptance hook deciding whether the
        NVM image is usable; recomputability-by-construction means it may
        accept inconsistent-but-convergent images.
        Returns (state, step, source) with source in
        {"easycrash", "checkpoint", "fresh"}.
        """
        with span("restore"):
            flat_init = flatten_state(init_state)
            # --- EasyCrash path: arena image over init state
            names = set(self.arena.names())
            if "__step__" in names:
                merged = dict(flat_init)
                seeds: Dict[str, torch.Tensor] = {}  # restored tensors holding image bytes
                for name in names:
                    if name == "__step__" or name.startswith("__chk__/") or name not in merged:
                        continue
                    target = merged[name]
                    with span("restore.read", self.stats, "restore_read_seconds"):
                        img = self.arena.get(name)
                        if img.shape != tuple(target.shape):
                            continue
                        if not isinstance(target, torch.Tensor):
                            merged[name] = _cast_like(img, target)
                            continue
                        host, same_bytes = _staged(img, target)
                    with span("restore.to_device", self.stats, "restore_h2d_seconds"):
                        merged[name] = _to_device(host, target)
                    if same_bytes:
                        seeds[name] = merged[name]
                step = int(self.arena.get("__step__"))
                candidate = unflatten_state(merged)
                if verify is None or verify(candidate, step):
                    if self.policy.persist_mode == "delta":
                        # the next delta flush compares against these on the
                        # device; clones, since the caller may update in place
                        with span("restore.shadow"):
                            self._shadow.update({
                                k: v.clone() for k, v in seeds.items()
                                if any(self._match(k, l) for l in self.policy.leaves)
                            })
                    self.stats.easycrash_restores += 1
                    return candidate, step, "easycrash"
            # --- checkpoint fallback
            if self.checkpoint_restore is not None:
                got = self.checkpoint_restore()
                if got is not None:
                    step, state = got
                    self.stats.checkpoint_restores += 1
                    return state, step, "checkpoint"
            return dict(init_state), 0, "fresh"
