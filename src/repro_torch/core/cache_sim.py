# Port copy of repro/core/cache_sim.py, unchanged apart from this header; its relative imports resolve inside repro_torch.
"""NVCT cache model: write-back LRU cache between the app and the NVM arena.

The paper's NVCT tool is a PIN-based cache simulator that tracks, at
cache-block granularity, which values have reached NVM and which are dirty in
the (volatile) cache when a random crash fires.  We reproduce it with an
event-driven simulation:

* an application iteration is a sequence of *regions*; each region performs
  ordered read/write **sweeps** over its declared data objects (HPC solver
  loops and XLA fusions write arrays in sweep order);
* a fully-associative write-back, write-allocate LRU cache of
  ``capacity_blocks`` sits in front of NVM.  Dirty blocks reach NVM when
  evicted (natural write-back) or when an EasyCrash flush (CLWB semantics:
  write back, stay resident, become clean) targets their object;
* a crash at access-time ``W`` loses every dirty block still resident; the
  NVM image is the per-block mixture of the latest written-back versions.

Efficiency: a *crash window* (the two iterations around the crash point) is
simulated **once**, producing timestamped write-back records; every crash
test inside the window is then resolved vectorially from the records.  The
window is assumed to start cache-consistent, which is exact whenever an
iteration touches more blocks than the cache holds (the paper selects inputs
so the footprint exceeds the LLC; small-footprint apps are explicitly
EasyCrash-unsuitable, §8).  ``tests/test_cache_sim.py`` cross-checks the
record machinery against a brute-force simulator with hypothesis.

Two window-simulation engines produce bit-for-bit identical
:class:`WindowTrace` output:

* ``engine="ref"`` — the exact per-access ``OrderedDict`` LRU
  (:func:`simulate_window`'s historical body), kept as the reference oracle;
* ``engine="vec"`` — :func:`simulate_window_vec`, a structure-of-arrays
  simulator that walks the access stream *run-at-a-time*: the LRU recency
  list is represented as a deque of block-range runs with lazy invalidation,
  sweeps are processed as hit/miss groups, and eviction write-backs, flush
  events and timestamps come out of NumPy array ops instead of per-access
  dict mutation.  ``tests/test_campaign_vec.py`` holds the differential and
  property equivalence suite.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .blocks import DEFAULT_BLOCK_BYTES

#: window-simulation engines accepted by :func:`simulate_window` and the
#: campaign layers above it (``CrashTester(engine=...)``)
ENGINES = ("ref", "vec")


class TornBlock(NamedTuple):
    """A cacheline whose in-flight store landed partially at the crash.

    Bytes ``[0, cut_bytes)`` of block ``block`` of ``obj`` carry the new
    version written by region occurrence ``seq``; the suffix keeps whatever
    the resolved NVM image held.  Produced by fault models
    (:mod:`repro.core.faults`), consumed by :func:`resolve_window_images` /
    :func:`apply_torn_blocks`.
    """

    obj: str
    block: int
    cut_bytes: int
    seq: int


@dataclass(frozen=True)
class CacheConfig:
    capacity_blocks: int = 2048
    block_bytes: int = DEFAULT_BLOCK_BYTES

    def spec(self) -> Dict[str, object]:
        return {
            "capacity_blocks": int(self.capacity_blocks),
            "block_bytes": int(self.block_bytes),
        }


# --------------------------------------------------------------------- events
@dataclass(frozen=True)
class Sweep:
    """Sequential pass over all blocks of ``obj``; write sweeps dirty them.

    ``hot``: objects re-read continuously while this sweep runs (e.g. the
    centroid table during a k-means assign pass).  Their blocks are
    re-accessed every ``hot_every`` accesses, so the LRU never ages them out
    — which is how small hot objects become *chronically dirty* and leave
    only ancient values in NVM (paper §8).
    """

    obj: str
    write: bool
    hot: Tuple[str, ...] = ()
    hot_every: int = 16


@dataclass(frozen=True)
class Flush:
    """EasyCrash persistence op on ``obj`` (CLWB: write back + keep + clean)."""

    obj: str


Event = object  # Sweep | Flush


@dataclass(frozen=True)
class RegionEvents:
    """One region occurrence inside a window."""

    seq: int            # global sequence number of this region occurrence
    iter_idx: int       # application iteration it belongs to
    region_idx: int     # index into the app's region list
    events: Tuple[Event, ...]


@dataclass
class SweepRecord:
    t_start: int
    obj: str
    seq: int
    n_blocks: int


@dataclass
class WindowTrace:
    """Everything a crash test needs, produced by one window simulation."""

    obj_blocks: Dict[str, int]
    # write-back records per object: arrays sorted by time
    wb_t: Dict[str, np.ndarray]
    wb_block: Dict[str, np.ndarray]
    wb_seq: Dict[str, np.ndarray]
    # write sweeps in time order (for live-value reconstruction)
    sweeps: List[SweepRecord]
    # region spans: (seq, iter_idx, region_idx, t0, t1)
    spans: List[Tuple[int, int, int, int, int]]
    t_end: int
    # write accounting over the window
    eviction_writes: int = 0
    flush_writes: int = 0
    flushed_clean_blocks: int = 0
    flush_ops: int = 0

    def span_for_time(self, t: int) -> Tuple[int, int, int, int, int]:
        for span in self.spans:
            if span[3] <= t < span[4]:
                return span
        return self.spans[-1]

    def sweep_soa(self) -> Tuple[np.ndarray, np.ndarray]:
        """SoA view of the write sweeps: ``(t_start, n_blocks)`` arrays in
        sweep order.  Sweeps never overlap in time, so the sweep in flight at
        a crash time (if any) is found by one ``searchsorted`` over
        ``t_start`` instead of a Python scan — the fault models' tearing
        hooks use this to locate the store queue they operate on."""
        soa = getattr(self, "_sweep_soa", None)
        if soa is None or soa[0].size != len(self.sweeps):
            soa = (
                np.fromiter((s.t_start for s in self.sweeps), np.int64, len(self.sweeps)),
                np.fromiter((s.n_blocks for s in self.sweeps), np.int64, len(self.sweeps)),
            )
            # WindowTrace is a plain (unfrozen) dataclass: memoize in place
            self._sweep_soa = soa
        return soa


class _LRU:
    """Exact fully-associative LRU write-back cache at block granularity.

    Alongside the recency dict, a per-object *dirty-block index* is
    maintained on every access / eviction / clean: ``_dirty[obj]`` maps
    block -> writer seq in recency order restricted to that object's dirty
    lines.  ``dirty_lines_of`` / ``dirty_resident_mask`` read the index in
    O(dirty blocks of obj) instead of walking the full cache — the historical
    full-cache scans made every flush (and every per-crash-point mask) cost
    O(capacity) regardless of how little of the object was dirty.
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        # (obj, block) -> writer seq (or -1 if clean)
        self._lines: "OrderedDict[Tuple[str, int], int]" = OrderedDict()
        # obj -> OrderedDict[block, seq]: the object's dirty lines, in the
        # same relative recency order they hold in _lines
        self._dirty: Dict[str, "OrderedDict[int, int]"] = {}

    def access(self, key: Tuple[str, int], writer_seq: int) -> Optional[Tuple[str, int, int]]:
        """Access one block; returns an eviction record (obj, block, seq) or None.

        ``writer_seq >= 0`` marks a write (dirties the line); ``-1`` is a read.
        """
        lines = self._lines
        prev = lines.pop(key, None)
        if prev is None and len(lines) >= self.capacity:
            evk, evseq = lines.popitem(last=False)
            if evseq >= 0:
                del self._dirty[evk[0]][evk[1]]
                evicted = (evk[0], evk[1], evseq)
            else:
                evicted = None
        else:
            evicted = None
        if writer_seq >= 0:
            lines[key] = writer_seq
            d = self._dirty.setdefault(key[0], OrderedDict())
            d.pop(key[1], None)
            d[key[1]] = writer_seq
        else:
            keep = prev if prev is not None and prev >= 0 else -1
            lines[key] = keep
            if keep >= 0:
                # a read hit of a dirty line moves it to MRU: mirror the move
                d = self._dirty[key[0]]
                d.pop(key[1], None)
                d[key[1]] = keep
        return evicted

    def dirty_lines_of(self, obj: str) -> List[Tuple[int, int]]:
        return list(self._dirty.get(obj, {}).items())

    def clean_obj(self, obj: str) -> None:
        d = self._dirty.get(obj)
        if not d:
            return
        lines = self._lines
        for blk in d:
            lines[(obj, blk)] = -1  # in-place: cleaning never changes recency
        d.clear()

    def dirty_resident_mask(self, obj: str, n_blocks: int) -> np.ndarray:
        m = np.zeros(n_blocks, dtype=bool)
        d = self._dirty.get(obj)
        if d:
            m[np.fromiter(d.keys(), np.int64, len(d))] = True
        return m


def simulate_window(
    cfg: CacheConfig,
    obj_blocks: Mapping[str, int],
    regions: Sequence[RegionEvents],
    engine: str = "ref",
) -> WindowTrace:
    """Run the event trace once; emit timestamped write-back records.

    Time advances by one unit per block access.  Flushes are instantaneous
    (they do not advance time) — the paper measures flush cost separately.

    ``engine`` selects the simulator: ``"ref"`` (default here — the exact
    per-access oracle this function has always been) or ``"vec"`` (the SoA
    run-at-a-time engine, :func:`simulate_window_vec`).  Both produce
    bit-for-bit identical :class:`WindowTrace` output.
    """
    if engine == "vec":
        return simulate_window_vec(cfg, obj_blocks, regions)
    if engine != "ref":
        raise ValueError(f"unknown window engine {engine!r}; have {ENGINES}")
    cache = _LRU(cfg.capacity_blocks)
    wb: Dict[str, List[Tuple[int, int, int]]] = {o: [] for o in obj_blocks}
    sweeps: List[SweepRecord] = []
    spans: List[Tuple[int, int, int, int, int]] = []
    trace = WindowTrace(
        obj_blocks=dict(obj_blocks),
        wb_t={}, wb_block={}, wb_seq={}, sweeps=sweeps, spans=spans, t_end=0,
    )
    t = 0
    for reg in regions:
        t0 = t
        for ev in reg.events:
            if isinstance(ev, Sweep):
                nb = obj_blocks[ev.obj]
                if ev.write:
                    sweeps.append(SweepRecord(t, ev.obj, reg.seq, nb))
                writer = reg.seq if ev.write else -1
                for b in range(nb):
                    evicted = cache.access((ev.obj, b), writer)
                    if evicted is not None:
                        eo, eb, eseq = evicted
                        wb[eo].append((t, eb, eseq))
                        trace.eviction_writes += 1
                    t += 1
                    if ev.hot and b % ev.hot_every == ev.hot_every - 1:
                        # refresh hot objects (reads; no time advance — they
                        # hit in L1 and cost nothing on the sweep timescale)
                        for h in ev.hot:
                            for hb in range(obj_blocks[h]):
                                ev2 = cache.access((h, hb), -1)
                                if ev2 is not None:
                                    eo, eb, eseq = ev2
                                    wb[eo].append((t, eb, eseq))
                                    trace.eviction_writes += 1
            elif isinstance(ev, Flush):
                dirty = cache.dirty_lines_of(ev.obj)
                nb = obj_blocks[ev.obj]
                for blk, seq in dirty:
                    wb[ev.obj].append((t, blk, seq))
                trace.flush_writes += len(dirty)
                trace.flushed_clean_blocks += nb - len(dirty)
                trace.flush_ops += 1
                cache.clean_obj(ev.obj)
            else:  # pragma: no cover - defensive
                raise TypeError(f"unknown event {ev!r}")
        spans.append((reg.seq, reg.iter_idx, reg.region_idx, t0, t))
    trace.t_end = t
    for o, recs in wb.items():
        if recs:
            arr = np.asarray(recs, dtype=np.int64)
            order = np.argsort(arr[:, 0], kind="stable")
            arr = arr[order]
            trace.wb_t[o] = arr[:, 0]
            trace.wb_block[o] = arr[:, 1]
            trace.wb_seq[o] = arr[:, 2]
        else:
            trace.wb_t[o] = np.zeros(0, dtype=np.int64)
            trace.wb_block[o] = np.zeros(0, dtype=np.int64)
            trace.wb_seq[o] = np.zeros(0, dtype=np.int64)
    return trace


# ------------------------------------------------------------ the SoA engine
class _RunLRU:
    """Run-structured exact LRU: the recency list as a deque of block runs.

    The access stream of :func:`simulate_window` is highly structured — whole
    objects swept block 0..nb-1 in order, hot objects re-read in full — so
    the LRU recency list is, at all times, a concatenation of *runs* of
    blocks of one object.  This class maintains that run list directly:

    * ``runs`` — deque of ``[run_id, obj, blocks]`` from LRU (head) to MRU
      (tail), with **lazy invalidation**: when a block is re-accessed it is
      appended to a new tail run and its old entry goes stale; stale entries
      are filtered with one vectorized ``loc`` comparison when the head is
      popped for eviction.
    * ``loc[obj][blk]`` — id of the run the block validly resides in (-1 when
      not resident); ``seq[obj][blk]`` — the dirty writer seq (-1 clean).

    A sweep is processed as alternating *hit groups* (move a block range to
    MRU: one run append) and *miss groups* (insert a range; evict exactly the
    overflow from the head, write-back records and their timestamps emitted
    as array slices).  Per-event cost is O(runs touched), not O(blocks).

    Equivalence argument for the miss group (the one subtle case): evictions
    pop valid lines strictly from the head while the group's own blocks are
    appended at the tail, and the k-th eviction of a group of n misses
    happens at access index ``no_evict + k`` — before that access's insert.
    A group block can therefore only be popped after every older valid line
    is consumed, by which point at least as many group blocks have been
    inserted as are popped, which is exactly the per-access order the
    reference engine executes.  ``tests/test_campaign_vec.py`` checks the
    equivalence property against the oracle under hypothesis.
    """

    __slots__ = ("capacity", "size", "runs", "loc", "seq", "_next_id")

    def __init__(self, capacity: int, obj_blocks: Mapping[str, int]):
        self.capacity = capacity
        self.size = 0
        self.runs: "deque[list]" = deque()
        self.loc = {o: np.full(nb, -1, np.int64) for o, nb in obj_blocks.items()}
        self.seq = {o: np.full(nb, -1, np.int64) for o, nb in obj_blocks.items()}
        self._next_id = 0

    def _new_run(self, obj: str, lo: int, hi: int) -> int:
        rid = self._next_id
        self._next_id += 1
        self.runs.append([rid, obj, np.arange(lo, hi, dtype=np.int64)])
        return rid

    def access_range(
        self,
        obj: str,
        lo: int,
        hi: int,
        w_seq: int,
        t0: int,
        dt: int,
        emit: Callable[[str, np.ndarray, np.ndarray, np.ndarray], None],
    ) -> None:
        """Access blocks ``lo..hi-1`` of ``obj`` in order; access ``j``
        happens at time ``t0 + dt*(j-lo)`` (``dt=0``: hot refresh, which the
        sweep clock treats as free)."""
        loc = self.loc[obj]
        j = lo
        while j < hi:
            res = loc[j:hi] >= 0
            first = bool(res[0])
            flips = np.flatnonzero(res != first)
            glen = int(flips[0]) if flips.size else (hi - j)
            if first:
                self._hit_group(obj, j, j + glen, w_seq)
            else:
                self._miss_group(obj, j, j + glen, w_seq, t0 + dt * (j - lo), dt, emit)
            j += glen

    def _hit_group(self, obj: str, lo: int, hi: int, w_seq: int) -> None:
        # re-accessed resident blocks move to MRU; reads keep their dirty seq
        rid = self._new_run(obj, lo, hi)
        self.loc[obj][lo:hi] = rid
        if w_seq >= 0:
            self.seq[obj][lo:hi] = w_seq

    def _miss_group(
        self, obj: str, lo: int, hi: int, w_seq: int, t0: int, dt: int, emit
    ) -> None:
        n = hi - lo
        no_evict = min(n, max(0, self.capacity - self.size))
        n_evict = n - no_evict
        rid = self._new_run(obj, lo, hi)
        self.loc[obj][lo:hi] = rid
        self.seq[obj][lo:hi] = w_seq if w_seq >= 0 else -1
        self.size += no_evict  # each evicting access pops one line, inserts one
        if n_evict:
            times = t0 + dt * (no_evict + np.arange(n_evict, dtype=np.int64))
            self._evict(n_evict, times, emit)

    def _evict(self, n_evict: int, times: np.ndarray, emit) -> None:
        k = 0
        while k < n_evict:
            run = self.runs[0]
            rid, obj, blocks = run
            valid = np.flatnonzero(self.loc[obj][blocks] == rid)
            if valid.size == 0:
                self.runs.popleft()
                continue
            take = min(valid.size, n_evict - k)
            idx = valid[:take]
            segs = blocks[idx]
            seqs = self.seq[obj][segs]
            dirty = seqs >= 0
            if dirty.any():
                emit(obj, times[k:k + take][dirty], segs[dirty], seqs[dirty])
            self.loc[obj][segs] = -1
            if take == valid.size:
                self.runs.popleft()
            else:
                run[2] = blocks[int(idx[take - 1]) + 1:]
            k += take

    def flush(self, obj: str, t: int, emit) -> int:
        """CLWB ``obj``: emit its dirty resident lines in recency order (the
        reference engine's OrderedDict walk order), clean them in place."""
        n_dirty = 0
        seq = self.seq[obj]
        loc = self.loc[obj]
        for run in self.runs:
            rid, o, blocks = run
            if o != obj:
                continue
            mask = (loc[blocks] == rid) & (seq[blocks] >= 0)
            if mask.any():
                segs = blocks[mask]
                emit(obj, np.full(segs.size, t, np.int64), segs, seq[segs])
                seq[segs] = -1
                n_dirty += segs.size
        return int(n_dirty)


def simulate_window_vec(
    cfg: CacheConfig,
    obj_blocks: Mapping[str, int],
    regions: Sequence[RegionEvents],
) -> WindowTrace:
    """SoA window simulator: bit-for-bit :func:`simulate_window`, array-at-a-time.

    The event stream is walked run-at-a-time through :class:`_RunLRU`;
    write-back records (eviction and flush) are emitted as array batches in
    the reference engine's exact emission order, so the stable per-object
    time sort below reproduces its ``wb_*`` arrays exactly — including the
    relative order of same-timestamp records, which the batch image resolver
    and the tearing hooks both rely on.
    """
    cache = _RunLRU(cfg.capacity_blocks, obj_blocks)
    wb: Dict[str, List[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = {
        o: [] for o in obj_blocks
    }
    sweeps: List[SweepRecord] = []
    spans: List[Tuple[int, int, int, int, int]] = []
    trace = WindowTrace(
        obj_blocks=dict(obj_blocks),
        wb_t={}, wb_block={}, wb_seq={}, sweeps=sweeps, spans=spans, t_end=0,
    )

    def emit(obj: str, ts: np.ndarray, blks: np.ndarray, seqs: np.ndarray) -> None:
        wb[obj].append((ts, blks, seqs))
        trace.eviction_writes += ts.size

    t = 0
    for reg in regions:
        t0 = t
        for ev in reg.events:
            if isinstance(ev, Sweep):
                nb = obj_blocks[ev.obj]
                if ev.write:
                    sweeps.append(SweepRecord(t, ev.obj, reg.seq, nb))
                writer = reg.seq if ev.write else -1
                if not ev.hot:
                    cache.access_range(ev.obj, 0, nb, writer, t, 1, emit)
                    t += nb
                else:
                    # hot refreshes fire after each access b with
                    # b % hot_every == hot_every - 1, at the already-advanced
                    # clock; the refresh accesses are free (dt=0)
                    e = ev.hot_every
                    b = 0
                    while b < nb:
                        ce = min(nb, (b // e + 1) * e)
                        cache.access_range(ev.obj, b, ce, writer, t, 1, emit)
                        t += ce - b
                        if ce % e == 0:
                            for h in ev.hot:
                                cache.access_range(h, 0, obj_blocks[h], -1, t, 0, emit)
                        b = ce
            elif isinstance(ev, Flush):
                n_dirty = cache.flush(
                    ev.obj, t, lambda obj, ts, blks, seqs: wb[obj].append((ts, blks, seqs))
                )
                trace.flush_writes += n_dirty
                trace.flushed_clean_blocks += obj_blocks[ev.obj] - n_dirty
                trace.flush_ops += 1
            else:  # pragma: no cover - defensive
                raise TypeError(f"unknown event {ev!r}")
        spans.append((reg.seq, reg.iter_idx, reg.region_idx, t0, t))
    trace.t_end = t
    for o, batches in wb.items():
        if batches:
            ts = np.concatenate([b[0] for b in batches])
            blks = np.concatenate([b[1] for b in batches])
            seqs = np.concatenate([b[2] for b in batches])
            order = np.argsort(ts, kind="stable")
            trace.wb_t[o] = ts[order]
            trace.wb_block[o] = blks[order]
            trace.wb_seq[o] = seqs[order]
        else:
            trace.wb_t[o] = np.zeros(0, dtype=np.int64)
            trace.wb_block[o] = np.zeros(0, dtype=np.int64)
            trace.wb_seq[o] = np.zeros(0, dtype=np.int64)
    return trace


def _apply_versions(
    base: np.ndarray,
    blocks: np.ndarray,
    seqs: np.ndarray,
    versions: Mapping[int, np.ndarray],
    block_bytes: int,
) -> np.ndarray:
    """Overwrite ``base`` blockwise with versioned values, in record order."""
    out = np.ascontiguousarray(base).copy()
    flat = out.view(np.uint8).reshape(-1)
    nbytes = flat.size
    for blk, seq in zip(blocks.tolist(), seqs.tolist()):
        src = versions[seq]
        sflat = np.ascontiguousarray(src).view(np.uint8).reshape(-1)
        lo = blk * block_bytes
        hi = min(lo + block_bytes, nbytes)
        flat[lo:hi] = sflat[lo:hi]
    return flat.view(base.dtype).reshape(base.shape)


def resolve_nvm_image(
    trace: WindowTrace,
    crash_t: int,
    start_values: Mapping[str, np.ndarray],
    seq_values: Mapping[int, Mapping[str, np.ndarray]],
    block_bytes: int,
    chronic_base: Optional[Mapping[str, np.ndarray]] = None,
) -> Dict[str, np.ndarray]:
    """NVM image at ``crash_t``: latest written-back version per block.

    ``chronic_base``: for objects re-dirtied every iteration, blocks with *no*
    write-back anywhere in the window were — by steady-state periodicity —
    never written back since the value in ``chronic_base`` (the last flush,
    or initialization).  This captures the paper's §8 small-hot-object case:
    data resident in cache forever leaves only ancient values in NVM.
    """
    out: Dict[str, np.ndarray] = {}
    for obj, base in start_values.items():
        base = _chronic_adjusted_base(
            trace, obj, np.asarray(base), chronic_base, block_bytes
        )
        t = trace.wb_t[obj]
        n = int(np.searchsorted(t, crash_t, side="right"))
        if n == 0:
            out[obj] = np.array(base, copy=True)
            continue
        needed = set(trace.wb_seq[obj][:n].tolist())
        versions = {seq: seq_values[seq][obj] for seq in needed}
        out[obj] = _apply_versions(
            base, trace.wb_block[obj][:n], trace.wb_seq[obj][:n], versions, block_bytes
        )
    return out


def _chronic_adjusted_base(
    trace: WindowTrace,
    obj: str,
    base: np.ndarray,
    chronic_base: Optional[Mapping[str, np.ndarray]],
    block_bytes: int,
) -> np.ndarray:
    """Replace blocks with no write-back anywhere in the window by their
    chronic (last-flushed / initial) values — the paper's §8 small-hot-object
    case, where data resident in cache forever leaves only ancient NVM."""
    from .blocks import mix_blocks, obj_num_blocks

    if chronic_base is None or obj not in chronic_base:
        return base
    nb = obj_num_blocks(base, block_bytes)
    chronic_mask = np.ones(nb, dtype=bool)
    if trace.wb_block[obj].size:
        seen = np.unique(trace.wb_block[obj])
        chronic_mask[seen[seen < nb]] = False
    if not chronic_mask.any():
        return base
    return mix_blocks(chronic_base[obj], base, ~chronic_mask, block_bytes)


def apply_torn_blocks(
    image: Dict[str, np.ndarray],
    torn: Sequence[TornBlock],
    seq_values: Mapping[int, Mapping[str, np.ndarray]],
    block_bytes: int,
) -> Dict[str, np.ndarray]:
    """Land partial cachelines on a resolved NVM image, in place.

    For each :class:`TornBlock`, the first ``cut_bytes`` bytes of the block
    take the torn store's version; the rest of the block keeps the image's
    value.  Arrays in ``image`` must own their data (the resolvers' snapshots
    do); they are mutated and the same dict is returned.
    """
    for tb in torn:
        if tb.obj not in image:
            continue
        versions = seq_values.get(tb.seq, {})
        if tb.obj not in versions:
            continue
        dst = image[tb.obj].view(np.uint8).reshape(-1)
        src = np.ascontiguousarray(versions[tb.obj]).view(np.uint8).reshape(-1)
        lo = tb.block * block_bytes
        hi = min(lo + min(int(tb.cut_bytes), block_bytes), dst.size)
        if hi > lo:
            dst[lo:hi] = src[lo:hi]
    return image


def resolve_window_images(
    trace: WindowTrace,
    crash_ts: Sequence[int],
    start_values: Mapping[str, np.ndarray],
    seq_values: Mapping[int, Mapping[str, np.ndarray]],
    block_bytes: int,
    chronic_base: Optional[Mapping[str, np.ndarray]] = None,
    tearing: Optional[Sequence[Optional[Sequence[TornBlock]]]] = None,
) -> Tuple[List[Dict[str, np.ndarray]], List[Dict[str, np.ndarray]]]:
    """Batch form of :func:`resolve_nvm_image` + :func:`resolve_live_values`.

    All crash times of one window are resolved in a single ascending pass
    over the window's write-back records and write sweeps: each record/sweep
    byte range is applied to a running image exactly once, and a snapshot is
    taken at every crash time.  Equivalent to calling the single-shot
    resolvers per crash time (write-backs compose in record order; sweeps
    never overlap in time, so extending the in-flight sweep before applying
    later ones reproduces the per-time application order), but one campaign
    window costs one pass instead of one pass per test.

    ``tearing`` (the fault-model hook): an optional per-crash list of
    :class:`TornBlock` partial-store patches, aligned with ``crash_ts``;
    each is applied to that crash's NVM snapshot only — the running image
    and the other crashes' snapshots are unaffected.

    Returns ``(nvm_images, live_values)`` aligned with ``crash_ts``.
    """
    order = sorted(range(len(crash_ts)), key=lambda i: crash_ts[i])
    nvm_out: List[Optional[Dict[str, np.ndarray]]] = [None] * len(crash_ts)
    live_out: List[Optional[Dict[str, np.ndarray]]] = [None] * len(crash_ts)

    shapes: Dict[str, Tuple[np.dtype, Tuple[int, ...]]] = {}
    nvm_cur: Dict[str, np.ndarray] = {}    # running NVM image, flat uint8
    live_cur: Dict[str, np.ndarray] = {}   # running live image, flat uint8
    for obj, base in start_values.items():
        base = np.asarray(base)
        shapes[obj] = (base.dtype, base.shape)
        nvm_base = _chronic_adjusted_base(trace, obj, base, chronic_base, block_bytes)
        nvm_cur[obj] = np.ascontiguousarray(nvm_base).copy().view(np.uint8).reshape(-1)
        live_cur[obj] = np.ascontiguousarray(base).copy().view(np.uint8).reshape(-1)
    wb_cursor = {obj: 0 for obj in start_values}
    sweep_done = [0] * len(trace.sweeps)

    for idx in order:
        ct = int(crash_ts[idx])
        nvm_snap: Dict[str, np.ndarray] = {}
        for obj in start_values:
            n = int(np.searchsorted(trace.wb_t[obj], ct, side="right"))
            c = wb_cursor[obj]
            if n > c:
                flat = nvm_cur[obj]
                nbytes = flat.size
                blocks = trace.wb_block[obj][c:n].tolist()
                seqs = trace.wb_seq[obj][c:n].tolist()
                for blk, seq in zip(blocks, seqs):
                    src = np.ascontiguousarray(seq_values[seq][obj]).view(np.uint8).reshape(-1)
                    lo = blk * block_bytes
                    hi = min(lo + block_bytes, nbytes)
                    flat[lo:hi] = src[lo:hi]
                wb_cursor[obj] = n
            dtype, shape = shapes[obj]
            nvm_snap[obj] = nvm_cur[obj].copy().view(dtype).reshape(shape)
        if tearing is not None and tearing[idx]:
            apply_torn_blocks(nvm_snap, tearing[idx], seq_values, block_bytes)
        nvm_out[idx] = nvm_snap

        for si, sw in enumerate(trace.sweeps):
            if sw.t_start >= ct:
                break
            if sw.obj not in live_cur:
                continue
            done = min(sw.n_blocks, ct - sw.t_start)
            prev = sweep_done[si]
            if done > prev:
                flat = live_cur[sw.obj]
                src = np.ascontiguousarray(seq_values[sw.seq][sw.obj]).view(np.uint8).reshape(-1)
                lo = prev * block_bytes
                hi = min(done * block_bytes, flat.size)
                if hi > lo:
                    flat[lo:hi] = src[lo:hi]
                sweep_done[si] = done
        live_snap: Dict[str, np.ndarray] = {}
        for obj, flat in live_cur.items():
            dtype, shape = shapes[obj]
            live_snap[obj] = flat.copy().view(dtype).reshape(shape)
        live_out[idx] = live_snap
    return nvm_out, live_out  # type: ignore[return-value]


def resolve_live_values(
    trace: WindowTrace,
    crash_t: int,
    start_values: Mapping[str, np.ndarray],
    seq_values: Mapping[int, Mapping[str, np.ndarray]],
    block_bytes: int,
) -> Dict[str, np.ndarray]:
    """True (cache-inclusive) values at ``crash_t``: all writes applied,
    the in-flight sweep applied partially."""
    out = {o: np.array(v, copy=True) for o, v in start_values.items()}
    for sw in trace.sweeps:
        if sw.t_start >= crash_t:
            break
        if sw.obj not in out:
            continue
        done = min(sw.n_blocks, crash_t - sw.t_start)
        if done <= 0:
            continue
        base = out[sw.obj]
        flat = np.ascontiguousarray(base).copy().view(np.uint8).reshape(-1)
        src = np.ascontiguousarray(seq_values[sw.seq][sw.obj]).view(np.uint8).reshape(-1)
        hi = min(done * block_bytes, flat.size)
        flat[:hi] = src[:hi]
        out[sw.obj] = flat.view(base.dtype).reshape(base.shape)
    return out
