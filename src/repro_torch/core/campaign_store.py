# Port copy of repro/core/campaign_store.py, unchanged apart from this header; its relative imports resolve inside repro_torch.
"""Append-only JSONL result stores for crash campaigns and workflows.

Two stores share one file discipline:

* :class:`CampaignStore` — one campaign per file: a header line with the
  campaign fingerprint, then one line per completed *shard* (all crash tests
  whose crash point falls in the same crash window).
* :class:`WorkflowStore` — one §5.3 workflow per file: a workflow header,
  one ``campaign`` line per member campaign (baseline, persist-everywhere
  "best", and the per-region isolated campaigns) carrying that campaign's
  fingerprint, and shard lines tagged with their campaign key.  This is what
  lets a killed ``run_workflow`` resume executing only the shards that never
  landed — across *all* of its campaigns, not just the one that was running.

Durability contract: every append is flushed **and fsynced** before the call
returns (a shard reported "completed" has reached the device, not just the
page cache), and the directory entry is fsynced when the file is first
created.  The file is only ever appended to, so the worst a crash can leave
behind is one torn *trailing* line — the loader tolerates exactly that and
nothing else.  An undecodable line in the middle of the file is not a torn
append, it is corruption, and silently dropping it would silently drop a
shard's results from a resumed campaign; the loader raises
:class:`CampaignStoreError` instead.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
from typing import Dict, List, Mapping, Optional, Tuple

from .crash_tester import CrashRecord
from .durable import fsync_dir

#: bump when the shard record layout changes; mismatching stores are rejected
STORE_VERSION = 1


class CampaignStoreError(RuntimeError):
    """Raised when a store exists but belongs to a different campaign, or
    when its contents are corrupt beyond the tolerated torn trailing line."""


def record_to_dict(record: CrashRecord) -> dict:
    d = dataclasses.asdict(record)
    # unit importance weight is the (historical) default: elide it, so every
    # uniform campaign's stored lines are byte-identical to pre-weight stores
    if d.get("weight") == 1.0:
        d.pop("weight")
    return d


def record_from_dict(d: Mapping[str, object]) -> CrashRecord:
    return CrashRecord(
        iter_idx=int(d["iter_idx"]),
        region_idx=int(d["region_idx"]),
        frac=float(d["frac"]),
        inconsistency={k: float(v) for k, v in dict(d["inconsistency"]).items()},
        outcome=str(d["outcome"]),
        extra_iters=int(d["extra_iters"]),
        verify_metric=float(d["verify_metric"]),
        weight=float(d.get("weight", 1.0)),
    )


def _json_roundtrip(obj: dict) -> dict:
    """The stored header went through JSON; compare live dicts in JSON space
    (tuples become lists, int keys become strings, ...)."""
    return json.loads(json.dumps(obj))


class _JsonlStore:
    """Shared JSONL plumbing: strict reads, torn-tail repair, fsynced appends."""

    def __init__(self, path: str):
        self.path = path
        # parsed-line cache keyed by (mtime_ns, size): a resumed workflow
        # consults the store several times (header validation, one batch
        # registration per stage, progress accounting) and each would
        # otherwise re-decode the full file.  Appends go through _append,
        # which changes the stat signature and so invalidates naturally.
        self._cache: Optional[Tuple[Tuple[int, int], List[dict]]] = None

    # ------------------------------------------------------------------ read
    def _stat_sig(self) -> Optional[Tuple[int, int]]:
        try:
            st = os.stat(self.path)
        except FileNotFoundError:
            return None
        return (st.st_mtime_ns, st.st_size)

    def _read_lines(self) -> List[dict]:
        """Decode every line of the store (cached per file state).

        Callers must treat the returned list and dicts as read-only.

        Tolerates exactly one undecodable *trailing* line (a crash mid-append
        tears at most the final line; the torn shard simply re-executes).  An
        undecodable line followed by more data cannot be a torn append —
        appends are fsynced in order — so it is treated as corruption and
        raised, never silently dropped.
        """
        sig = self._stat_sig()
        if sig is None:
            return []
        if self._cache is not None and self._cache[0] == sig:
            return self._cache[1]
        out: List[dict] = []
        # bytes, decoded per line: a torn append can cut a multi-byte UTF-8
        # character, which must be handled like any other torn tail rather
        # than crash the reader with UnicodeDecodeError
        with io.open(self.path, "rb") as f:
            raw = [ln.strip() for ln in f.read().split(b"\n")]
        # trailing blank lines are not data
        while raw and not raw[-1]:
            raw.pop()
        for i, line in enumerate(raw):
            if not line:
                continue
            try:
                obj = json.loads(line.decode("utf-8"))
            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                if i == len(raw) - 1:
                    continue  # torn trailing line: discard, shard re-executes
                raise CampaignStoreError(
                    f"{self.path}: undecodable line {i + 1} of {len(raw)} — "
                    f"mid-file corruption, refusing to silently drop a shard "
                    f"({e})"
                ) from None
            if not isinstance(obj, dict):
                # our appends only ever write objects; a decodable non-dict
                # line cannot be a torn prefix of one (prefixes never decode)
                raise CampaignStoreError(
                    f"{self.path}: line {i + 1} of {len(raw)} is not a JSON "
                    f"object — foreign or corrupt store content"
                )
            out.append(obj)
        self._cache = (sig, out)
        return out

    # ----------------------------------------------------------------- write
    def _repair_torn_tail(self) -> None:
        """Repair an unterminated final line left by a crash mid-append.

        Two cases, matching exactly what :meth:`_read_lines` accepts:

        * the tail *decodes* — every byte of the line landed except the
          newline (a proper prefix of a serialized JSON object can never
          itself decode, so a decodable tail is necessarily complete): the
          reader already treats it as valid data, so terminate it;
        * the tail does not decode — torn: truncate it.  Truncating — not
          newline-terminating — matters here: terminated garbage would be
          buried mid-file by the next append and poison every later read.
        """
        if os.path.getsize(self.path) == 0:
            return
        with io.open(self.path, "rb+") as f:
            f.seek(-1, os.SEEK_END)
            if f.read(1) == b"\n":
                return
            f.seek(0)
            data = f.read()
            cut = data.rfind(b"\n") + 1
            try:
                complete = isinstance(json.loads(data[cut:].decode("utf-8")), dict)
            except (json.JSONDecodeError, UnicodeDecodeError):
                complete = False
            if complete:
                f.write(b"\n")  # complete line, only the newline was lost
            else:
                f.truncate(cut)
            f.flush()
            os.fsync(f.fileno())

    def _append(self, obj: dict) -> None:
        created = not os.path.exists(self.path)
        if not created:
            self._repair_torn_tail()
        with io.open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps(obj) + "\n")
            f.flush()
            os.fsync(f.fileno())
        if created:
            # the file's directory entry must survive the crash too
            fsync_dir(os.path.dirname(os.path.abspath(self.path)))


class CampaignStore(_JsonlStore):
    """JSONL store bound to one campaign.

    Typical use is through ``CrashTester.run_campaign(store_path=...)``; the
    class is public so benchmarks can inspect partial campaigns.
    """

    def header(self) -> Optional[dict]:
        lines = self._read_lines()
        if lines and lines[0].get("type") == "header":
            return lines[0]
        return None

    def completed_shards(self) -> Dict[int, List[Tuple[int, CrashRecord]]]:
        """shard_id -> [(original test index, record)], later lines win."""
        shards: Dict[int, List[Tuple[int, CrashRecord]]] = {}
        for line in self._read_lines():
            if line.get("type") != "shard":
                continue
            shards[int(line["shard"])] = [
                (int(i), record_from_dict(r)) for i, r in line["records"]
            ]
        return shards

    def load_or_create(self, fingerprint: dict) -> Dict[int, List[Tuple[int, CrashRecord]]]:
        """Validate/initialise the store; return already-completed shards.

        * no file (or empty file): write the header, return ``{}``;
        * matching header: return the completed shards to skip;
        * mismatching header: raise :class:`CampaignStoreError` — a store is
          bound to exactly one campaign, silently mixing results would
          corrupt the resumed ``CampaignResult``.
        """
        existing = self.header()
        if existing is None:
            if self._read_lines():
                raise CampaignStoreError(
                    f"{self.path}: not a campaign store (no header line)"
                )
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            self._append({"type": "header", **fingerprint})
            return {}
        found = {k: existing.get(k) for k in fingerprint}
        # legacy headers predate pluggable fault models; those campaigns ran
        # under the clean-power-fail semantics, so a missing "fault" key
        # means exactly that — old stores stay resumable with the default
        # model (and still refuse any other)
        if "fault" in fingerprint and found.get("fault") is None:
            found["fault"] = {"model": "power-fail"}
        if found != _json_roundtrip(dict(fingerprint)):
            raise CampaignStoreError(
                f"{self.path}: store belongs to a different campaign\n"
                f"  store:    {found}\n  campaign: {fingerprint}"
            )
        return self.completed_shards()

    def append_shard(self, shard_id: int, records: List[Tuple[int, CrashRecord]]) -> None:
        self._append({
            "type": "shard",
            "shard": int(shard_id),
            "records": [(int(i), record_to_dict(r)) for i, r in records],
        })


class WorkflowStore(_JsonlStore):
    """JSONL store for a whole §5.3 workflow: many campaigns, one file.

    Line taxonomy:

    * ``{"type": "workflow-header", **workflow_fingerprint}`` — first line;
      binds the file to one ``run_workflow`` invocation (app, problem data,
      seed, test count, cache, fault model, selection parameters);
    * ``{"type": "campaign", "key": K, "fingerprint": {...}}`` — registers
      member campaign ``K`` (``"baseline"``, ``"best"``, ``"region:3"``)
      with its full campaign fingerprint.  A resumed workflow whose
      recomputed campaign fingerprint differs (e.g. the critical-object set
      changed because the code changed) refuses the store rather than mixing
      incompatible shard results;
    * ``{"type": "shard", "campaign": K, "shard": S, "records": [...]}`` —
      one completed shard of campaign ``K``.
    """

    def header(self) -> Optional[dict]:
        lines = self._read_lines()
        if lines and lines[0].get("type") == "workflow-header":
            return lines[0]
        return None

    def load_or_create(self, fingerprint: dict) -> None:
        """Validate the workflow header (write it if the store is new)."""
        existing = self.header()
        if existing is None:
            if self._read_lines():
                raise CampaignStoreError(
                    f"{self.path}: not a workflow store (no workflow-header)"
                )
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            self._append({"type": "workflow-header", **fingerprint})
            return
        found = {k: existing.get(k) for k in fingerprint}
        if found != _json_roundtrip(dict(fingerprint)):
            raise CampaignStoreError(
                f"{self.path}: store belongs to a different workflow\n"
                f"  store:    {found}\n  workflow: {fingerprint}"
            )

    def campaign_fingerprints(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for line in self._read_lines():
            if line.get("type") == "campaign":
                out[str(line["key"])] = dict(line["fingerprint"])
        return out

    def register_campaigns(
        self, fingerprints: Mapping[str, dict]
    ) -> Dict[str, Dict[int, List[Tuple[int, CrashRecord]]]]:
        """Bind every campaign in ``fingerprints`` to the store; return each
        campaign's completed shards (empty for fresh campaigns, raising on
        any fingerprint clash).

        One pass over the file for the whole batch: a resumed isolated-mode
        workflow registers W+2 campaigns against a store holding every crash
        record, so decoding the file once per *registration* would cost
        O(campaigns x store size) before any shard executes.
        """
        existing_fp: Dict[str, dict] = {}
        shards: Dict[str, Dict[int, List[Tuple[int, CrashRecord]]]] = {}
        for line in self._read_lines():
            t = line.get("type")
            if t == "campaign":
                existing_fp[str(line["key"])] = dict(line["fingerprint"])
            elif t == "shard":
                shards.setdefault(str(line["campaign"]), {})[int(line["shard"])] = [
                    (int(i), record_from_dict(r)) for i, r in line["records"]
                ]
        out: Dict[str, Dict[int, List[Tuple[int, CrashRecord]]]] = {}
        for key, fingerprint in fingerprints.items():
            existing = existing_fp.get(str(key))
            if existing is None:
                self._append({
                    "type": "campaign", "key": str(key),
                    "fingerprint": dict(fingerprint),
                })
                out[str(key)] = {}
            elif existing != _json_roundtrip(dict(fingerprint)):
                raise CampaignStoreError(
                    f"{self.path}: campaign {key!r} in store does not match "
                    f"the resumed workflow\n  store:    {existing}\n"
                    f"  campaign: {fingerprint}"
                )
            else:
                out[str(key)] = shards.get(str(key), {})
        return out

    def register_campaign(
        self, key: str, fingerprint: dict
    ) -> Dict[int, List[Tuple[int, CrashRecord]]]:
        """Single-campaign convenience wrapper over :meth:`register_campaigns`."""
        return self.register_campaigns({key: fingerprint})[str(key)]

    def completed_shards(self, key: str) -> Dict[int, List[Tuple[int, CrashRecord]]]:
        """shard_id -> [(original test index, record)] for campaign ``key``."""
        return self.completed_shards_by_campaign().get(key, {})

    def completed_shards_by_campaign(
        self,
    ) -> Dict[str, Dict[int, List[Tuple[int, CrashRecord]]]]:
        """campaign key -> {shard_id -> records}, in one pass over the file."""
        out: Dict[str, Dict[int, List[Tuple[int, CrashRecord]]]] = {}
        for line in self._read_lines():
            if line.get("type") != "shard":
                continue
            out.setdefault(str(line["campaign"]), {})[int(line["shard"])] = [
                (int(i), record_from_dict(r)) for i, r in line["records"]
            ]
        return out

    def append_shard(
        self, key: str, shard_id: int, records: List[Tuple[int, CrashRecord]]
    ) -> None:
        self._append({
            "type": "shard",
            "campaign": str(key),
            "shard": int(shard_id),
            "records": [(int(i), record_to_dict(r)) for i, r in records],
        })
