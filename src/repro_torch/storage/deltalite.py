"""DeltaLite: a log-structured ACID table with time travel and a CAS index
(the port's copy of ``repro/storage/deltalite.py``, same on-disk format, so
either package reads a table the other wrote).

* **segments**: immutable gzip'd JSON-lines files,
* **transaction log**: ``_log/NNNNNNNN.json`` entries, one per commit,
  listing segment adds/removes.  Commits are atomic via a hard link onto
  the next version file — optimistic concurrency: losers retry with the
  next version number,
* **time travel**: a read at version V replays log entries <= V,
* **CAS index**: each commit records the set of ``key_column`` values in
  its segments, so point lookups prune segments without scanning them.

A writer dying after writing a segment but before its log commit leaves an
unreferenced file: the table never observes partial state.
"""

from __future__ import annotations

import gzip
import json
import os
import random
import time
import uuid
from typing import Iterable


class CommitConflict(Exception):
    """Another writer committed this version first; retry."""


#: optimistic-concurrency retry budget.  Every lost race means another
#: writer committed (global progress), but a single writer can starve
#: under heavy contention — the budget plus jittered backoff below keeps
#: many concurrent chunk committers from spinning against each other.
COMMIT_RETRIES = 50


def _conflict_backoff(attempt: int) -> None:
    """Tiny jittered sleep after a lost version race: de-synchronizes
    writers that keep colliding on the same next-version number."""
    time.sleep(random.uniform(0.0, 0.002) * min(attempt + 1, 8))


class DeltaLite:
    def __init__(self, path: str, key_column: str | None = None):
        self.path = path
        self.key_column = key_column
        # monotone scan hint: versions are append-only, so latest_version
        # can resume from the last one seen instead of walking from 0 —
        # O(new versions) instead of O(all versions) per call, which keeps
        # concurrent committers from bunching up on long logs.  Benign
        # under races: the hint only ever lags the truth.
        self._version_hint = -1
        os.makedirs(os.path.join(path, "_log"), exist_ok=True)
        os.makedirs(os.path.join(path, "data"), exist_ok=True)

    # -- log plumbing ---------------------------------------------------------

    def _log_dir(self) -> str:
        return os.path.join(self.path, "_log")

    def _version_path(self, v: int) -> str:
        return os.path.join(self._log_dir(), f"{v:08d}.json")

    def latest_version(self) -> int:
        """Highest contiguous committed version (-1 = empty table)."""
        v = self._version_hint
        while os.path.exists(self._version_path(v + 1)):
            v += 1
        self._version_hint = v
        return v

    def _read_log(self, version: int | None = None) -> list[dict]:
        last = self.latest_version() if version is None else version
        entries = []
        for v in range(last + 1):
            with open(self._version_path(v)) as f:
                entries.append(json.load(f))
        return entries

    def _live_segments(self, version: int | None = None) -> list[dict]:
        live: dict[str, dict] = {}
        for entry in self._read_log(version):
            for add in entry.get("add", []):
                live[add["file"]] = add
            for rm in entry.get("remove", []):
                live.pop(rm, None)
        return list(live.values())

    # -- writes -----------------------------------------------------------------

    def _write_segment(self, rows: list[dict]) -> dict:
        name = f"part-{uuid.uuid4().hex}.jsonl.gz"
        fpath = os.path.join(self.path, "data", name)
        with gzip.open(fpath, "wt") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
        seg = {"file": name, "rows": len(rows)}
        if self.key_column:
            seg["keys"] = sorted({str(r[self.key_column]) for r in rows})
        return seg

    def _commit(
        self, entry: dict, retries: int = COMMIT_RETRIES, precheck=None
    ) -> int | None:
        """Atomic commit: the fully-written entry is published with a hard
        link, so a concurrent reader can never observe a partial log file;
        losers of the version race get FileExistsError and retry.

        ``precheck(v)`` (optional) runs before each attempt against the
        table state at version ``v - 1`` — the state the successful link
        at ``v`` linearizes after; returning False abandons the commit
        (returns None).  Conditional appends build on this single copy of
        the publish protocol.
        """
        for attempt in range(retries):
            v = self.latest_version() + 1
            if precheck is not None and not precheck(v):
                return None
            entry["version"] = v
            entry["timestamp"] = time.time()
            tmp = self._version_path(v) + f".{uuid.uuid4().hex}.tmp"
            with open(tmp, "w") as f:
                json.dump(entry, f)
            try:
                os.link(tmp, self._version_path(v))
                return v
            except FileExistsError:
                _conflict_backoff(attempt)
                continue  # lost the race; re-read latest and retry
            finally:
                os.unlink(tmp)
        raise CommitConflict(f"could not commit after {retries} attempts")

    def append(self, rows: Iterable[dict]) -> int:
        """Append rows as one new segment; returns the committed version."""
        rows = list(rows)
        if not rows:
            return self.latest_version()
        seg = self._write_segment(rows)
        return self._commit({"add": [seg], "remove": []})

    def append_if_absent(
        self, rows: Iterable[dict], retries: int = COMMIT_RETRIES
    ) -> int | None:
        """First-committer-wins conditional append: commit the rows only if
        none of their ``key_column`` values are already live in the table.

        The absence check runs against the table state immediately preceding
        the version we try to claim, and the ``O_CREAT|O_EXCL``-style link is
        the linearization point: if another writer claims that version first
        we lose the race, re-read, and re-check — so two writers racing on
        the same key can never both commit it.  Returns the committed
        version, or ``None`` if a key was already taken (the written segment
        is unlinked; losers leave no garbage, even when the retry budget is
        exhausted).
        """
        assert self.key_column, "append_if_absent requires a key_column"
        rows = list(rows)
        if not rows:
            return self.latest_version()
        keys = {str(r[self.key_column]) for r in rows}
        if keys & self.keys():  # cheap fast path: skip the segment write
            return None
        seg = self._write_segment(rows)

        def absent(v: int) -> bool:
            return not (keys & self.keys(version=v - 1))

        version: int | None = None
        try:
            version = self._commit(
                {"add": [seg], "remove": []}, retries=retries, precheck=absent
            )
        finally:
            if version is None:  # lost the key race or exhausted retries
                os.unlink(os.path.join(self.path, "data", seg["file"]))
        return version

    def overwrite(self, rows: Iterable[dict]) -> int:
        """Replace the table contents (old versions stay readable)."""
        seg = self._write_segment(list(rows))
        current = [s["file"] for s in self._live_segments()]
        return self._commit({"add": [seg], "remove": current})

    def compact(self) -> int:
        """Merge all live segments into one (latest-wins on the key column)."""
        rows = self.read()
        if self.key_column:
            dedup: dict[str, dict] = {}
            for r in rows:
                dedup[str(r[self.key_column])] = r
            rows = list(dedup.values())
        seg = self._write_segment(rows)
        current = [s["file"] for s in self._live_segments()]
        return self._commit({"add": [seg], "remove": current})

    # -- reads --------------------------------------------------------------------

    def _read_segment(self, name: str) -> list[dict]:
        fpath = os.path.join(self.path, "data", name)
        with gzip.open(fpath, "rt") as f:
            return [json.loads(line) for line in f if line.strip()]

    def read(self, version: int | None = None) -> list[dict]:
        """Full scan at a version (time travel when ``version`` is given)."""
        rows: list[dict] = []
        for seg in self._live_segments(version):
            rows.extend(self._read_segment(seg["file"]))
        return rows

    def lookup(self, key: str, version: int | None = None) -> dict | None:
        """CAS point lookup: latest row whose key_column equals ``key``."""
        assert self.key_column, "lookup requires a key_column"
        hit: dict | None = None
        for seg in self._live_segments(version):
            keys = seg.get("keys")
            if keys is not None and str(key) not in keys:
                continue  # pruned without reading the segment
            for row in self._read_segment(seg["file"]):
                if str(row[self.key_column]) == str(key):
                    hit = row  # later segments win
        return hit

    def keys(self, version: int | None = None) -> set[str]:
        out: set[str] = set()
        for seg in self._live_segments(version):
            if seg.get("keys") is not None:
                out.update(seg["keys"])
            else:
                out.update(
                    str(r[self.key_column]) for r in self._read_segment(seg["file"])
                )
        return out

    def history(self) -> list[dict]:
        """Commit log (version, timestamp, files added/removed)."""
        return [
            {
                "version": e["version"],
                "timestamp": e["timestamp"],
                "added": [a["file"] for a in e.get("add", [])],
                "removed": e.get("remove", []),
            }
            for e in self._read_log()
        ]
