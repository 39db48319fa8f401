"""Resumable chunk spill (the port of ``repro/storage/spill.py``):
per-chunk partial results on a DeltaLite table.  The port's
:class:`~repro_torch.storage.deltalite.DeltaLite` has the reference's
on-disk format, so a manifest written by either package resumes in the
other.

A streaming run commits one manifest row per completed chunk — the chunk's
mergeable accumulator states (:mod:`repro_torch.stats.streaming`), failure
sample, and stage stats — as a single DeltaLite commit.  The ACID log
gives the two properties resume needs for free:

* **atomicity** — a chunk is either fully committed (segment + log entry)
  or invisible; a process dying mid-chunk leaves at most an orphaned,
  unreferenced segment file (crash safety inherited from DeltaLite);
* **concurrency** — two processes racing on the same table retry through
  optimistic concurrency; duplicate rows for a chunk are resolved
  latest-wins on the ``chunk_id`` key column.

A restarted run reads the manifest, merges the committed partial states,
and skips those chunks entirely — no re-inference, no re-scoring.  Each
run is isolated under ``<root>/<run_key>`` (the task fingerprint), so a
changed task config never resumes from stale chunks.
"""

from __future__ import annotations

import os

from repro_torch.storage.deltalite import DeltaLite


class ChunkManifest:
    #: reserved (negative) chunk_id keys for run-level adaptive metadata:
    #: the certification-regime row (stopping-rule fingerprint, written
    #: before the first chunk of an adaptive run) and the stop-decision
    #: row (written exactly once, when the rule fires).  Kept in the same
    #: ACID table as the chunk rows so a stop commit is atomic with the
    #: chunk commits it summarizes.
    REGIME_KEY = -2
    STOP_KEY = -1

    def __init__(self, root: str, run_key: str):
        self.run_key = run_key
        self.path = os.path.join(root, run_key)
        self.table = DeltaLite(self.path, key_column="chunk_id")

    def completed(self) -> dict[int, dict]:
        """chunk_id -> committed state row (latest wins on duplicates).
        Reserved metadata rows (negative ids) are excluded — read them
        through :meth:`stop_row` / :meth:`regime_row`."""
        out: dict[int, dict] = {}
        for row in self.table.read():
            if row.get("run_key") == self.run_key and int(row["chunk_id"]) >= 0:
                out[int(row["chunk_id"])] = row
        return out

    def record(self, chunk_id: int, state: dict) -> int:
        """Commit one completed chunk; returns the manifest version."""
        return self.table.append(
            [{"chunk_id": chunk_id, "run_key": self.run_key, **state}]
        )

    def try_record(self, chunk_id: int, state: dict) -> bool:
        """First-committer-wins commit for concurrent chunk workers.

        A speculatively re-issued chunk races its original attempt here:
        exactly one attempt commits a manifest row (``True``); the loser's
        row is discarded atomically by DeltaLite's conditional append
        (``False``) and its partial state must not be merged — the
        committed row is the canonical result for the chunk.
        """
        return (
            self.table.append_if_absent(
                [{"chunk_id": chunk_id, "run_key": self.run_key, **state}]
            )
            is not None
        )

    def get(self, chunk_id: int) -> dict | None:
        """Committed row for one chunk (CAS point lookup), or None."""
        row = self.table.lookup(str(chunk_id))
        if row is not None and row.get("run_key") != self.run_key:
            return None
        return row

    # -- adaptive-run metadata rows -------------------------------------------

    def regime_row(self) -> dict | None:
        """The committed certification-regime row, or None."""
        return self.get(self.REGIME_KEY)

    def try_record_regime(self, state: dict) -> bool:
        """First-committer-wins commit of the certification regime (the
        stopping-rule fingerprint).  Exactly one regime row ever exists;
        racing adaptive runs resolve through the conditional append and
        losers re-read and validate."""
        return self.try_record(self.REGIME_KEY, state)

    def stop_row(self) -> dict | None:
        """The committed stop decision, or None (run never stopped)."""
        return self.get(self.STOP_KEY)

    def try_record_stop(self, state: dict) -> bool:
        """First-committer-wins commit of the stop decision.  The stop
        point is part of the resume contract: once committed, every resume
        terminates at exactly this chunk and never re-opens sampling."""
        return self.try_record(self.STOP_KEY, state)
