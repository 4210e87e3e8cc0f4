"""Distributed Transaction Management (paper §3.2.1, "DTM").

Groups of storage updates that are atomic with respect to failures.  As in
Mero, transaction control is separated from concurrency control: the DTM
only guarantees crash-atomicity of an update *group* via a write-ahead log
+ object versioning; isolation is the caller's concern (the checkpoint
writer is single-owner per object).

Protocol:
  1. ``begin`` appends an intent record (txid + touched entities).
  2. Object writes inside the txn go to *next-version* block keys —
     the current version stays fully readable throughout.
  3. ``commit`` appends a commit record, then atomically flips the
     per-object version pointers (metadata persist).
  4. Crash before commit: recovery finds intents without commit records
     and garbage-collects orphaned next-version blocks.  The previous
     checkpoint/object state is untouched — this is what makes partial
     checkpoint failures safe (tested in tests/test_transactions.py).
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Set


@dataclass
class TxnRecord:
    txid: int
    state: str                     # intent | committed | aborted
    entities: List[str] = field(default_factory=list)
    ts: float = 0.0


class WriteAheadLog:
    """Append-only JSONL WAL with fsync on commit records."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()

    def append(self, rec: Dict[str, Any], fsync: bool = False):
        line = json.dumps(rec, separators=(",", ":")) + "\n"
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line)
                if fsync:
                    f.flush()
                    os.fsync(f.fileno())

    def replay(self) -> Dict[int, TxnRecord]:
        txns: Dict[int, TxnRecord] = {}
        if not self.path.exists():
            return txns
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue          # torn tail write: ignore
                txid = rec["txid"]
                if rec["kind"] == "intent":
                    txns[txid] = TxnRecord(txid, "intent",
                                           rec.get("entities", []),
                                           rec.get("ts", 0.0))
                elif rec["kind"] == "commit" and txid in txns:
                    txns[txid].state = "committed"
                elif rec["kind"] == "abort" and txid in txns:
                    txns[txid].state = "aborted"
        return txns

    def truncate(self):
        with self._lock:
            if self.path.exists():
                self.path.unlink()


class TransactionManager:
    def __init__(self, wal: WriteAheadLog):
        self.wal = wal
        self._next = int(time.time() * 1000) % 10_000_000
        self._lock = threading.Lock()
        self.active: Set[int] = set()

    def begin(self, entities: List[str]) -> int:
        with self._lock:
            txid = self._next
            self._next += 1
            self.active.add(txid)
        self.wal.append({"kind": "intent", "txid": txid,
                         "entities": entities, "ts": time.time()})
        return txid

    def commit(self, txid: int):
        self.wal.append({"kind": "commit", "txid": txid, "ts": time.time()},
                        fsync=True)
        with self._lock:
            self.active.discard(txid)

    def abort(self, txid: int):
        self.wal.append({"kind": "abort", "txid": txid, "ts": time.time()})
        with self._lock:
            self.active.discard(txid)

    def incomplete(self) -> List[TxnRecord]:
        """Intent-only transactions found in the WAL (crash recovery)."""
        return [t for t in self.wal.replay().values() if t.state == "intent"]


class Transaction:
    """Context manager binding object writes to one atomic group."""

    def __init__(self, mgr: TransactionManager, entities: List[str],
                 on_commit: Optional[Callable[[], None]] = None,
                 on_abort: Optional[Callable[[], None]] = None):
        self.mgr = mgr
        self.entities = entities
        self.txid: Optional[int] = None
        self._on_commit = on_commit
        self._on_abort = on_abort

    def __enter__(self) -> "Transaction":
        self.txid = self.mgr.begin(self.entities)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            if self._on_commit:
                self._on_commit()
            self.mgr.commit(self.txid)
        else:
            if self._on_abort:
                self._on_abort()
            self.mgr.abort(self.txid)
        return False
