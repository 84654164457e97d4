"""Fault-tolerant work scheduling for the embarrassingly parallel ABC layer
(port: a copy of `repro.runtime.scheduler`, pure Python, imported by
neither package from the other).

The unit of work is a (base_seed, chunk_id) pair: any worker can compute any
chunk deterministically, so the scheduler needs no data movement to recover
from failures — exactly the property the paper's scaling study relies on
(§4.5). This module provides the cluster-control logic that the paper's
TensorFlow implementation kept implicit:

  * ChunkLedger        — which chunks are done / in-flight / lost
  * WorkerPool         — worker health via heartbeats; failures re-enqueue
                         their in-flight chunks
  * straggler policy   — over-decomposition + speculative duplicates of the
                         slowest tail (classic backup-task mitigation)

On this container workers are simulated actors driven by `tick()`; on a real
pod the same ledger runs in the coordinator with heartbeats over RPC. The
logic is pure-python and fully unit-tested (tests/test_runtime.py, and
tests/test_torch_runtime.py for this copy).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set


@dataclasses.dataclass
class ChunkLedger:
    """Tracks chunk lifecycle. Chunks are ints 0..n-1."""

    n_chunks: int
    done: Set[int] = dataclasses.field(default_factory=set)
    in_flight: Dict[int, Set[str]] = dataclasses.field(default_factory=dict)
    pending: List[int] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if not self.pending and not self.done:
            self.pending = list(range(self.n_chunks))

    def next_chunk(self, worker: str, speculate: bool = False) -> Optional[int]:
        while self.pending:
            c = self.pending.pop(0)
            if c in self.done:
                continue
            self.in_flight.setdefault(c, set()).add(worker)
            return c
        if speculate:
            # speculative duplicate of an in-flight chunk (straggler backup)
            for c, owners in self.in_flight.items():
                if c not in self.done and worker not in owners and len(owners) == 1:
                    owners.add(worker)
                    return c
        return None

    def complete(self, chunk: int) -> bool:
        """Returns True if this completion was the FIRST for the chunk."""
        first = chunk not in self.done
        self.done.add(chunk)
        self.in_flight.pop(chunk, None)
        return first

    def lose_worker(self, worker: str):
        """Re-enqueue chunks whose only owner died."""
        for c in list(self.in_flight):
            owners = self.in_flight[c]
            owners.discard(worker)
            if not owners and c not in self.done:
                del self.in_flight[c]
                self.pending.insert(0, c)

    @property
    def finished(self) -> bool:
        return len(self.done) >= self.n_chunks

    def to_state(self) -> dict:
        return {"n_chunks": self.n_chunks, "done": sorted(self.done)}

    @staticmethod
    def from_state(state: dict) -> "ChunkLedger":
        led = ChunkLedger(n_chunks=state["n_chunks"])
        led.done = set(state["done"])
        led.pending = [c for c in range(led.n_chunks) if c not in led.done]
        return led


@dataclasses.dataclass
class WorkerPool:
    """Heartbeat-based liveness. Workers that miss `timeout` ticks are
    declared dead and their chunks re-enqueued."""

    timeout: float = 3.0
    last_beat: Dict[str, float] = dataclasses.field(default_factory=dict)

    def heartbeat(self, worker: str, now: float):
        self.last_beat[worker] = now

    def dead_workers(self, now: float) -> List[str]:
        return [w for w, t in self.last_beat.items() if now - t > self.timeout]

    def remove(self, worker: str):
        self.last_beat.pop(worker, None)


class WorkScheduler:
    """Coordinator gluing ledger + pool + straggler policy.

    `speculate_after`: once pending is empty, workers receive speculative
    duplicates of in-flight chunks — the fastest completion wins, bounding
    the straggler tail at ~1 chunk latency instead of the slowest worker.
    """

    def __init__(self, n_chunks: int, timeout: float = 3.0, ledger=None):
        self.ledger = ledger or ChunkLedger(n_chunks)
        self.pool = WorkerPool(timeout=timeout)
        self.duplicates_issued = 0
        self.wasted_completions = 0

    def request_work(self, worker: str, now: float) -> Optional[int]:
        self.pool.heartbeat(worker, now)
        self._reap(now)
        chunk = self.ledger.next_chunk(worker, speculate=False)
        if chunk is None and not self.ledger.finished:
            chunk = self.ledger.next_chunk(worker, speculate=True)
            if chunk is not None:
                self.duplicates_issued += 1
        return chunk

    def report_done(self, worker: str, chunk: int, now: float):
        self.pool.heartbeat(worker, now)
        if not self.ledger.complete(chunk):
            self.wasted_completions += 1

    def _reap(self, now: float):
        for w in self.pool.dead_workers(now):
            self.pool.remove(w)
            self.ledger.lose_worker(w)

    @property
    def finished(self) -> bool:
        return self.ledger.finished
