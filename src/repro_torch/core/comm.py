"""Communicator abstraction — the MPI role in the paper's API (§A.2–A.3).

The scda API is collective over an MPI communicator.  This module provides
the minimal collective surface the format needs (barrier / broadcast /
allgather) behind one interface with two implementations:

  * :class:`SerialComm` — one rank; the common case inside a single JAX
    process (all local devices' shards are addressable, one writer).
  * :class:`ThreadComm` — P genuine concurrent ranks backed by threads.
    Used by tests and benchmarks to demonstrate partition-independent
    parallel writes against one shared file, byte-for-byte.

Only *values needed for file layout* travel through these collectives
(section parameters, compressed sizes); bulk data never does — each rank
writes its own windows, which is what makes the design scale to thousands
of nodes.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Sequence


class Communicator:
    """Minimal collective interface (mirrors the paper's mpicomm role)."""

    rank: int = 0
    size: int = 1

    def barrier(self) -> None:
        raise NotImplementedError

    def bcast(self, value: Any, root: int = 0) -> Any:
        raise NotImplementedError

    def allgather(self, value: Any) -> List[Any]:
        raise NotImplementedError

    # Convenience used by the compression path: allgather + flatten.
    def allgather_concat(self, values: Sequence[int]) -> List[int]:
        out: List[int] = []
        for part in self.allgather(list(values)):
            out.extend(part)
        return out


class SerialComm(Communicator):
    """Single rank — the degenerate (but most common) communicator."""

    def __init__(self) -> None:
        self.rank, self.size = 0, 1

    def barrier(self) -> None:
        pass

    def bcast(self, value: Any, root: int = 0) -> Any:
        return value

    def allgather(self, value: Any) -> List[Any]:
        return [value]


class _ThreadGroup:
    """Shared state for one ThreadComm group."""

    def __init__(self, size: int) -> None:
        self.size = size
        self.barrier = threading.Barrier(size)
        self.slots: List[Any] = [None] * size
        self.lock = threading.Lock()


class ThreadComm(Communicator):
    """One rank of a P-rank group executing in threads.

    Construction: ``ThreadComm.group(P)`` returns P communicators sharing
    one barrier; run each rank's workload in its own thread via
    :func:`run_ranks`.
    """

    def __init__(self, group: _ThreadGroup, rank: int) -> None:
        self._g = group
        self.rank = rank
        self.size = group.size

    @staticmethod
    def group(size: int) -> List["ThreadComm"]:
        g = _ThreadGroup(size)
        return [ThreadComm(g, r) for r in range(size)]

    def barrier(self) -> None:
        self._g.barrier.wait()

    def bcast(self, value: Any, root: int = 0) -> Any:
        if self.rank == root:
            self._g.slots[root] = value
        self._g.barrier.wait()
        out = self._g.slots[root]
        self._g.barrier.wait()
        return out

    def allgather(self, value: Any) -> List[Any]:
        self._g.slots[self.rank] = value
        self._g.barrier.wait()
        out = list(self._g.slots)
        self._g.barrier.wait()
        return out


def run_ranks(comms: Sequence[ThreadComm],
              fn: Callable[[ThreadComm], Any],
              timeout: Optional[float] = 60.0) -> List[Any]:
    """Run ``fn(comm)`` on every rank concurrently; re-raise any failure.

    A failing rank breaks the shared barrier so siblings do not deadlock.
    """
    results: List[Any] = [None] * len(comms)
    errors: List[BaseException] = []

    def _target(i: int, c: ThreadComm) -> None:
        try:
            results[i] = fn(c)
        except BaseException as e:  # noqa: BLE001 - propagated below
            errors.append(e)
            c._g.barrier.abort()

    threads = [threading.Thread(target=_target, args=(i, c), daemon=True)
               for i, c in enumerate(comms)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if errors:
        raise errors[0]
    return results

