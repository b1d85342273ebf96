"""Copy of evostencils_tpu/parallel/comm.py:39-146 (the communicators that
need no JAX runtime), kept in the port so that it imports nothing of the
JAX package.

Host-level collectives for population-parallel evolution.  Two
implementations:

* :class:`NullCommunicator` — single-process fallback, every collective is
  the identity (mirrors the reference's ``mpi_comm is None`` path);
* :class:`ThreadCommunicator` — N in-process ranks over a shared mailbox,
  for tests and single-host island runs.

The optimizer keeps populations replicated: every rank runs the identical
generation/selection stream (same rng seed), only *evaluation* is
partitioned ``pending[rank::size]`` and the (tree-string, fitness) pairs
are allgathered — evaluation cost divides by the rank count while ranks
stay mutually consistent.

Not copied: ``JaxProcessCommunicator`` and ``initialize_multihost``, which
ride the JAX runtime.  Their counterpart over ``torch.distributed`` is a
later slice, so :func:`default_communicator` returns the no-op.
"""

from __future__ import annotations

import threading
from typing import Any, List, Sequence


class Communicator:
    """Interface: rank/size + object collectives."""

    rank: int = 0
    size: int = 1

    def allgather_object(self, obj: Any) -> List[Any]:
        """Gather one Python object per rank, returned in rank order."""
        raise NotImplementedError

    def broadcast_object(self, obj: Any, root: int = 0) -> Any:
        return self.allgather_object(obj)[root]

    def allreduce_sum(self, value: float) -> float:
        return float(sum(self.allgather_object(float(value))))

    def barrier(self) -> None:
        self.allgather_object(None)

    def shard(self, seq: Sequence) -> list:
        """This rank's strided slice of a replicated work list."""
        return list(seq[self.rank::self.size])

    def allgather_shards(self, local: Sequence) -> list:
        """Inverse of :meth:`shard`: reassemble the full list in original
        order from every rank's strided shard."""
        shards = self.allgather_object(list(local))
        total = sum(len(s) for s in shards)
        out: List[Any] = [None] * total
        for r, shard in enumerate(shards):
            out[r::self.size] = shard
        return out


class NullCommunicator(Communicator):
    """Single-process no-op communicator (reference program.py:285-310
    with ``mpi_comm is None``)."""

    def allgather_object(self, obj: Any) -> List[Any]:
        return [obj]

    def barrier(self) -> None:
        pass


class _ThreadGroupState:
    def __init__(self, size: int):
        self.size = size
        self.slots: List[Any] = [None] * size
        self.gate = threading.Barrier(size)


class ThreadCommunicator(Communicator):
    """One of N in-process ranks sharing a mailbox + barrier."""

    def __init__(self, state: _ThreadGroupState, rank: int):
        self._state = state
        self.rank = rank
        self.size = state.size

    def allgather_object(self, obj: Any) -> List[Any]:
        st = self._state
        st.slots[self.rank] = obj
        st.gate.wait()            # all slots written
        out = list(st.slots)
        st.gate.wait()            # all slots read before reuse
        return out

    def barrier(self) -> None:
        self._state.gate.wait()


def make_thread_communicators(size: int) -> List[ThreadCommunicator]:
    """A group of ``size`` in-process communicators (one per island
    thread)."""
    state = _ThreadGroupState(size)
    return [ThreadCommunicator(state, r) for r in range(size)]


def run_island_threads(fns) -> list:
    """Run one callable per rank, each in its own thread with its own
    :class:`ThreadCommunicator`; returns the per-rank results in rank
    order.  An exception on any rank aborts the group's barrier (so no
    rank deadlocks) and is re-raised here."""
    comms = make_thread_communicators(len(fns))
    results: List[Any] = [None] * len(fns)
    errors: List[Any] = [None] * len(fns)

    def body(rank):
        try:
            results[rank] = fns[rank](comms[rank])
        except BaseException as e:      # noqa: BLE001 — must unblock peers
            errors[rank] = e
            comms[rank]._state.gate.abort()

    threads = [threading.Thread(target=body, args=(r,))
               for r in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None and not isinstance(e, threading.BrokenBarrierError):
            raise e
    for e in errors:
        if e is not None:
            raise e
    return results


def default_communicator() -> Communicator:
    """The no-op: multi-process runs over ``torch.distributed`` are not
    ported yet."""
    return NullCommunicator()
