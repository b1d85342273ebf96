"""Host-level collectives for population-parallel evolution (counterpart
of evostencils_tpu/parallel/comm.py; the base class, the null and thread
communicators are copies of its lines 39-146).

The port's replacement for the reference's optimizer-tier mpi4py layer
(reference optimization/program.py:285-310: ``allgather``/``gather``/
``allreduce``/``barrier`` wrappers that no-op without a communicator, used
for offspring exchange, fitness-cache replication, timing reduction and
rank-0-only I/O).  Three implementations:

* :class:`NullCommunicator` — single-process fallback, every collective is
  the identity (mirrors the reference's ``mpi_comm is None`` path);
* :class:`ThreadCommunicator` — N in-process ranks over a shared mailbox,
  for tests and single-host island runs;
* :class:`TorchProcessCommunicator` — N processes under
  ``torch.distributed`` (``torchrun``, or :func:`initialize_multihost`):
  Python objects are pickled to uint8 tensors and allgathered over a
  gloo group on the CPU, whatever backend the caller uses for tensors
  (these are host objects, and NCCL refuses two ranks on one card).

The optimizer keeps populations replicated: every rank runs the identical
generation/selection stream (same rng seed), only *evaluation* is
partitioned ``pending[rank::size]`` and the (tree-string, fitness) pairs
are allgathered — evaluation cost divides by the rank count while ranks
stay mutually consistent.  With deterministic fitness (model-based
estimation) a multi-rank run is bit-identical to the single-process run;
with *measured* fitness, wall-clock objectives additionally reflect
device contention between ranks that share a card, so selections can
differ from a solo run within timing noise.
"""

from __future__ import annotations

import datetime
import os
import pickle
import threading
from typing import Any, List, Sequence

#: seconds a process waits for its peers when the process group forms, so
#: that a missing peer fails the run instead of hanging it
INIT_TIMEOUT_S = 120.0


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


class TorchProcessCommunicator(Communicator):
    """Multi-process collectives over ``torch.distributed`` (counterpart
    of comm.py:149-178).

    Objects are pickled to uint8 tensors, padded to the longest payload
    and exchanged with ``all_gather`` on a gloo group on the CPU: the
    default group when it is gloo, else a gloo group over the same ranks
    (every rank constructs the communicator, as ``new_group`` requires).
    Requires the default process group to exist."""

    def __init__(self):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("TorchProcessCommunicator needs an "
                               "initialized torch.distributed process "
                               "group (initialize_multihost)")
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self._group = None if dist.get_backend() == "gloo" else \
            dist.new_group(backend="gloo")
        #: set by initialize_multihost when it formed the group
        self.owns_group = False

    def allgather_object(self, obj: Any) -> List[Any]:
        import torch
        import torch.distributed as dist

        if self.size == 1:
            return [obj]
        payload = torch.frombuffer(bytearray(pickle.dumps(obj)),
                                   dtype=torch.uint8)
        lengths = [torch.zeros(1, dtype=torch.int64)
                   for _ in range(self.size)]
        dist.all_gather(lengths, torch.tensor([payload.numel()]),
                        group=self._group)
        lengths = [int(n) for n in lengths]
        padded = torch.zeros(max(lengths), dtype=torch.uint8)
        padded[:payload.numel()] = payload
        rows = [torch.empty_like(padded) for _ in range(self.size)]
        dist.all_gather(rows, padded, group=self._group)
        return [pickle.loads(row[:n].numpy().tobytes())
                for row, n in zip(rows, lengths)]

    def close(self) -> None:
        """Destroy the process group if :func:`initialize_multihost`
        formed it for this communicator."""
        import torch.distributed as dist
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False


def initialize_multihost(coordinator_address: str = None,
                         num_processes: int = None,
                         process_id: int = None) -> Communicator:
    """Form the ``torch.distributed`` process group and return the process
    communicator (counterpart of comm.py:181-205; replaces the reference's
    ``mpiexec`` + mpi4py bootstrap, reference scripts/optimize.py:39-48).

    With no arguments the group forms from the environment that
    ``torchrun`` sets (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``); with arguments at ``tcp://`` +
    ``coordinator_address`` (``host:port``).  The backend is gloo.  A peer
    that does not join within INIT_TIMEOUT_S seconds makes this raise.  A
    group that already exists is reused."""
    import torch.distributed as dist
    owns = not dist.is_initialized()
    if owns:
        kwargs = {"init_method": "env://"}
        if coordinator_address is not None:
            kwargs = {"init_method": f"tcp://{coordinator_address}",
                      "world_size": num_processes, "rank": process_id}
        dist.init_process_group(
            "gloo", timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S),
            **kwargs)
    comm = TorchProcessCommunicator()
    comm.owns_group = owns
    return comm


def default_communicator() -> Communicator:
    """TorchProcessCommunicator when the world has more than one process
    (an initialized group of more than one rank, or ``WORLD_SIZE > 1`` in
    the environment, as ``torchrun`` sets it), else the no-op.  A group
    that cannot form raises; there is no fallback to the no-op."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() > 1:
            return TorchProcessCommunicator()
        return NullCommunicator()
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return initialize_multihost()
    return NullCommunicator()
