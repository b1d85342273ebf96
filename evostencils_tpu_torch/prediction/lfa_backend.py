"""The port's backend for the LFA symbol calculus: the counterpart of
evostencils_tpu/prediction/lfa_backend.py's ``NumpyLfaBackend`` and of the
native engine's spectral radius (evostencils_tpu/native/lfa_engine.cpp,
``OP_EIGMAX``), kept in the port so that it imports nothing of the JAX
package.

``ConvergenceEvaluator`` (convergence.py) walks a cycle's IR once and
calls the backend's leaves and algebra, which take and return handles
carrying (rows, cols).  :class:`TorchLfaBackend` records those calls as a
DAG and runs it when a result is read, as batched complex128 tensor
programs on its ``device``: storage is ``(T, rows, cols)`` over T sampled
frequencies, products are batched ``matmul`` (zgemm), inverses
``torch.linalg.inv_ex``.  Recording first has two uses:

* the frequencies run in chunks sized from the DAG's own liveness, so the
  peak memory of a spectral radius stays under ``MEMORY_BUDGET`` whatever
  the symbol's order (one symbol of 3D 6 -> 2, order 4,096 over 512
  frequencies, would take 128 GiB at once);
* nothing waits for the device until the radius is read: the inverses'
  ``info`` and the symbol's finiteness gather on the device and are read
  with rho, in one host read.  A singular inverse or a non-finite symbol
  then raises ``torch.linalg.LinAlgError``, as numpy's ``inv`` and
  ``eigvals`` raise ``LinAlgError`` in the JAX package.

The spectral radius is ``"exact"`` (``torch.linalg.eigvals``, which does
host work on a CUDA device), ``"power"`` (the native engine's squaring and
power iteration, batched over frequencies) or ``"auto"`` (power for
symbols of order >= ``POWER_MIN_ORDER``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

#: ``rho_method="auto"`` takes the power method from this order on, as
#: the native engine's ``"auto"`` does (native_lfa.py:138-139)
POWER_MIN_ORDER = 128
#: below this order the power method falls back to exact eigenvalues, as
#: the engine's fast path does (lfa_engine.cpp:244)
POWER_FLOOR_ORDER = 16
#: the engine's power method: normalised squarings, then warm-up and
#: windowed power iterations from its start vector (lfa_engine.cpp:250-297)
POWER_SQUARINGS = 3
POWER_WARMUP = 10
POWER_WINDOW = 20
#: peak bytes of one spectral radius's chunk of frequencies (a tenth of
#: the H100's 80 GB)
MEMORY_BUDGET = 8 << 30

_CDTYPE = torch.complex128
_ITEM = 16  # bytes of one complex128
#: the leaves whose tables (the first item of their data) go to the device
_TABLE_OPS = ("circulant", "transfer", "diag")


@dataclass
class Handle:
    rows: int
    cols: int
    ref: object   # the recorded _Node


class _Node:
    """One recorded backend call: its operation, its input nodes and what
    its leaf or algebra needs beside them."""
    __slots__ = ("index", "op", "inputs", "data", "rows", "cols", "tables")

    def __init__(self, index, op, inputs, data, rows, cols):
        self.index = index
        self.op = op
        self.inputs = inputs
        self.data = data
        self.rows = rows
        self.cols = cols
        #: a leaf's tables on the device (``TorchLfaBackend._upload``)
        self.tables = None

    @property
    def broadcast(self) -> bool:
        """A leaf stored once and expanded over the frequencies."""
        return self.op in ("diag", "identity")

    def bytes_per_theta(self) -> int:
        return 0 if self.broadcast else self.rows * self.cols * _ITEM


def _diagonal(node: _Node) -> torch.Tensor:
    """A diag leaf's values on the device."""
    return torch.complex(*node.tables)


def engine_start_vector(n: int) -> np.ndarray:
    """The native engine's power-method start vector (lfa_engine.cpp:
    276-281): a 32-bit linear congruential sequence from seed 12345."""
    x = np.empty(n, dtype=np.float64)
    seed = 12345
    for i in range(n):
        seed = (seed * 1664525 + 1013904223) & 0xFFFFFFFF
        x[i] = (seed >> 8) / float(1 << 24) - 0.5
    return x


class TorchLfaBackend:
    """Recorded batched complex128 execution on ``device``."""

    def __init__(self, thetas: np.ndarray, device="cuda",
                 rho_method: str = "auto"):
        if rho_method not in ("exact", "power", "auto"):
            raise ValueError(f"unknown rho_method {rho_method!r}")
        self.device = torch.device(device)
        self.thetas_np = np.asarray(thetas, dtype=np.float64)
        self.thetas = None          # on the device from the first upload
        self.n_theta = self.thetas_np.shape[0]
        self.rho_method = rho_method
        self._nodes = 0
        #: the frequency chunks of the last spectral radius
        self.last_chunks = 0

    def _node(self, op, inputs, data, rows, cols) -> Handle:
        node = _Node(self._nodes, op, inputs, data, rows, cols)
        self._nodes += 1
        return Handle(rows, cols, node)

    # -- leaves --------------------------------------------------------------
    # a leaf keeps its tables on the host as float64 arrays; every table a
    # run needs goes to the device in one copy (``_upload``)

    def circulant(self, entries, rel: int, n: int) -> Handle:
        """entries: the arrays (x_idx, y_idx, offsets (E, d), complex
        values) of the modulated circulant's E nonzeros."""
        x_idx, y_idx, offsets, values = entries
        values = np.asarray(values, dtype=np.complex128)
        tables = (np.asarray(x_idx, np.int64) * n + np.asarray(y_idx,
                                                                np.int64),
                  np.asarray(offsets, np.float64), values.real, values.imag)
        return self._node("circulant", (), (tables, rel), n, n)

    def selection(self, pairs, rel_fine: int, nc: int, nf: int) -> Handle:
        """Odd-site injection (coarse x fine) with phase e^{i sum theta_f};
        pairs: (c_idx, f_idx)."""
        c_idx, f_idx = self._pairs(pairs)
        return self._node("transfer", (), ((c_idx, f_idx), rel_fine, 1.0),
                          nc, nf)

    def embedding(self, pairs, rel_fine: int, nc: int, nf: int) -> Handle:
        """Adjoint embedding (fine x coarse) with phase e^{-i sum theta_f}."""
        c_idx, f_idx = self._pairs(pairs)
        return self._node("transfer", (), ((f_idx, c_idx), rel_fine, -1.0),
                          nf, nc)

    @staticmethod
    def _pairs(pairs):
        arr = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        return arr[:, 0], arr[:, 1]

    def diag(self, values) -> Handle:
        values = np.asarray(values, dtype=np.complex128)
        n = values.shape[0]
        return self._node("diag", (), ((values.real, values.imag),), n, n)

    def identity(self, n: int) -> Handle:
        return self._node("identity", (), None, n, n)

    def zero(self, rows: int, cols: int) -> Handle:
        return self._node("zero", (), None, rows, cols)

    # -- algebra -------------------------------------------------------------
    # shapes are checked here, when the call is recorded, and raise what
    # numpy raises for them in the JAX package

    def matmul(self, a: Handle, b: Handle) -> Handle:
        if a.cols != b.rows:
            raise ValueError(f"matmul shape mismatch: ({a.rows}, {a.cols}) "
                             f"@ ({b.rows}, {b.cols})")
        return self._node("matmul", (a.ref, b.ref), None, a.rows, b.cols)

    def add(self, a: Handle, b: Handle) -> Handle:
        rows, cols = np.broadcast_shapes((a.rows, a.cols), (b.rows, b.cols))
        return self._node("add", (a.ref, b.ref), None, rows, cols)

    def sub(self, a: Handle, b: Handle) -> Handle:
        rows, cols = np.broadcast_shapes((a.rows, a.cols), (b.rows, b.cols))
        return self._node("sub", (a.ref, b.ref), None, rows, cols)

    def scale(self, alpha, a: Handle) -> Handle:
        return self._node("scale", (a.ref,), alpha, a.rows, a.cols)

    def inv(self, a: Handle) -> Handle:
        if a.rows != a.cols:
            raise torch.linalg.LinAlgError(
                "inverse of a non-square symbol")
        return self._node("inv", (a.ref,), None, a.rows, a.cols)

    def kron_eye(self, nf: int, a: Handle) -> Handle:
        """I_nf (x) A — per-field block diagonal replication."""
        return self._node("kron_eye", (a.ref,), nf, nf * a.rows,
                          nf * a.cols)

    def block(self, mf: int, n: int, blocks: Dict[Tuple[int, int], Handle]) \
            -> Handle:
        """(mf x mf) grid of (n x n) blocks; missing blocks are zero."""
        keys = list(blocks)
        return self._node("block", tuple(blocks[k].ref for k in keys),
                          (n, keys), mf * n, mf * n)

    # -- execution -----------------------------------------------------------

    def _schedule(self, root: _Node):
        """The nodes the root reads, in recording order (a topological
        order), and the index of each node's last reader."""
        nodes, stack = {}, [root]
        while stack:
            node = stack.pop()
            if node.index not in nodes:
                nodes[node.index] = node
                stack.extend(node.inputs)
        order = [nodes[i] for i in sorted(nodes)]
        last_use = {}
        for node in order:
            for inp in node.inputs:
                last_use[inp.index] = node.index
        last_use[root.index] = float("inf")      # held to the end
        return order, last_use

    @staticmethod
    def _peak_per_theta(order, last_use, tail: int) -> int:
        """Peak bytes per frequency of running ``order``: every live value,
        each output as it is made, an inverse's factorisation beside its
        output, and ``tail`` copies of the root at the end."""
        live = peak = 0
        for node in order:
            out = node.bytes_per_theta()
            scratch = out if node.op == "inv" else 0
            peak = max(peak, live + out + scratch)
            live += out
            for inp in set(node.inputs):
                if last_use[inp.index] == node.index:
                    live -= inp.bytes_per_theta()
        root = order[-1]
        return max(peak, live + tail * root.bytes_per_theta(), 1)

    def _chunks(self, order, last_use, tail: int) -> int:
        per_theta = self._peak_per_theta(order, last_use, tail)
        return int(min(self.n_theta, max(1, MEMORY_BUDGET // per_theta)))

    def _upload(self, order, start_vector=None):
        """The frequencies, every table of the run's leaves and the power
        method's start vector to the device in one copy, from pinned
        memory and asynchronous on a CUDA device, so that the host does
        not wait for it; returns the start vector's copy."""
        leaves = [node for node in order
                  if node.op in _TABLE_OPS and node.tables is None]
        parts = [] if self.thetas is not None else [self.thetas_np]
        for node in leaves:
            parts.extend(node.data[0])
        if start_vector is not None:
            parts.append(start_vector)
        if not parts:
            return None
        host = torch.from_numpy(np.concatenate(
            [np.asarray(a, np.float64).reshape(-1) for a in parts]))
        if self.device.type == "cuda":
            host = host.pin_memory()
        chunks = iter(torch.split(host.to(self.device, non_blocking=True),
                                  [np.size(a) for a in parts]))
        if self.thetas is None:
            self.thetas = next(chunks).view(self.thetas_np.shape)
        for node in leaves:
            node.tables = tuple(next(chunks).view(np.shape(a))
                                for a in node.data[0])
        return next(chunks) if start_vector is not None else None

    def _run(self, order, last_use, lo: int, hi: int, flags: List):
        """The root's value on frequencies lo:hi; each inverse appends its
        failure flag (a device tensor) to ``flags``."""
        thetas = self.thetas[lo:hi]
        values = {}
        for node in order:
            args = [values[i.index] for i in node.inputs]
            values[node.index] = self._eval(node, args, thetas, flags)
            for inp in node.inputs:
                if last_use[inp.index] == node.index:
                    values.pop(inp.index, None)
        return values[order[-1].index]

    def _eval(self, node, args, thetas, flags):
        T = thetas.shape[0]
        op = node.op
        if op == "circulant":
            flat, offsets, re, im = node.tables
            phase = torch.exp(1j * (((2 ** node.data[1]) * thetas)
                                    @ offsets.T))
            out = torch.zeros(T, node.rows * node.cols, dtype=_CDTYPE,
                              device=self.device)
            out.index_add_(1, flat.long(), torch.complex(re, im) * phase)
            return out.view(T, node.rows, node.cols)
        if op == "transfer":
            r_idx, c_idx = node.tables
            _, rel, sign = node.data
            phase = torch.exp(sign * 1j * ((2 ** rel) * thetas).sum(dim=-1))
            out = torch.zeros(T, node.rows, node.cols, dtype=_CDTYPE,
                              device=self.device)
            out[:, r_idx.long(), c_idx.long()] = phase[:, None]
            return out
        if op == "diag":
            return torch.diag_embed(_diagonal(node)).expand(T, -1, -1)
        if op == "identity":
            return torch.eye(node.rows, dtype=_CDTYPE,
                             device=self.device).expand(T, -1, -1)
        if op == "zero":
            return torch.zeros(T, node.rows, node.cols, dtype=_CDTYPE,
                               device=self.device)
        if op == "matmul":
            a, b = node.inputs
            if a.op == "identity":
                return args[1]
            if b.op == "identity":
                return args[0]
            if a.op == "diag":
                return _diagonal(a)[:, None] * args[1]
            if b.op == "diag":
                return args[0] * _diagonal(b)
            return args[0] @ args[1]
        if op == "add":
            return args[0] + args[1]
        if op == "sub":
            return args[0] - args[1]
        if op == "scale":
            return node.data * args[0]
        if op == "inv":
            out, info = torch.linalg.inv_ex(args[0])
            flags.append((info != 0).any())
            return out
        if op == "kron_eye":
            (a,) = args
            r, c = a.shape[-2:]
            out = torch.zeros(T, node.rows, node.cols, dtype=_CDTYPE,
                              device=self.device)
            for i in range(node.data):
                out[:, i * r:(i + 1) * r, i * c:(i + 1) * c] = a
            return out
        if op == "block":
            n, keys = node.data
            out = torch.zeros(T, node.rows, node.cols, dtype=_CDTYPE,
                              device=self.device)
            for (i, j), a in zip(keys, args):
                out[:, i * n:(i + 1) * n, j * n:(j + 1) * n] = a
            return out
        raise AssertionError(f"unknown LFA node {op!r}")

    def materialize(self, a: Handle) -> torch.Tensor:
        """The symbol on every frequency, (T, rows, cols) complex128 on
        the device, run in chunks; a singular inverse raises."""
        order, last_use = self._schedule(a.ref)
        size = self._chunks(order, last_use, 1)
        self._upload(order)
        flags: List = []
        parts = [self._run(order, last_use, lo, min(lo + size, self.n_theta),
                           flags).expand(-1, a.rows, a.cols)
                 for lo in range(0, self.n_theta, size)]
        out = torch.cat(parts)
        if flags and bool(torch.stack(flags).any()):
            raise torch.linalg.LinAlgError("singular matrix in the symbol")
        return out

    # -- results -------------------------------------------------------------

    def uses_power(self, n: int) -> bool:
        """Whether a spectral radius of order n takes the power method."""
        fast = (self.rho_method == "power"
                or (self.rho_method == "auto" and n >= POWER_MIN_ORDER))
        return fast and n >= POWER_FLOOR_ORDER

    def spectral_radius(self, a: Handle) -> float:
        """max over frequencies of the symbol's spectral radius, read from
        the device once (with the inverses' and finiteness flags)."""
        if a.rows != a.cols:
            raise torch.linalg.LinAlgError(
                "spectral radius of a non-square symbol")
        power = self.uses_power(a.rows)
        order, last_use = self._schedule(a.ref)
        # the power method holds two more matrices of the root's order,
        # eigenvalues a copy and LAPACK's workspace
        size = self._chunks(order, last_use, 3 if power else 2)
        self.last_chunks = -(-self.n_theta // size)
        start = self._upload(order, engine_start_vector(a.rows)
                             if power else None)
        flags: List = []
        rho = torch.zeros((), dtype=torch.float64, device=self.device)
        for lo in range(0, self.n_theta, size):
            S = self._run(order, last_use, lo, min(lo + size, self.n_theta),
                          flags).expand(-1, a.rows, a.cols)
            finite = torch.isfinite(S).flatten(1).all(1)
            flags.append(~finite.all())
            S = torch.where(finite[:, None, None], S, 0)
            rho_t = self._power_rho(S, start) if power \
                else torch.linalg.eigvals(S).abs().amax(dim=-1)
            rho = torch.maximum(rho, rho_t.amax())
        failed = torch.stack(flags).any().to(torch.float64)
        rho_value, failed_value = torch.stack([rho, failed]).tolist()
        if failed_value:
            raise torch.linalg.LinAlgError(
                "singular or non-finite symbol")
        return float(rho_value)

    def _power_rho(self, S: torch.Tensor, start: torch.Tensor) \
            -> torch.Tensor:
        """The native engine's spectral-radius estimate (lfa_engine.cpp:
        242-300) on every frequency at once: B = E^(2^3) by normalised
        squarings, then the norm growth of a power iteration on B over a
        window; 0 where the propagator or an iterate vanishes."""
        T, n, _ = S.shape
        f64 = dict(dtype=torch.float64, device=self.device)
        B = S
        log_scale = torch.zeros(T, **f64)
        dead = torch.zeros(T, dtype=torch.bool, device=self.device)
        weight = 1.0 / 2 ** POWER_SQUARINGS
        for s in range(POWER_SQUARINGS):
            nrm = B.abs().amax(dim=(-2, -1))
            dead |= nrm == 0
            nrm = torch.where(nrm == 0, 1.0, nrm)
            B = B / nrm[:, None, None].to(_CDTYPE)
            log_scale += torch.log(nrm) * (2.0 ** (POWER_SQUARINGS - s)
                                           * weight)
            B = B @ B
        x = start.to(_CDTYPE).expand(T, n).unsqueeze(-1)
        log_growth = torch.zeros(T, **f64)
        for it in range(POWER_WARMUP + POWER_WINDOW):
            y = B @ x
            nrm = torch.linalg.vector_norm(y, dim=(-2, -1))
            dead |= nrm == 0
            nrm = torch.where(nrm == 0, 1.0, nrm)
            x = y / nrm[:, None, None].to(_CDTYPE)
            if it >= POWER_WARMUP:
                log_growth += torch.log(nrm)
        rho = torch.exp(log_growth / POWER_WINDOW * weight + log_scale)
        return torch.where(dead, 0.0, rho)

    def eigenvalues(self, a: Handle) -> torch.Tensor:
        return torch.linalg.eigvals(self.materialize(a)).reshape(-1)
