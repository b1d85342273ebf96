"""The strip schedule of the single-pass 5-point sweep kernel
(evostencils_tpu_torch/csrc/rbgs.cu, ``sweep_kernel``), emulated in
float64 on the CPU.

The kernel cannot run here, but its schedule can.  Each thread owns a
strip of ``SWEEP_STRIP`` rows of one column, in blocks of ``SWEEP_BLOCK``
= (columns, strips) threads.  It loads u on the strip and one row beyond
each end (zero outside the grid) into registers, which up, centre and
down roll through; the columns left and right of it come from the lanes
beside it in its warp, and at a warp's edges from a load of their own.
In a pass of one colour (parity 0 or 1) a thread updates every other row
of its strip, from its first row of that colour on, copies the others,
and sends its copied row to the lanes beside it, whose column parity
differs: that row is the one they update.  The emulation runs every
thread at once, one tensor slot a thread, with the kernel's arithmetic
and order, and writes each strip back.  It must equal ``sweep_plain`` to
1e-12 of its largest magnitude for parity -1, 0 and 1, and neither a
strip whose registers roll one row off, nor warp edges that skip their
loads, may.

The plain version is held against the Pallas kernel in interpret mode by
tests/test_torch_rbgs.py, so the chain reaches the JAX package.  The
stencil's four neighbours all differ, so that a swapped direction shows.
Shapes: the JAX test's 300x200, 129x130 (a last strip of one row), and
one whose rows no strip count divides and whose columns leave a last
warp of five lanes.  Last, the wrapper is driven against a stand-in
library: it must hand the entry the parity and the grid's shape and raise
when the entry refuses the launch.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F

from evostencils_tpu_torch.ops.kernels import _build
from evostencils_tpu_torch.ops.kernels import rbgs as tr
from tests.test_torch_transfer_tiles import _stand_in_card

#: max |emulated - plain| <= RTOL * max |plain|: the same float64
#: arithmetic in the same order at every point
RTOL = 1e-12
OMEGAS = (0.9, 1.15, 0.8)
#: (center, up, down, left, right), the four neighbours all different
VALS = (5.0, -1.5, -0.5, -1.25, -0.75)
_ROWS = tr.SWEEP_STRIP * tr.SWEEP_BLOCK[1]
SHAPES = ((300, 200), (129, 130), (11 * _ROWS + 3, 3 * 32 + 5))
_IDS = [f"{n}x{m}" for n, m in SHAPES]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.standard_normal(shape)) for _ in range(2))


def emulate(u, b, omega, vals, parity, off=0, edges=True):
    """The kernel's schedule: (strips, R) register rows of every column.
    ``off`` shifts the rows the registers roll through; ``edges`` False
    leaves the warp-edge lanes' neighbour loads out."""
    n, m = u.shape
    R = tr.SWEEP_STRIP
    bx = tr.SWEEP_BLOCK[0]
    strips = -(-n // _ROWS) * tr.SWEEP_BLOCK[1]
    mp = -(-m // bx) * bx                      # columns of whole blocks
    i0 = torch.arange(strips) * R
    j = torch.arange(mp)
    lane = j % 32

    def padded(x):
        """x with row r at r + 2, zero outside the grid."""
        out = x.new_zeros((strips * R + 4, mp + 2))
        out[2:n + 2, 1:m + 1] = x
        return out

    up_, bp = padded(u), padded(b)
    # c[s, k] = u[i0 - 1 + k + off] (0 outside the grid), bb[s, k] = b[i0 + k]
    c = torch.stack([up_[i0 + 1 + k + off, 1:-1] for k in range(R + 2)], 1)
    bb = torch.stack([bp[i0 + 2 + k, 1:-1] for k in range(R)], 1)
    # the warp edges' neighbour columns: lane 0 its left, lane 31 its right
    edge_col = torch.where(lane == 0, up_[:, :-2], up_[:, 2:])
    if not edges:
        edge_col = torch.zeros_like(edge_col)
    e = torch.stack([edge_col[i0 + 2 + k] for k in range(R)], 1)
    cc, cu, cd, cl, cr = (float(v) for v in vals)
    om_dinv = omega * (1.0 / cc)

    def beside(send, edge):
        """Shuffles up and down by one lane within a warp; the edge lanes
        take their loaded neighbour."""
        lf = torch.roll(send, 1, dims=-1)
        rt = torch.roll(send, -1, dims=-1)
        lf = torch.where(lane == 0, edge, lf)
        rt = torch.where(lane == 31, edge, rt)
        return lf, rt

    res = c[:, 1:R + 1].clone()
    if parity < 0:
        for k in range(R):
            v, up, dn = c[:, k + 1], c[:, k], c[:, k + 2]
            lf, rt = beside(v, e[:, k])
            au = cc * v + cu * up + cd * dn + cl * lf + cr * rt
            res[:, k] = v + om_dinv * (bb[:, k] - au)
    else:
        d = (parity + i0[:, None] + j[None, :]) % 2 == 1
        for q in range(R // 2):
            k0 = 2 * q
            v = torch.where(d, c[:, k0 + 2], c[:, k0 + 1])
            up = torch.where(d, c[:, k0 + 1], c[:, k0])
            dn = torch.where(d, c[:, k0 + 3], c[:, k0 + 2])
            send = torch.where(d, c[:, k0 + 1], c[:, k0 + 2])
            lf, rt = beside(send, torch.where(d, e[:, k0 + 1], e[:, k0]))
            bq = torch.where(d, bb[:, k0 + 1], bb[:, k0])
            au = cc * v + cu * up + cd * dn + cl * lf + cr * rt
            nv = v + om_dinv * (bq - au)
            res[:, k0] = torch.where(d, c[:, k0 + 1], nv)
            res[:, k0 + 1] = torch.where(d, nv, c[:, k0 + 2])
    return res.reshape(strips * R, mp)[:n, :m]


def _deviation(shape, parity, **kw):
    u, b = _inputs(shape, 31)
    omegas = torch.tensor(OMEGAS, dtype=torch.float64)
    want = tr.sweep_plain(u, b, omegas, 1, VALS, parity)
    got = emulate(u, b, float(omegas[1]), VALS, parity, **kw)
    return float((got - want).abs().max() / want.abs().max())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test run's parallel workers would
    otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("parity", [-1, 0, 1])
@pytest.mark.parametrize("shape", SHAPES, ids=_IDS)
def test_strip_schedule_matches_plain(shape, parity):
    assert _deviation(shape, parity) <= RTOL


@pytest.mark.parametrize("parity", [-1, 0, 1])
def test_roll_off_by_one_row_differs(parity):
    """Registers that roll through the rows one below the strip's give
    another sweep."""
    assert _deviation((300, 200), parity, off=1) > 1e-3


@pytest.mark.parametrize("parity", [-1, 1])
def test_warp_edges_without_their_loads_differ(parity):
    """Warp-edge lanes that take 0 for the neighbour column outside their
    warp give another sweep: the emulation reaches the edge loads."""
    assert _deviation((129, 130), parity, edges=False) > 1e-3


def test_schedule_constants():
    """Strips hold pairs of rows (one of each colour), and a block's
    columns are whole warps, so every warp lies in one strip row."""
    assert tr.SWEEP_STRIP % 2 == 0 and tr.SWEEP_STRIP >= 2
    assert tr.SWEEP_BLOCK[0] % 32 == 0
    threads = tr.SWEEP_BLOCK[0] * tr.SWEEP_BLOCK[1]
    assert tr.SWEEP_BLOCKS_PER_SM * threads >= 1024


def test_schedule_constants_match_the_source():
    """The wrapper module's schedule is the one csrc/rbgs.cu builds: its
    STRIP, SWEEP_BX x SWEEP_BY and SWEEP_MIN_BLOCKS (1024 threads)."""
    src = _build.SOURCES[[s.name for s in _build.SOURCES].index("rbgs.cu")]
    text = src.read_text()
    got = re.search(r"constexpr int STRIP = (\d+);", text)
    block = re.search(r"constexpr int SWEEP_BX = (\d+), SWEEP_BY = (\d+);",
                      text)
    assert int(got.group(1)) == tr.SWEEP_STRIP
    assert tuple(map(int, block.groups())) == tr.SWEEP_BLOCK
    assert ("constexpr int SWEEP_MIN_BLOCKS = 1024 / (SWEEP_BX * SWEEP_BY);"
            in text)
    assert tr.SWEEP_BLOCKS_PER_SM == 1024 // (tr.SWEEP_BLOCK[0]
                                              * tr.SWEEP_BLOCK[1])


@pytest.mark.parametrize("err", [0, 1])
def test_wrapper_passes_parity_and_shape_and_raises_on_refusal(monkeypatch,
                                                               err):
    """The single-pass wrappers hand es_sweep the parity (jacobi_sweep -1,
    rbgs_sweep 0 then 1) and the grid's n, m (before the stream; the
    kernel's strip is fixed in its entry), and raise, counting no launch,
    when the entry refuses; the library is a stand-in, since the kernel
    needs the card."""
    lib = _stand_in_card(monkeypatch, err)
    shape = (1023, 1023)
    u, b = (x.float() for x in _inputs(shape, 32))
    omegas = torch.tensor(OMEGAS, dtype=torch.float32)
    tr.reset_launches()
    calls = ((lambda: tr.jacobi_sweep(u, b, omegas, 1, VALS), [-1]),
             (lambda: tr.rbgs_sweep(u, b, omegas, 1, VALS), [0, 1]))
    for call, parities in calls:
        before = len(lib.calls)
        if err:
            with pytest.raises(RuntimeError, match="launch failed"):
                call()
            parities = parities[:1]
        else:
            call()
        got = lib.calls[before:]
        assert [name for name, _ in got] == ["es_sweep"] * len(parities)
        assert [args[4] for _, args in got] == parities
        assert all(args[-3:-1] == shape for _, args in got)
    assert tr.launches["jacobi_sweep"] == (0 if err else 3)
