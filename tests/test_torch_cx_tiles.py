"""The block schedule of the complex red-black sweep kernel
(evostencils_tpu_torch/csrc/rbgs_cx.cu, ``fused_rbgs_cx_kernel``),
emulated in complex128 on the CPU.

The kernel cannot run here, but its halo arithmetic can.  Each block owns
a ``sweep_tile()`` tile and stages u and b over a ``SWEEP_WINDOW`` window
with a halo of ``SWEEP_HALO`` cells, zero outside the grid.  The red half-sweep updates
only the window cells at a distance >= 1 from the window edge, the black
one those at >= 2, so no update reads outside the window.  The emulation
runs every block at once, as a batch of windows, with the plain version's
update arithmetic, and stitches the tiles back together.  The result must
equal ``fused_rbgs_sweep_cx_plain`` to 1e-12 of its largest magnitude,
and neither a halo one cell short nor two swapped neighbour directions
may.

The plain version is held against the Pallas kernel in interpret mode by
tests/test_torch_helmholtz.py, so the chain reaches the JAX package.  The
shapes are the JAX test's ragged ones with its stencil, the gate's
smallest level, the ``[main-cx]`` path's 1023^2, 511^2 and 255^2 levels
with its shifted Laplacian, and ragged ones with a stencil whose four
neighbours differ, so that a swapped direction shows: one cut by the grid
in its last tiles, one that the tiles fill exactly and one that leaves a
last tile of one row and one column.  Last, the wrapper is driven against
a stand-in library: it must hand the entry the grid's shape and raise when
the entry refuses the launch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F

from evostencils_tpu_torch.grids import unit_interval_grid
from evostencils_tpu_torch.ops.kernels import rbgs_cx as rc
from evostencils_tpu_torch.problems import helmholtz
# the batch of windows is the 2D Poisson legs' (the same tiling), and so
# is the stand-in card
from tests.test_torch_transfer_tiles import _Blocks, _stand_in_card

#: max |emulated - plain| <= RTOL * max |plain|: the same complex128
#: arithmetic on every updated cell
RTOL = 1e-12
OMEGAS = (0.9, 0.6, 0.8)
#: the JAX test's complex stencil (tests/test_pallas_cx.py:17)
VALS_JAX = (4.0 - 0.5j, -1.0 + 0.02j, -1.0 + 0.02j, -1.0 - 0.01j,
            -1.0 - 0.01j)
#: an asymmetric stencil, whose four neighbours all differ
VALS_ASYM = (5.0 - 0.4j, -1.5 + 0.03j, -0.5 - 0.02j, -1.25 + 0.01j,
             -0.75 - 0.05j)
#: the JAX test's ragged shapes (tests/test_pallas_cx.py:39-40) and the
#: gate's smallest level with its stencil, the [main-cx] path's levels
#: below 2047^2 with their own, and ragged shapes with the asymmetric one:
#: cut by the grid, filled by whole tiles (12 x 60), a tile past that
_TR, _TC = rc.sweep_tile()
SHAPES = (((300, 200), "jax"), ((129, 130), "jax"), ((65, 128), "jax"),
          ((255, 255), "path"), ((511, 511), "path"), ((1023, 1023), "path"),
          ((131, 197), "asym"), ((11 * _TR, 3 * _TC), "asym"),
          ((11 * _TR + 1, 3 * _TC + 1), "asym"))
_IDS = [f"{s[0]}x{s[1]}-{k}" for s, k in SHAPES]


def _values(shape, kind):
    if kind == "path":
        grid = unit_interval_grid(2, (shape[0] + 1).bit_length() - 1)
        return rc.complex_five_point_values(helmholtz._helmholtz_stencil(
            grid, helmholtz.K_DEFAULT, helmholtz.SHIFT))
    return VALS_JAX if kind == "jax" else VALS_ASYM


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.standard_normal(shape)
                              + 1j * rng.standard_normal(shape))
                 for _ in range(2))


def _update(u, b, omega, vals):
    """``omega * ((1 / c) * (b - A u))`` on a batch of windows, zero past
    each window, A u summed center, up, down, left, right
    (``rbgs_cx._update``)."""
    c, cn, cs, cw, ce = (complex(v) for v in vals)
    p = F.pad(u, (1, 1, 1, 1))
    au = (c * u + cn * p[:, :-2, 1:-1] + cs * p[:, 2:, 1:-1]
          + cw * p[:, 1:-1, :-2] + ce * p[:, 1:-1, 2:])
    return omega * ((1.0 / c) * (b - au))


def emulate(u, b, omega, vals, tile, halo):
    """The kernel's schedule: red on the window cells at a distance >= 1,
    black on those at >= 2, then the tiles."""
    n, m = u.shape
    blocks = _Blocks((n, m), tile, halo)
    uw, bw = blocks.load(u), blocks.load(b)
    for p, colour in ((1, blocks.red), (2, ~blocks.red)):
        mask = blocks.inside & colour & (blocks.dist >= p)
        uw = uw + torch.where(mask, _update(uw, bw, omega, vals), 0)
    h, tr, tc = halo, blocks.tr, blocks.tc
    return blocks.stitch(uw[:, h:h + tr, h:h + tc], (n, m), tr, tc)


def _deviation(shape, kind, halo=rc.SWEEP_HALO, swap=None):
    """max |emulated - plain| / max |plain|; ``swap`` a pair of stencil
    positions the emulation exchanges."""
    u, b = _inputs(shape, 21)
    omegas = torch.tensor(OMEGAS, dtype=torch.float64)
    vals = _values(shape, kind)
    want = rc.fused_rbgs_sweep_cx_plain(u, b, omegas, 1, vals)
    if swap is not None:
        vals = list(vals)
        vals[swap[0]], vals[swap[1]] = vals[swap[1]], vals[swap[0]]
    got = emulate(u, b, omegas[1], vals, rc.sweep_tile(), halo)
    return float((got - want).abs().max() / want.abs().max())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test run's parallel workers would
    otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("shape,kind", SHAPES, ids=_IDS)
def test_block_schedule_matches_plain(shape, kind):
    assert _deviation(shape, kind) <= RTOL


@pytest.mark.parametrize("shape,kind", SHAPES[:2] + SHAPES[6:8],
                         ids=_IDS[:2] + _IDS[6:8])
def test_halo_one_short_differs(shape, kind):
    """A halo of 1 (the same tile, a window two cells narrower) leaves
    wrong cells at the tiles' edges."""
    assert _deviation(shape, kind, rc.SWEEP_HALO - 1) > 1e-3


@pytest.mark.parametrize("swap", [(1, 2), (3, 4)], ids=["up-down",
                                                        "left-right"])
def test_swapped_directions_differ(swap):
    """The asymmetric stencil with up and down, or left and right,
    exchanged gives another sweep: the emulation tells the directions
    apart."""
    assert _deviation((131, 197), "asym", swap=swap) > 1e-3


def test_window_classes():
    """The tile is the window less the halo, with even rows and columns
    (tiles start at even indices, so a window cell's colour is the parity
    of its window indices); the block is whole warps, one a slot row."""
    rows, cols = rc.SWEEP_WINDOW
    assert rc.SWEEP_HALO == 2
    tr, tc = rc.sweep_tile()
    assert (tr, tc) == (rows - 4, cols - 4)
    assert tr % 2 == 0 and tc % 2 == 0
    assert rc.SWEEP_THREADS % (cols // 2) == 0
    assert rows % (rc.SWEEP_THREADS // (cols // 2)) == 0


@pytest.mark.parametrize("err", [0, 1])
def test_wrapper_passes_window_and_raises_on_refusal(monkeypatch, err):
    """The red-black and Jacobi wrappers hand their entries the grid's
    n, m (before the stream; the red-black kernel has one window, fixed in
    its entry), and both raise, counting no launch, when the entry
    refuses; the library is a stand-in, since the kernel needs the
    card."""
    lib = _stand_in_card(monkeypatch, err)
    shape = (1023, 1023)
    u, b = (x.to(torch.complex64) for x in _inputs(shape, 22))
    omegas = torch.tensor(OMEGAS, dtype=torch.float32)
    rc.reset_launches()
    calls = ((lambda: rc.fused_rbgs_sweep_cx(u, b, omegas, 1, VALS_JAX),
              "es_fused_rbgs_sweep_cx"),
             (lambda: rc.jacobi_sweep_cx(u, b, omegas, 1, VALS_JAX),
              "es_sweep_cx"))
    for call, entry in calls:
        if err:
            with pytest.raises(RuntimeError, match="launch failed"):
                call()
        else:
            call()
        name, args = lib.calls[-1]
        assert name == entry
        assert args[-3:-1] == shape
    assert rc.launches == {"fused_rbgs_sweep_cx": 0 if err else 1,
                           "jacobi_sweep_cx": 0 if err else 1}
