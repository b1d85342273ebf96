"""The block schedule of the fused passes of the cycle loop
(evostencils_tpu_torch/csrc/transfer.cu ``col_leg_kernel`` in the forms of
``upleg_downleg_col`` and ``upleg_downleg_fused``), emulated in float64 on
the CPU.

A pass of S sweeps (the post-sweeps of one cycle, then the pre-sweeps of
the next; ``leg`` "pass" with both transfer axes, "rowpass" row-only) takes
the window class ``leg_window(leg, S, n, m, sms)`` among ``leg_windows(leg,
S)``; each block owns a ``leg_tile(...)`` tile and stages u and b over a
window with a halo of ``leg_halo(leg, S)`` = 2S + 2 cells, zero outside the
grid.  It corrects every window cell in the grid by the prolongation of e
or of c_half (row-only), each from the block's window of it; pass p of the
2S half-sweeps then updates only the window cells of its colour at a
distance >= p from the window edge; last, the residual on the tile and one
row (and column) past it is restricted, by both axes or by rows only.  The emulation runs every block at once, as a batch of windows,
with the plain versions' half-sweep arithmetic, and stitches the tiles back
together.  The result must equal ``upleg_downleg_col_plain`` /
``upleg_downleg_fused_plain`` to 1e-12 of their largest magnitude, and a
halo one cell short must not.

The plain versions are held against the Pallas kernels in interpret mode
by tests/test_torch_fused_loop.py, so the chain reaches the JAX package.
The stencil is anisotropic, the taps asymmetric and every sweep has its own
omega; the shapes are ragged and odd.  Every (post, pre) in {1, 2, 3}^2
runs in every window class built for its sweep count, and one shape of each
class's band runs with the class the rule picks.  Last, the wrappers are
driven against a stand-in library: they must hand ``es_upleg_downleg`` the
pass's halo and window class and raise when the entry refuses the launch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from evostencils_tpu_torch.ops.apply import axis_restrict_3tap
from evostencils_tpu_torch.ops.kernels import transfer as tt

from .test_torch_transfer_tiles import (ANISO, H100_SMS, RAGGED, RTOL,
                                        _apply, _Blocks, _deviation,
                                        _passes, _prolong_rows_windows,
                                        _prolong_windows, _stand_in_card)

#: a different factor for the correction and for every sweep of a pass
OMEGAS = (0.9, 1.15, 0.8, 1.3, 0.7, 1.05, 0.95)
R_TAPS = ((0.2, 0.5, 0.3), (0.1, 0.6, 0.3))
P_TAPS = ((0.4, 1.0, 0.6), (0.3, 0.9, 0.5))
PAIRS = [(post, pre) for post in (1, 2, 3) for pre in (1, 2, 3)]
#: a shape in each window class's band under the rule on the H100, for the
#: path's pass (1 post- + 2 pre-sweeps): a wave (660 blocks, row-only 528)
#: and more of 48^2 tiles, fewer
BANDS = {0: (1321, 1801), 1: (259, 301)}


def _inputs(shape, seed):
    """u, b, e ((n-1)/2, (m-1)/2) and c_half ((n-1)/2, m)."""
    rng = np.random.default_rng(seed)
    n, m = shape
    return tuple(torch.tensor(rng.standard_normal(s))
                 for s in (shape, shape, ((n - 1) // 2, (m - 1) // 2),
                           ((n - 1) // 2, m)))


def emulate_pass(u, coarse, b, omegas, ids, vals, p_taps, r_taps, tile,
                 halo, rows_only):
    """The pass kernel's schedule: (u_next, rc) with both transfer axes,
    (u_next, rr) row-only (``coarse`` is then c_half and the taps are the
    row taps)."""
    n, m = u.shape
    blocks = _Blocks((n, m), tile, halo)
    corr = (_prolong_rows_windows(blocks, coarse, p_taps) if rows_only
            else _prolong_windows(blocks, coarse, p_taps))
    bw = blocks.load(b)
    uw = blocks.load(u) + omegas[ids[0]] * torch.where(blocks.inside, corr,
                                                       0.0)
    uw = _passes(blocks, uw, bw, omegas, ids[1:], vals)
    h, tr, tc = halo, blocks.tr, blocks.tc
    u_out = blocks.stitch(uw[:, h:h + tr, h:h + tc], (n, m), tr, tc)
    r = torch.where(blocks.inside, bw - _apply(uw, vals), 0.0)
    if rows_only:
        rr = axis_restrict_3tap(r[:, h:h + tr + 1, h:h + tc], 1, r_taps)
        return u_out, blocks.stitch(rr, ((n - 1) // 2, m), tr // 2, tc)
    r = r[:, h:h + tr + 1, h:h + tc + 1]
    rc = axis_restrict_3tap(axis_restrict_3tap(r, 1, r_taps[0]), 2,
                            r_taps[1])
    return u_out, blocks.stitch(rc, ((n - 1) // 2, (m - 1) // 2), tr // 2,
                                tc // 2)


def _pass(shape, pair, window, rows_only, halo=None):
    """Deviation of the emulated pass (post, pre) = ``pair`` from the plain
    one; the tile is the window class's, the halo the pass's unless
    given."""
    u, b, e, ch = _inputs(shape, 21)
    omegas = torch.tensor(OMEGAS, dtype=torch.float64)
    sweeps = sum(pair)
    ids = list(range(sweeps + 1))
    leg = "rowpass" if rows_only else "pass"
    tile = tt.leg_tile(leg, sweeps, window)
    halo = tt.leg_halo(leg, sweeps) if halo is None else halo
    if rows_only:
        args = (u, ch, b, omegas, ids, ANISO, P_TAPS[0], R_TAPS[0])
        want = tt.upleg_downleg_fused_plain(*args)
    else:
        args = (u, e, b, omegas, ids, ANISO, P_TAPS, R_TAPS)
        want = tt.upleg_downleg_col_plain(*args)
    got = emulate_pass(*args, tile, halo, rows_only)
    return _deviation(got, want)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test run's parallel workers would
    otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CASES = [(shape, pair, window, rows_only) for shape in RAGGED
         for pair in PAIRS for rows_only in (False, True)
         for window in tt.leg_windows("rowpass" if rows_only else "pass",
                                      sum(pair))]


@pytest.mark.parametrize("shape,pair,window,rows_only", CASES)
def test_pass_block_schedule_matches_plain(shape, pair, window, rows_only):
    assert _pass(shape, pair, window, rows_only) <= RTOL


@pytest.mark.parametrize("leg", ["pass", "rowpass"])
@pytest.mark.parametrize("window", sorted(BANDS))
def test_band_shape_takes_its_class_and_matches_plain(window, leg):
    """A shape in each class's band, with the path's pass (1 + 2 sweeps):
    the rule picks the class, and its schedule matches the plain pass."""
    shape = BANDS[window]
    assert tt.leg_window(leg, 3, *shape, H100_SMS) == window
    assert _pass(shape, (1, 2), window, leg == "rowpass") <= RTOL


@pytest.mark.parametrize("rows_only,pair,window",
                         [(False, (1, 1), 0), (False, (1, 2), 1),
                          (False, (3, 3), 0), (True, (1, 2), 0),
                          (True, (2, 2), 1), (True, (3, 3), 0)])
def test_halo_one_short_differs(rows_only, pair, window):
    """A halo one cell below leg_halo(leg, S) (the same tile, a window two
    cells narrower) leaves wrong cells in the tiles: the residual's ring
    and the restriction's extra row need the whole halo."""
    halo = tt.leg_halo("rowpass" if rows_only else "pass", sum(pair)) - 1
    assert _pass((131, 197), pair, window, rows_only, halo) > 1e-3


def test_pass_rule():
    """The passes' halo is 2S + 2; the 32 x 64 class is built for passes of
    up to 4 sweeps (its tile keeps the halo's depth of rows), the legs keep
    both classes; the row-only pass fits 4 blocks of class 0 an SM, the
    others 5.  4095^2 and 2047^2 take class 0 at every sweep count; 1023^2
    takes class 1 up to 4 sweeps (row-only: 3, whose smaller wave 4 a SM
    fills sooner) and class 0 above."""
    for leg in ("pass", "rowpass"):
        assert [tt.leg_halo(leg, s) for s in range(1, 7)] == \
            [4, 6, 8, 10, 12, 14]
        assert [tt.leg_windows(leg, s) for s in range(1, 7)] == \
            [(0, 1)] * 4 + [(0,)] * 2
    assert all(tt.leg_windows(leg, s) == (0, 1) for leg in ("down", "up")
               for s in (1, 2, 3))
    assert [tt.leg_blocks(leg, k) for leg in ("down", "up", "pass",
                                              "rowpass")
            for k in (0, 1)] == [5, 6, 5, 6, 5, 6, 4, 6]
    for s in range(1, 7):
        rows, cols = tt.leg_tile("pass", s, 0)
        assert (rows, cols) == (64 - 4 * s - 4, 64 - 4 * s - 4)
        for leg, last_small in (("pass", 4), ("rowpass", 3)):
            for n in (4095, 2047):
                assert tt.leg_window(leg, s, n, n, H100_SMS) == 0
            assert tt.leg_window(leg, s, 1023, 1023, H100_SMS) == \
                (1 if s <= last_small else 0)


@pytest.mark.parametrize("err", [0, 1])
def test_wrappers_pass_halo_and_window_and_raise_on_refusal(monkeypatch,
                                                            err):
    """Both pass wrappers hand es_upleg_downleg their form (1 with column
    transfers, 0 row-only), leg_halo(leg, S) and leg_window(leg, ...) of
    their form, sweeps and grid (before n, m and the stream), and raise,
    counting no launch, when the entry refuses; the library is a stand-in,
    since the kernels need the card."""
    lib = _stand_in_card(monkeypatch, err)
    u, b, e, ch = (x.float() for x in _inputs((1023, 1023), 22))
    omegas = torch.tensor(OMEGAS, dtype=torch.float32)
    tt.reset_launches()
    calls = (
        (lambda: tt.upleg_downleg_col(u, e, b, omegas, [0, 1, 2, 3], ANISO,
                                      P_TAPS, R_TAPS), "pass", 1, 3),
        (lambda: tt.upleg_downleg_fused(u, ch, b, omegas, [0, 1, 2, 3, 4],
                                        ANISO, P_TAPS[0], R_TAPS[0]),
         "rowpass", 0, 4))
    for call, leg, cols, sweeps in calls:
        if err:
            with pytest.raises(RuntimeError, match="launch failed"):
                call()
        else:
            call()
        name, args = lib.calls[-1]
        assert name == "es_upleg_downleg" and args[5] == sweeps
        assert args[-6:-1] == (
            cols, tt.leg_halo(leg, sweeps),
            tt.leg_window(leg, sweeps, 1023, 1023, H100_SMS), 1023, 1023)
    assert sum(tt.launches.values()) == (0 if err else 2)
