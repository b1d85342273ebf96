"""The block schedule of the 2D Poisson leg kernels
(evostencils_tpu_torch/csrc/transfer.cu, ``col_leg_kernel`` in the forms of
the down-leg and the up-leg, with both transfer axes and row-only),
emulated in float64 on the CPU.

The kernels cannot run here, but their halo arithmetic can.  A level takes
the window class ``leg_window(leg, S, n, m, sms)``; each block owns a
``leg_tile(...)`` tile and stages u and b over a window with a halo of
``leg_halo(leg, S)`` cells, zero outside the grid.  Pass p of the 2S
half-sweeps updates only the window cells of its colour at a distance >=
p from the window edge, so no update reads outside the window.  The
down-leg then forms the residual on the tile and one row and column past
it and restricts it; the up-leg prolongs e from the tile's coarse window
before its passes.  The row-only down-leg restricts along rows only, to
rr ((n-1)/2, m); the row-only up-leg corrects by the row prolongation of
c_half ((n-1)/2, m) from the block's window of it.  The emulation runs
every block at once, as a batch of windows, with the plain versions'
half-sweep arithmetic, and stitches the tiles back together.  The result
must equal ``presmooth_residual_restrict_plain``,
``prolong_correct_postsmooth_col_plain``,
``presmooth_residual_rowrestrict_plain`` and
``prolong_correct_postsmooth_plain`` to 1e-12 of their largest magnitude,
and a halo one cell short must not.

The standalone residual restriction is the down-leg's form with no
sweep (S = 0, halo 2): its schedule must equal
``residual_restrict_plain``.  The standalone prolongation-correction is
the up-leg's form with no sweep (S = 0, halo 0, its tile the window): its
schedule must equal ``prolong_correct_plain``, and a coarse window that
starts one row late must not.
The plain versions are held against the Pallas kernels in interpret mode
by tests/test_torch_transfer.py and tests/test_torch_fused_loop.py (the
row-only legs), so the chain reaches the JAX package.
The stencil is anisotropic and the transfer taps asymmetric, so that a
swapped axis or direction shows; the shapes are ragged and odd, so the
last tiles are cut by the grid; every window class runs at every sweep
count, and one shape of each class's band runs with the class the rule
picks.  Last, the wrappers are driven against a stand-in library: they
must hand each entry its leg's halo and window class and raise when the
entry refuses the launch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F

from evostencils_tpu_torch.ops.apply import axis_restrict_3tap
from evostencils_tpu_torch.ops.kernels import transfer as tt

#: max |emulated - plain| <= RTOL * max |plain|: the same float64
#: arithmetic, in another grouping only where the emulation restricts a
#: tile's residual and prolongs from a tile's coarse window
RTOL = 1e-12
OMEGAS = (0.9, 1.15, 0.8, 1.3)
ANISO = (5.0, -1.5, -0.5, -1.25, -0.75)
R_TAPS = ((0.2, 0.5, 0.3), (0.1, 0.6, 0.3))
P_TAPS = ((0.4, 1.0, 0.6), (0.3, 0.9, 0.5))
RAGGED = ((131, 197), (195, 129))
#: the H100's streaming multiprocessors, which the wrappers read from
#: the card
H100_SMS = 132
#: a shape in each window class's band under the rule on the H100, for the
#: path's sweeps (2 down, 1 up): 660 and more tiles of class 0, fewer
BANDS = {0: (1321, 1801), 1: (259, 301)}


#: the legs: with both transfer axes, and row-only
DOWN_LEGS, UP_LEGS = ("down", "rowdown"), ("up", "rowup")


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    n, m = shape
    u, b = (torch.tensor(rng.standard_normal(shape)) for _ in range(2))
    e = torch.tensor(rng.standard_normal(((n - 1) // 2, (m - 1) // 2)))
    return u, b, e


def _half(shape, seed):
    """c_half ((n-1)/2, m): a correction prolonged along columns."""
    n, m = shape
    return torch.tensor(np.random.default_rng(seed).standard_normal(
        ((n - 1) // 2, m)))


class _Blocks:
    """Every block of a launch on an (n, m) grid: tile (tr, tc), halo h,
    window (tr + 2h, tc + 2h), as a batch of windows; the grid cells of
    each window and each cell's distance to its window's edge."""

    def __init__(self, shape, tile, halo):
        self.n, self.m = shape
        self.tr, self.tc = tile
        self.h = halo
        self.wr, self.wc = self.tr + 2 * halo, self.tc + 2 * halo
        self.nby, self.nbx = -(-self.n // self.tr), -(-self.m // self.tc)
        by, bx = torch.meshgrid(torch.arange(self.nby), torch.arange(self.nbx),
                                indexing="ij")
        self.r0 = (by * self.tr - halo).reshape(-1)
        self.c0 = (bx * self.tc - halo).reshape(-1)
        self.rows = self.r0[:, None] + torch.arange(self.wr)    # (T, wr)
        self.cols = self.c0[:, None] + torch.arange(self.wc)    # (T, wc)
        self.inside = (((self.rows >= 0) & (self.rows < self.n))[:, :, None]
                       & ((self.cols >= 0) & (self.cols < self.m))[:, None, :])
        self.red = (self.rows[:, :, None] + self.cols[:, None, :]) % 2 == 0
        er = torch.arange(self.wr)
        ec = torch.arange(self.wc)
        self.dist = torch.minimum(
            torch.minimum(er, self.wr - 1 - er)[:, None],
            torch.minimum(ec, self.wc - 1 - ec)[None, :])

    def gather(self, x, rows, cols):
        """x at rows (T, a) x cols (T, b) of every block, zero outside."""
        pad = max(self.wr, self.wc) + 2
        xp = F.pad(x, (pad, pad, pad, pad))
        return xp[(rows + pad)[:, :, None], (cols + pad)[:, None, :]]

    def load(self, x):
        return self.gather(x, self.rows, self.cols)

    def stitch(self, tiles, shape, tr, tc):
        """(T, tr, tc) tiles in block order to an array of ``shape``."""
        out = tiles.reshape(self.nby, self.nbx, tr, tc).permute(0, 2, 1, 3)
        out = out.reshape(self.nby * tr, self.nbx * tc)
        return out[:shape[0], :shape[1]]


def _apply(u, vals):
    """The 5-point operator on a batch of windows, zero past each window,
    summed in the order of ``ops.apply.apply_constant``."""
    c, up, dn, lf, rt = vals
    p = F.pad(u, (1, 1, 1, 1))
    return (c * u + up * p[:, :-2, 1:-1] + dn * p[:, 2:, 1:-1]
            + lf * p[:, 1:-1, :-2] + rt * p[:, 1:-1, 2:])


def _passes(blocks, u, b, omegas, ids, vals):
    """The leg's half-sweeps on every window: pass p on the cells of its
    colour in the grid at a distance >= p, as the plain versions' masked
    half-sweep (``transfer._rb_sweeps_plain``)."""
    p = 0
    for i in ids:
        for colour in (blocks.red, ~blocks.red):
            p += 1
            mask = (blocks.inside & colour & (blocks.dist >= p)).to(u.dtype)
            u = u + omegas[i] * mask * ((1.0 / vals[0]) * (b - _apply(u, vals)))
    return u


def emulate_down(u, b, omegas, ids, vals, taps, tile, halo, rows_only=False):
    """The down-leg kernel's schedule: (smoothed u, coarse residual); row
    only, ``taps`` are the row taps and the residual is rr ((n-1)/2, m)."""
    n, m = u.shape
    blocks = _Blocks((n, m), tile, halo)
    bw = blocks.load(b)
    uw = _passes(blocks, blocks.load(u), bw, omegas, ids, vals)
    h, tr, tc = halo, blocks.tr, blocks.tc
    u_out = blocks.stitch(uw[:, h:h + tr, h:h + tc], (n, m), tr, tc)
    r = torch.where(blocks.inside, bw - _apply(uw, vals), 0.0)
    if rows_only:
        rr = axis_restrict_3tap(r[:, h:h + tr + 1, h:h + tc], 1, taps)
        return u_out, blocks.stitch(rr, ((n - 1) // 2, m), tr // 2, tc)
    r = r[:, h:h + tr + 1, h:h + tc + 1]
    coarse = axis_restrict_3tap(axis_restrict_3tap(r, 1, taps[0]), 2, taps[1])
    rc = blocks.stitch(coarse, ((n - 1) // 2, (m - 1) // 2), tr // 2, tc // 2)
    return u_out, rc


def _prolong_windows(blocks, e, taps, late=0):
    """P(e) on every window cell from e's coarse window of each block
    (rows and columns from floor(r0 / 2) - 1 on, zero outside the coarse
    grid): the column expansion, then the row expansion.  ``late`` starts
    the window's coarse rows that many rows later."""
    cr = torch.div(blocks.r0, 2, rounding_mode="floor") - 1 + late
    cc = torch.div(blocks.c0, 2, rounding_mode="floor") - 1
    ew = blocks.gather(e, cr[:, None] + torch.arange(blocks.wr // 2 + 2),
                       cc[:, None] + torch.arange(blocks.wc // 2 + 2))

    def expand(fine, coarse0, t):
        """(coarse window index at or before, weight on it, weight on the
        next) of every fine index of every block on one axis."""
        a = torch.div(fine - 1, 2, rounding_mode="floor") - coarse0[:, None]
        odd = fine % 2 == 1
        return a, torch.where(odd, t[1], t[2]), torch.where(odd, 0.0, t[0])

    t_row, t_col = (torch.tensor(t, dtype=e.dtype) for t in taps)
    ca, cwa, cwb = expand(blocks.cols, cc, t_col)
    idx = torch.arange(ew.shape[0])[:, None, None]
    rows = torch.arange(ew.shape[1])[None, :, None]
    cols = (cwa[:, None, :] * ew[idx, rows, ca[:, None, :]]
            + cwb[:, None, :] * ew[idx, rows, ca[:, None, :] + 1])
    ra, rwa, rwb = expand(blocks.rows, cr, t_row)
    fine_c = torch.arange(blocks.wc)[None, None, :]
    return (rwa[:, :, None] * cols[idx, ra[:, :, None], fine_c]
            + rwb[:, :, None] * cols[idx, ra[:, :, None] + 1, fine_c])


def _prolong_rows_windows(blocks, ch, row_taps):
    """P_row(c_half) on every window cell from c_half's window of each
    block (rows from floor(r0 / 2) - 1 on, the window's columns, zero
    outside the grid): fine row 2i+1 takes w[1] c[i], fine row 2i w[2]
    c[i-1] + w[0] c[i]."""
    cr = torch.div(blocks.r0, 2, rounding_mode="floor") - 1
    cw = blocks.gather(ch, cr[:, None] + torch.arange(blocks.wr // 2 + 2),
                       blocks.cols)
    t = torch.tensor(row_taps, dtype=ch.dtype)
    a = torch.div(blocks.rows - 1, 2, rounding_mode="floor") - cr[:, None]
    odd = blocks.rows % 2 == 1
    wa, wb = torch.where(odd, t[1], t[2]), torch.where(odd, 0.0, t[0])
    idx = torch.arange(cw.shape[0])[:, None, None]
    fine_c = torch.arange(blocks.wc)[None, None, :]
    return (wa[:, :, None] * cw[idx, a[:, :, None], fine_c]
            + wb[:, :, None] * cw[idx, a[:, :, None] + 1, fine_c])


def emulate_up(u, e, b, omegas, ids, vals, taps, tile, halo, rows_only=False,
               late=0):
    """The up-leg kernel's schedule: the corrected, smoothed u; row only,
    ``e`` is c_half and ``taps`` are the row taps.  ``late``: as for
    :func:`_prolong_windows`."""
    n, m = u.shape
    blocks = _Blocks((n, m), tile, halo)
    if rows_only:
        prolong = _prolong_rows_windows(blocks, e, taps)
    else:
        prolong = _prolong_windows(blocks, e, taps, late)
    corr = torch.where(blocks.inside, prolong, 0.0)
    uw = blocks.load(u) + omegas[ids[0]] * corr
    uw = _passes(blocks, uw, blocks.load(b), omegas, ids[1:], vals)
    h = halo
    return blocks.stitch(uw[:, h:h + blocks.tr, h:h + blocks.tc], (n, m),
                         blocks.tr, blocks.tc)


def _deviation(got, want):
    """Largest |got - want| over every array, relative to max |want|."""
    return max(float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


def _down(shape, sweeps, window, halo=None, leg="down"):
    """Deviation of the emulated down-leg (``leg`` "down" or "rowdown")
    from the plain one; the tile is the window class's, the halo the leg's
    unless given.  With no sweep, the standalone residual restriction:
    its coarse residual against ``residual_restrict_plain``."""
    u, b, _ = _inputs(shape, 11)
    omegas = torch.tensor(OMEGAS, dtype=torch.float64)
    ids = [1, 2, 3][:sweeps]
    tile = tt.leg_tile(leg, sweeps, window)
    halo = tt.leg_halo(leg, sweeps) if halo is None else halo
    rows_only = leg == "rowdown"
    taps = R_TAPS[0] if rows_only else R_TAPS
    got = emulate_down(u, b, omegas, ids, ANISO, taps, tile, halo,
                       rows_only)
    if not sweeps:
        want = tt.residual_restrict_plain(u, b, ANISO, taps)
        return _deviation(got[1:], (want,))
    plain = (tt.presmooth_residual_rowrestrict_plain if rows_only
             else tt.presmooth_residual_restrict_plain)
    want = plain(u, b, omegas, ids, ANISO, taps)
    return _deviation(got, want)


def _up(shape, sweeps, window, halo=None, leg="up"):
    """As :func:`_down` for the up-leg (``leg`` "up" or "rowup")."""
    u, b, e = _inputs(shape, 12)
    rows_only = leg == "rowup"
    if rows_only:
        e = _half(shape, 14)
    omegas = torch.tensor(OMEGAS, dtype=torch.float64)
    ids = [0, 1, 2, 3][:sweeps + 1]
    tile = tt.leg_tile(leg, sweeps, window)
    halo = tt.leg_halo(leg, sweeps) if halo is None else halo
    taps = P_TAPS[0] if rows_only else P_TAPS
    plain = (tt.prolong_correct_postsmooth_plain if rows_only
             else tt.prolong_correct_postsmooth_col_plain)
    want = plain(u, e, b, omegas, ids, ANISO, taps)
    got = emulate_up(u, e, b, omegas, ids, ANISO, taps, tile, halo,
                     rows_only)
    return _deviation((got,), (want,))


def _leg(leg, shape, sweeps, window, halo=None):
    run = _down if leg in DOWN_LEGS else _up
    return run(shape, sweeps, window, halo, leg)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test run's parallel workers would
    otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CASES = [(shape, sweeps, window) for shape in RAGGED for sweeps in (1, 2, 3)
         for window in range(len(tt.LEG_WINDOWS))]
#: the down-leg with no sweep (the standalone residual restriction) in
#: every class built for it, after the legs' cases
RR_CASES = [(shape, 0, window) for shape in RAGGED
            for window in tt.leg_windows("down", 0)]


@pytest.mark.parametrize("shape,sweeps,window", CASES + RR_CASES)
def test_downleg_block_schedule_matches_plain(shape, sweeps, window):
    assert _down(shape, sweeps, window) <= RTOL


@pytest.mark.parametrize("shape,sweeps,window", CASES)
def test_upleg_block_schedule_matches_plain(shape, sweeps, window):
    assert _up(shape, sweeps, window) <= RTOL


ROW_CASES = [(leg, shape, sweeps, window) for leg in ("rowdown", "rowup")
             for shape in RAGGED for sweeps in (1, 2, 3)
             for window in tt.leg_windows(leg, sweeps)]


@pytest.mark.parametrize("leg,shape,sweeps,window", ROW_CASES)
def test_row_leg_block_schedule_matches_plain(leg, shape, sweeps, window):
    """The row-only legs' schedule, every window class built for them and
    S = 1..3, on ragged odd shapes."""
    assert _leg(leg, shape, sweeps, window) <= RTOL


@pytest.mark.parametrize("leg", ["down", "up", "rowdown", "rowup"])
@pytest.mark.parametrize("window", sorted(BANDS))
def test_band_shape_takes_its_class_and_matches_plain(leg, window):
    """A shape in each class's band, with the path's sweeps: the rule
    picks the class, and its schedule matches the plain leg."""
    shape = BANDS[window]
    sweeps = 2 if leg in DOWN_LEGS else 1
    assert tt.leg_window(leg, sweeps, *shape, H100_SMS) == window
    assert _leg(leg, shape, sweeps, window) <= RTOL


@pytest.mark.parametrize("leg,sweeps,window",
                         [("down", 2, 0), ("down", 1, 1), ("up", 1, 0),
                          ("up", 3, 1), ("rowdown", 2, 0),
                          ("rowdown", 3, 1), ("rowup", 1, 0),
                          ("rowup", 2, 1), ("down", 0, tt.RR_WINDOW)])
def test_halo_one_short_differs(leg, sweeps, window):
    """A halo one cell below leg_halo() (the same tile, a window two cells
    narrower) leaves wrong cells in the tiles."""
    halo = tt.leg_halo(leg, sweeps) - 1
    assert _leg(leg, (131, 197), sweeps, window, halo) > 1e-3


def test_leg_rule():
    """The halo is P + 2 down and P up (P = 2S); the tile is the window less
    the halo; 4095^2 and 2047^2 take class 0, whose tiles there fill a wave
    of resident blocks on the card, and the path's levels from 1023^2 down
    class 1."""
    assert [tt.leg_halo(leg, s) for leg in ("down", "up")
            for s in (1, 2, 3)] == [4, 6, 8, 2, 4, 6]
    with pytest.raises(ValueError):
        tt.leg_halo("sideways", 1)
    for window, (rows, cols, _) in enumerate(tt.LEG_WINDOWS):
        assert tt.leg_tile("down", 2, window) == (rows - 12, cols - 12)
    for n in (4095, 2047, 1023, 511, 255):
        for leg, sweeps in (("down", 2), ("up", 1)):
            window = tt.leg_window(leg, sweeps, n, n, H100_SMS)
            assert window == (0 if n >= 2047 else 1)
            tr, tc = tt.leg_tile(leg, sweeps, 0)
            fills = -(-n // tr) * -(-n // tc) >= \
                H100_SMS * tt.LEG_BLOCKS_PER_SM[0]
            assert fills == (window == 0)


def test_row_leg_rule():
    """The row-only legs keep the legs' halos (P + 2 down, P up) and both
    window classes at S = 1..3; the down-leg fits the legs' 5 / 6 blocks
    an SM, the up-leg, which stages c_half's rows as well, the row-only
    pass's 4 / 6.  On the H100's 132 SMs, 4095^2 and 2047^2 take class 0
    and the path's levels from 1023^2 down class 1, at every S."""
    legs = ("rowdown", "rowup")
    assert [tt.leg_halo(leg, s) for leg in legs for s in (1, 2, 3)] == \
        [4, 6, 8, 2, 4, 6]
    assert all(tt.leg_windows(leg, s) == (0, 1) for leg in legs
               for s in (1, 2, 3))
    assert [tt.leg_blocks(leg, k) for leg in legs for k in (0, 1)] == \
        [5, 6, 4, 6]
    for leg in legs:
        for s in (1, 2, 3):
            for n in (4095, 2047, 1023, 511, 255):
                assert tt.leg_window(leg, s, n, n, H100_SMS) == \
                    (0 if n >= 2047 else 1)


class _FakeLibrary:
    """Stands in for the built library: records each leg entry's
    arguments and returns ``err`` (cudaErrorInvalidValue is 1)."""

    def __init__(self, err):
        self.err, self.calls = err, []

    def es_error_string(self, err):
        return b"invalid argument"

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return self.err
        return entry


def _stand_in_card(monkeypatch, err):
    """A card of H100_SMS SMs whose library is a _FakeLibrary returning
    ``err``; returns the library."""
    from contextlib import nullcontext
    from types import SimpleNamespace
    from evostencils_tpu_torch.ops.kernels import _build
    lib = _FakeLibrary(err)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "on_card", lambda u: True)
    monkeypatch.setattr(torch.cuda, "device", lambda d: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(
                            multi_processor_count=H100_SMS))
    return lib


@pytest.mark.parametrize("err", [0, 1])
def test_wrappers_pass_halo_and_window_and_raise_on_refusal(monkeypatch,
                                                            err):
    """The leg wrappers hand each entry leg_halo(...) and
    leg_window(...) of their leg, sweeps and grid (before n, m and the
    stream), and raise, counting no launch, when the entry refuses; the
    library is a stand-in, since the kernels need the card."""
    lib = _stand_in_card(monkeypatch, err)
    u, b, e = (x.float() for x in _inputs((131, 197), 13))
    omegas = torch.tensor(OMEGAS, dtype=torch.float32)
    tt.reset_launches()
    calls = (
        (lambda: tt.presmooth_residual_restrict(u, b, omegas, [1, 2], ANISO,
                                                R_TAPS),
         "es_presmooth_residual_restrict", ("down", 2), 1),
        (lambda: tt.prolong_correct_postsmooth_col(u, e, b, omegas, [0, 1],
                                                   ANISO, P_TAPS),
         "es_prolong_correct_postsmooth", ("up", 1), 1))
    for call, entry, (leg, sweeps), cols in calls:
        if err:
            with pytest.raises(RuntimeError, match="launch failed"):
                call()
        else:
            call()
        name, args = lib.calls[-1]
        assert name == entry and args[-6:-1] == (
            cols, tt.leg_halo(leg, sweeps),
            tt.leg_window(leg, sweeps, 131, 197, H100_SMS), 131, 197)
    assert sum(tt.launches.values()) == (0 if err else 2)


@pytest.mark.parametrize("err", [0, 1])
def test_row_leg_wrappers_pass_halo_and_window_and_raise_on_refusal(
        monkeypatch, err):
    """The row-only leg wrappers hand their entries leg_halo(...) and
    leg_window(...) of "rowdown" / "rowup", their sweeps and grid (before
    n, m and the stream), and raise, counting no launch, when the entry
    refuses; the library is a stand-in, since the kernels need the card."""
    lib = _stand_in_card(monkeypatch, err)
    shape = (1023, 1023)
    u, b, _ = (x.float() for x in _inputs(shape, 15))
    ch = _half(shape, 16).float()
    omegas = torch.tensor(OMEGAS, dtype=torch.float32)
    tt.reset_launches()
    calls = (
        (lambda: tt.presmooth_residual_rowrestrict(u, b, omegas, [1, 2, 3],
                                                   ANISO, R_TAPS[0]),
         "es_presmooth_residual_restrict", ("rowdown", 3), 0),
        (lambda: tt.prolong_correct_postsmooth(u, ch, b, omegas, [0, 1],
                                               ANISO, P_TAPS[0]),
         "es_prolong_correct_postsmooth", ("rowup", 1), 0))
    for call, entry, (leg, sweeps), cols in calls:
        if err:
            with pytest.raises(RuntimeError, match="launch failed"):
                call()
        else:
            call()
        name, args = lib.calls[-1]
        assert name == entry and args[-6:-1] == (
            cols, tt.leg_halo(leg, sweeps),
            tt.leg_window(leg, sweeps, *shape, H100_SMS), *shape)
    assert sum(tt.launches.values()) == (0 if err else 2)


def test_residual_restrict_rule():
    """The standalone residual restriction is the down-leg of no sweep:
    halo 2, the 32 x 64 class alone (tiles 28 x 60, 6 blocks an SM) at
    every level; no form but it and the up-leg of no sweep (the standalone
    prolongation-correction) is built without a sweep."""
    assert tt.leg_halo("down", 0) == 2
    assert tt.leg_windows("down", 0) == (tt.RR_WINDOW,) == (1,)
    assert tt.leg_tile("down", 0, tt.RR_WINDOW) == (28, 60)
    assert tt.leg_blocks("down", tt.RR_WINDOW) == 6
    assert {tt.leg_window("down", 0, n, n, H100_SMS)
            for n in (4095, 2047, 1023, 511, 255)} == {tt.RR_WINDOW}
    assert all(tt.leg_windows(leg, 0) == () for leg in tt._FORMS
               if leg not in ("down", "up"))


@pytest.mark.parametrize("err", [0, 1])
def test_residual_restrict_wrapper_passes_halo_and_window(monkeypatch, err):
    """residual_restrict hands es_residual_restrict leg_halo("down", 0) and
    leg_window("down", 0, ...) of its grid (before n, m and the stream) at
    a level of each class and a ragged shape, and raises, counting no
    launch, when the entry refuses; the library is a stand-in."""
    lib = _stand_in_card(monkeypatch, err)
    tt.reset_launches()
    for shape in ((4095, 4095), (255, 255), (131, 197)):
        u = torch.zeros(shape, dtype=torch.float32)
        if err:
            with pytest.raises(RuntimeError, match="launch failed"):
                tt.residual_restrict(u, u, ANISO, R_TAPS)
        else:
            rc = tt.residual_restrict(u, u, ANISO, R_TAPS)
            assert rc.shape == tuple((n - 1) // 2 for n in shape)
        name, args = lib.calls[-1]
        assert name == "es_residual_restrict" and args[-5:-1] == (
            2, tt.leg_window("down", 0, *shape, H100_SMS), *shape)
    assert tt.launches["residual_restrict"] == (0 if err else 3)


#: the taps of the [evaluator] path (bilinear) and asymmetric ones, and
#: ragged odd shapes: one cut by the grid, one whose rows the tiles cut,
#: one past a whole number of tiles on both axes
PC_TAPS = {"path": ((0.5, 1.0, 0.5), (0.5, 1.0, 0.5)), "asym": P_TAPS}
PC_SHAPES = RAGGED + ((257, 255),)


def _prolong_correct(shape, taps, late=0):
    """Deviation of the emulated up-leg of no sweep (the standalone
    prolongation-correction, its one class and halo) from
    ``prolong_correct_plain``."""
    u, b, e = _inputs(shape, 17)
    omegas = torch.tensor(OMEGAS, dtype=torch.float64)
    want = tt.prolong_correct_plain(u, e, omegas, 2, taps)
    got = emulate_up(u, e, b, omegas, [2], ANISO, taps,
                     tt.leg_tile("up", 0, tt.PC_WINDOW),
                     tt.leg_halo("up", 0), late=late)
    return _deviation((got,), (want,))


@pytest.mark.parametrize("taps", sorted(PC_TAPS))
@pytest.mark.parametrize("shape", PC_SHAPES,
                         ids=[f"{n}x{m}" for n, m in PC_SHAPES])
def test_prolong_correct_schedule_matches_plain(shape, taps):
    assert _prolong_correct(shape, PC_TAPS[taps]) <= RTOL


@pytest.mark.parametrize("taps", sorted(PC_TAPS))
def test_prolong_correct_coarse_window_one_row_late_differs(taps):
    """e's coarse window staged from one coarse row later gives another
    correction: the emulation reaches the window's placement."""
    assert _prolong_correct((131, 197), PC_TAPS[taps], late=1) > 1e-3


def test_prolong_correct_rule():
    """The standalone prolongation-correction is the up-leg of no sweep:
    halo 0, so its tile is the window; its own 16 x 64 class alone (8
    blocks an SM) at every level, a class no leg or pass is built in."""
    assert tt.leg_halo("up", 0) == 0
    assert tt.leg_windows("up", 0) == (tt.PC_WINDOW,) == (2,)
    rows, cols, _ = tt.WINDOWS[tt.PC_WINDOW]
    assert tt.leg_tile("up", 0, tt.PC_WINDOW) == (rows, cols) == (16, 64)
    assert tt.leg_blocks("up", tt.PC_WINDOW) == 8
    assert tt.WINDOWS[:len(tt.LEG_WINDOWS)] == tt.LEG_WINDOWS
    assert all(tt.PC_WINDOW not in tt.leg_windows(leg, s)
               for leg in tt._FORMS for s in range(1, 7))
    assert {tt.leg_window("up", 0, n, n, H100_SMS)
            for n in (4095, 2047, 1023, 511, 255)} == {tt.PC_WINDOW}


@pytest.mark.parametrize("err", [0, 1])
def test_prolong_correct_wrapper_passes_halo_and_window(monkeypatch, err):
    """prolong_correct hands es_prolong_correct its omega id,
    leg_halo("up", 0) and leg_window("up", 0, ...) of its grid (before
    n, m and the stream) at the finest and coarsest level and a ragged
    shape, and raises, counting no launch, when the entry refuses; the
    library is a stand-in."""
    lib = _stand_in_card(monkeypatch, err)
    omegas = torch.tensor(OMEGAS, dtype=torch.float32)
    tt.reset_launches()
    for shape in ((4095, 4095), (255, 255), (131, 197)):
        u = torch.zeros(shape, dtype=torch.float32)
        e = torch.zeros(tuple((n - 1) // 2 for n in shape),
                        dtype=torch.float32)
        if err:
            with pytest.raises(RuntimeError, match="launch failed"):
                tt.prolong_correct(u, e, omegas, 2, P_TAPS)
        else:
            assert tt.prolong_correct(u, e, omegas, 2, P_TAPS).shape == shape
        name, args = lib.calls[-1]
        assert name == "es_prolong_correct" and args[3] == 2
        assert args[-5:-1] == (0, tt.leg_window("up", 0, *shape, H100_SMS),
                               *shape)
    assert tt.launches["prolong_correct"] == (0 if err else 3)
