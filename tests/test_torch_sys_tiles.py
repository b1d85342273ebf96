"""The tile schedule of the coupled-system leg kernels
(evostencils_tpu_torch/csrc/rbgs_sys.cu, ``downleg_sys_kernel`` and
``upleg_sys_kernel``), emulated in float64 on the CPU.

The kernels cannot run here, but their halo arithmetic can.  Each leg
block owns a ``LEG_TILE`` x ``LEG_TILE`` fine tile and loads u over a
window with a halo of ``leg_halo(leg, sweeps, red_black)`` cells, zero
outside the grid.  Pass p (P = 2S half-sweeps red-black, S sweeps Jacobi)
updates only the window cells at a Chebyshev distance >= p from the window
edge, so no update reads outside the window.  The down-leg then forms the
residual on the tile and one row and column past it and restricts it; the
up-leg prolongs e from the tile's coarse window before its passes.  The
emulation runs each pass with the module's own plain half-sweep arithmetic
on each window, with global rows for the fixups, and stitches the tiles
back together.  The result must equal the plain versions to 1e-12 of their
largest magnitude, and a halo one cell short must not.  The standalone
red-black sweep (``rbgs_sys_kernel``) runs the same passes with no
transfer in ``SWEEP_WINDOW`` windows with a halo of ``SWEEP_HALO``: red on
the cells at distance >= 1, black on those at >= 2; it is emulated the
same way and held to ``fused_rbgs_sweep_sys_plain``, also at 65x130,
whose rows and columns no window divides.

The plain versions are held against the Pallas kernels in interpret mode
by tests/test_torch_sys.py, so the chain reaches the JAX package.  Tables:
linear elasticity's own at 255^2, and a random diagonally dominant one
with nonzero corners in every block, a non-diagonal point solve, center and
point-solve fixups on rows inside a tile, on a tile edge and near the
grid's end, and asymmetric transfer taps.  Shapes are ragged and odd, so
the last tiles are cut by the grid.  Last, the wrappers are driven against
a stand-in library: they must hand each entry its leg's halo (the sweeps
their mode and the grid's shape) and raise when the entry refuses the
launch.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from evostencils_tpu_torch.compiler import lower as tlower
from evostencils_tpu_torch.ops.apply import axis_restrict_3tap
from evostencils_tpu_torch.ops.kernels import _build
from evostencils_tpu_torch.ops.kernels import rbgs_sys as trs
from evostencils_tpu_torch.problems import elasticity as telasticity

#: max |emulated - plain| <= RTOL * max |plain|: the same float64
#: arithmetic, in another grouping only where the emulation restricts a
#: tile's residual and prolongs from a tile's coarse window
RTOL = 1e-12
OMEGAS = (0.9, 1.15, 0.8, 1.3)
R_TAPS = ((0.25, 0.5, 0.25), (0.25, 0.5, 0.25))
P_TAPS = ((0.5, 1.0, 0.5), (0.5, 1.0, 0.5))
R_TAPS_ASYM = ((0.2, 0.5, 0.3), (0.1, 0.6, 0.3))
P_TAPS_ASYM = ((0.4, 1.0, 0.6), (0.3, 0.9, 0.5))
SHAPES = ((131, 197), (195, 129))
CASES = [(shape, table, sweeps, red_black)
         for shape in SHAPES for table in ("elasticity", "random")
         for sweeps in (1, 2, 3) for red_black in (True, False)]


def _random_table(rng):
    coeffs = []
    for i in range(2):
        row = []
        for j in range(2):
            c = rng.uniform(-0.3, 0.3, 9)
            c[0] = 6.0 + rng.uniform(0, 1) if i == j else 0.7 + 0.2 * i
            c[1:5] += -1.0 if i == j else 0.0
            row.append(tuple(float(v) for v in c))
        coeffs.append(tuple(row))
    return tuple(coeffs)


def _operator(table, n):
    """(coeffs, minv, exc, exc_minv, (restriction taps, prolongation
    taps)) of a case."""
    if table == "elasticity":
        op = telasticity.linear_elasticity_2d(max_level=8, min_level=7) \
            .level_contexts[0].operator
        coeffs = tlower._sys_nine_table(op)[0]
        minv = tlower._Lowering._sys_minv(coeffs, "elem")
        return coeffs, minv, (), (), (R_TAPS, P_TAPS)
    coeffs = _random_table(np.random.default_rng(5))
    minv = tlower._Lowering._sys_minv(coeffs, "elem")
    exc = ((3, ((0.5, 0.25), (-0.2, 0.75))),
           (trs.LEG_TILE, ((-0.4, 0.0), (0.3, 0.6))),
           (n - 2, ((0.1, -0.3), (0.0, 0.45))))
    exc_minv = tlower._Lowering._sys_minv_exc(coeffs, "elem", exc, minv)
    return coeffs, minv, exc, exc_minv, (R_TAPS_ASYM, P_TAPS_ASYM)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    n, m = shape
    fine = [torch.tensor(rng.standard_normal(shape)) for _ in range(4)]
    e = tuple(torch.tensor(rng.standard_normal(((n - 1) // 2, (m - 1) // 2)))
              for _ in range(2))
    return tuple(fine[:2]), tuple(fine[2:]), e


def _window(x, r0, c0, h, w):
    """x over rows r0..r0+h-1 and columns c0..c0+w-1, zero outside."""
    out = x.new_zeros((h, w))
    n, m = x.shape
    rs, re = max(r0, 0), min(r0 + h, n)
    cs, ce = max(c0, 0), min(c0 + w, m)
    if rs < re and cs < ce:
        out[rs - r0:re - r0, cs - c0:ce - c0] = x[rs:re, cs:ce]
    return out


def _local(fixups, r0):
    """Fixups on window rows: global row minus the window's first row."""
    return tuple((row - r0, d) for row, d in fixups)


class _Tile:
    """One block's window: its first interior row and column, its rows and
    columns (a leg's edge W: a LEG_TILE square tile), the grid cells among
    them and each cell's distance to the window edge."""

    def __init__(self, shape, by, bx, halo, tile=(trs.LEG_TILE,) * 2):
        n, m = shape
        self.h, (self.tr, self.tc) = halo, tile
        self.wr, self.w = self.tr + 2 * halo, self.tc + 2 * halo
        self.r0 = by * self.tr - halo
        self.c0 = bx * self.tc - halo
        ri, ci = torch.arange(self.wr), torch.arange(self.w)
        gr, gc = self.r0 + ri[:, None], self.c0 + ci[None, :]
        self.inside = (gr >= 0) & (gr < n) & (gc >= 0) & (gc < m)
        self.red = (gr + gc) % 2 == 0
        self.dist = torch.minimum(
            torch.minimum(ri, self.wr - 1 - ri)[:, None],
            torch.minimum(ci, self.w - 1 - ci)[None, :])

    def load(self, fields):
        return [_window(x, self.r0, self.c0, self.wr, self.w) for x in fields]

    def passes(self, us, bs, omegas, ids, coeffs, minv, red_black, exc,
               exc_minv):
        """The leg's passes on the window, pass p on the cells of its
        colour at distance >= p."""
        colours = (self.red, ~self.red) if red_black else (None,)
        exc, exc_minv = _local(exc, self.r0), _local(exc_minv, self.r0)
        p = 0
        for i in ids:
            for colour in colours:
                p += 1
                mask = self.inside & (self.dist >= p)
                if colour is not None:
                    mask = mask & colour
                us = trs._half_sweep(us, bs, omegas[i], coeffs, minv, mask,
                                     exc, exc_minv)
        return us

    def store(self, outs, us):
        """The tile of every window to the output fields."""
        h = self.h
        n, m = outs[0].shape
        rs, cs = self.r0 + h, self.c0 + h
        re, ce = min(rs + self.tr, n), min(cs + self.tc, m)
        for out, u in zip(outs, us):
            out[rs:re, cs:ce] = u[h:h + re - rs, h:h + ce - cs]


def _tiles(shape, halo, tile=(trs.LEG_TILE,) * 2):
    for by in range(-(-shape[0] // tile[0])):
        for bx in range(-(-shape[1] // tile[1])):
            yield by, bx, _Tile(shape, by, bx, halo, tile)


def emulate_down(fields, b_fields, omegas, ids, coeffs, minv, taps,
                 red_black, exc, exc_minv, halo):
    """The down-leg kernel's schedule: (smoothed fields, coarse
    residuals)."""
    n, m = fields[0].shape
    ct = trs.LEG_TILE // 2
    u_out = [torch.zeros_like(u) for u in fields]
    rc = [fields[0].new_zeros(((n - 1) // 2, (m - 1) // 2)) for _ in fields]
    for by, bx, tile in _tiles((n, m), halo):
        us, bs = tile.load(fields), tile.load(b_fields)
        us = tile.passes(us, bs, omegas, ids, coeffs, minv, red_black, exc,
                         exc_minv)
        tile.store(u_out, us)
        rs = trs._residuals(us, bs, coeffs, _local(exc, tile.r0))
        lo, hi = halo, halo + trs.LEG_TILE + 1
        for f, r in enumerate(rs):
            r = torch.where(tile.inside, r, 0.0)[lo:hi, lo:hi]
            coarse = axis_restrict_3tap(axis_restrict_3tap(r, 0, taps[0]), 1,
                                        taps[1])
            ci, cj = by * ct, bx * ct
            ce, cf = min(ci + ct, rc[f].shape[0]), min(cj + ct, rc[f].shape[1])
            rc[f][ci:ce, cj:cf] = coarse[:ce - ci, :cf - cj]
    return tuple(u_out), tuple(rc)


def _prolong_window(tile, e, taps, om0):
    """om0 * P(e) on the window's grid cells from e's coarse window of
    W / 2 + 2 rows and columns starting at floor(r0 / 2) - 1: the column
    expansion, then the row expansion."""
    cw = tile.w // 2 + 2
    cr0, cc0 = tile.r0 // 2 - 1, tile.c0 // 2 - 1
    ew = _window(e, cr0, cc0, cw, cw)
    idx = torch.arange(tile.w)

    def expand(first, coarse0, t):
        """(coarse window index before or at, weight on it, weight on the
        next) of each fine index on one axis."""
        g = first + idx
        a = torch.div(g - 1, 2, rounding_mode="floor") - coarse0
        odd = g % 2 == 1
        wa = torch.where(odd, t[1], t[2])
        wb = torch.where(odd, 0.0, t[0])
        return a, wa, wb

    row_taps, col_taps = (torch.tensor(t, dtype=e.dtype) for t in taps)
    ca, cwa, cwb = expand(tile.c0, cc0, col_taps)
    cols = cwa * ew[:, ca] + cwb * ew[:, ca + 1]
    ra, rwa, rwb = expand(tile.r0, cr0, row_taps)
    corr = rwa[:, None] * cols[ra] + rwb[:, None] * cols[ra + 1]
    return torch.where(tile.inside, om0 * corr, 0.0)


def emulate_up(fields, e_fields, b_fields, omegas, ids, coeffs, minv, taps,
               red_black, exc, exc_minv, halo):
    """The up-leg kernel's schedule: the corrected, smoothed fields."""
    u_out = [torch.zeros_like(u) for u in fields]
    for _, _, tile in _tiles(tuple(fields[0].shape), halo):
        us = [u + _prolong_window(tile, e, taps, omegas[ids[0]])
              for u, e in zip(tile.load(fields), e_fields)]
        us = tile.passes(us, tile.load(b_fields), omegas, ids[1:], coeffs,
                         minv, red_black, exc, exc_minv)
        tile.store(u_out, us)
    return tuple(u_out)


def _deviation(got, want):
    """Largest |got - want| over every array, relative to max |want|."""
    return max(float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


def _down(shape, table, sweeps, red_black, halo):
    coeffs, minv, exc, exc_minv, (r_taps, _) = _operator(table, shape[0])
    us, bs, _ = _inputs(shape, 11)
    omegas = torch.tensor(OMEGAS, dtype=torch.float64)
    ids = [1, 2, 3][:sweeps]
    want = trs.presmooth_residual_restrict_sys_plain(
        us, bs, omegas, ids, coeffs, minv, r_taps, red_black, exc, exc_minv)
    got = emulate_down(us, bs, omegas, ids, coeffs, minv, r_taps, red_black,
                       exc, exc_minv, halo)
    return _deviation(got[0] + got[1], want[0] + want[1])


def _up(shape, table, sweeps, red_black, halo):
    coeffs, minv, exc, exc_minv, (_, p_taps) = _operator(table, shape[0])
    us, bs, e = _inputs(shape, 12)
    omegas = torch.tensor(OMEGAS, dtype=torch.float64)
    ids = [0, 1, 2, 3][:sweeps + 1]
    want = trs.prolong_correct_postsmooth_sys_plain(
        us, e, bs, omegas, ids, coeffs, minv, p_taps, red_black, exc,
        exc_minv)
    got = emulate_up(us, e, bs, omegas, ids, coeffs, minv, p_taps, red_black,
                     exc, exc_minv, halo)
    return _deviation(got, want)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the windows are small, and the test run's
    parallel workers would otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("shape,table,sweeps,red_black", CASES)
def test_downleg_tile_schedule_matches_plain(shape, table, sweeps,
                                             red_black):
    halo = trs.leg_halo("down", sweeps, red_black)
    assert _down(shape, table, sweeps, red_black, halo) <= RTOL


@pytest.mark.parametrize("shape,table,sweeps,red_black", CASES)
def test_upleg_tile_schedule_matches_plain(shape, table, sweeps, red_black):
    halo = trs.leg_halo("up", sweeps, red_black)
    assert _up(shape, table, sweeps, red_black, halo) <= RTOL


@pytest.mark.parametrize("leg,sweeps,red_black",
                         [("down", 2, True), ("down", 1, False),
                          ("up", 1, True), ("up", 3, False)])
def test_halo_one_short_differs(leg, sweeps, red_black):
    """A halo one cell below leg_halo() leaves wrong cells in the tiles:
    the emulation shows a halo that is too small."""
    halo = trs.leg_halo(leg, sweeps, red_black) - 1
    run = _down if leg == "down" else _up
    assert run((131, 197), "random", sweeps, red_black, halo) > 1e-3


def test_leg_halo_rule():
    """P = 2S (red-black) or S (Jacobi); the down-leg needs P + 2 (today's
    8 for S = 3 red-black), the up-leg P; anything else is refused."""
    halos = {(leg, s, rb): trs.leg_halo(leg, s, rb)
             for leg in ("down", "up") for s in (1, 2, 3)
             for rb in (True, False)}
    assert halos == {("down", 1, True): 4, ("down", 2, True): 6,
                     ("down", 3, True): 8, ("down", 1, False): 3,
                     ("down", 2, False): 4, ("down", 3, False): 5,
                     ("up", 1, True): 2, ("up", 2, True): 4,
                     ("up", 3, True): 6, ("up", 1, False): 1,
                     ("up", 2, False): 2, ("up", 3, False): 3}
    with pytest.raises(ValueError):
        trs.leg_halo("sideways", 1, True)


# ---------------------------------------------------------------------------
# the red-black sweep kernel (rbgs_sys_kernel): the legs' passes with no
# transfer
# ---------------------------------------------------------------------------

#: the sweep's shapes: ragged and odd (the last blocks cut by the grid),
#: and 65x130, whose rows and columns no window divides
SWEEP_SHAPES = ((131, 197), (195, 129), (65, 130))
SWEEP_CASES = [(shape, table) for shape in SWEEP_SHAPES
               for table in ("elasticity", "random")]


def emulate_sweep(fields, b_fields, omegas, omega_id, coeffs, minv, exc,
                  exc_minv, halo):
    """The red-black sweep kernel's schedule: blocks of sweep_tile() tiles
    with windows of ``halo`` cells more on every side; red on the window
    cells at distance >= 1, black on those at >= 2."""
    out = [torch.zeros_like(u) for u in fields]
    for _, _, tile in _tiles(tuple(fields[0].shape), halo, trs.sweep_tile()):
        us = tile.passes(tile.load(fields), tile.load(b_fields), omegas,
                         [omega_id], coeffs, minv, True, exc, exc_minv)
        tile.store(out, us)
    return tuple(out)


def _sweep(shape, table, halo):
    coeffs, minv, exc, exc_minv, _ = _operator(table, shape[0])
    us, bs, _ = _inputs(shape, 14)
    omegas = torch.tensor(OMEGAS, dtype=torch.float64)
    want = trs.fused_rbgs_sweep_sys_plain(us, bs, omegas, 1, coeffs, minv,
                                          exc, exc_minv)
    got = emulate_sweep(us, bs, omegas, 1, coeffs, minv, exc, exc_minv, halo)
    return _deviation(got, want)


@pytest.mark.parametrize("shape,table", SWEEP_CASES)
def test_sweep_block_schedule_matches_plain(shape, table):
    assert _sweep(shape, table, trs.SWEEP_HALO) <= RTOL


@pytest.mark.parametrize("table", ["elasticity", "random"])
def test_sweep_halo_one_short_differs(table):
    """A halo of 1 (the same tile, a window two cells narrower) leaves
    wrong cells at the tiles' edges."""
    assert _sweep((131, 197), table, trs.SWEEP_HALO - 1) > 1e-3


def test_sweep_window_class():
    """The tile is the window less the halo of 2, with even rows and
    columns (so a window's colours follow its first cell's), 64 columns,
    and a block's threads divide the window's cells, so every thread
    copies as many as the others."""
    rows, cols = trs.SWEEP_WINDOW
    assert trs.SWEEP_HALO == 2 and cols == 64
    tr, tc = trs.sweep_tile()
    assert (tr, tc) == (rows - 4, cols - 4)
    assert tr % 2 == 0 and tc % 2 == 0
    assert rows * cols % trs.SWEEP_THREADS == 0
    assert trs.SWEEP_BLOCKS_PER_SM * trs.SWEEP_THREADS >= 1024


def test_sweep_window_class_matches_the_source():
    """The wrapper module's window class is the one csrc/rbgs_sys.cu
    builds: SweepWin's halo, rows x 64 columns, threads and least resident
    blocks (1024 threads)."""
    src = _build.SOURCES[
        [s.name for s in _build.SOURCES].index("rbgs_sys.cu")]
    text = src.read_text()
    win = text[text.index("struct SweepWin {"):]
    win = win[:win.index("};")]

    def const(pattern):
        return tuple(map(int, re.search(pattern, win).groups()))
    assert const(r"int H = (\d+);") == (trs.SWEEP_HALO,)
    assert const(r"int WR = (\d+), WC = (\d+);") == trs.SWEEP_WINDOW
    assert const(r"int NT = (\d+);") == (trs.SWEEP_THREADS,)
    assert "static constexpr int BLOCKS = 1024 / NT;" in win
    assert trs.SWEEP_BLOCKS_PER_SM == 1024 // trs.SWEEP_THREADS


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


@pytest.mark.parametrize("red_black", [True, False])
@pytest.mark.parametrize("err", [0, 1])
def test_wrappers_pass_the_halo_and_raise_on_refusal(monkeypatch, err,
                                                     red_black):
    """The leg wrappers hand each entry leg_halo(...) of their leg, sweeps
    and mode (before n, m and the stream), and raise, counting no launch,
    when the entry refuses; the library is a stand-in, since the kernels
    need the card."""
    from contextlib import nullcontext
    from types import SimpleNamespace
    from evostencils_tpu_torch.ops.kernels import _build
    lib = _FakeLibrary(err)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "on_card", lambda u: True)
    monkeypatch.setattr(torch.cuda, "device", lambda d: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=0))
    coeffs, minv, exc, exc_minv, (r_taps, p_taps) = _operator("random", 131)
    us, bs, e = (tuple(x.float() for x in group)
                 for group in _inputs((131, 197), 13))
    omegas = torch.tensor(OMEGAS, dtype=torch.float32)
    trs.reset_launches()
    calls = (
        (lambda: trs.presmooth_residual_restrict_sys(
            us, bs, omegas, [1, 2], coeffs, minv, r_taps, red_black, exc,
            exc_minv), "es_presmooth_residual_restrict_sys",
         trs.leg_halo("down", 2, red_black)),
        (lambda: trs.prolong_correct_postsmooth_sys(
            us, e, bs, omegas, [0, 1], coeffs, minv, p_taps, red_black, exc,
            exc_minv), "es_prolong_correct_postsmooth_sys",
         trs.leg_halo("up", 1, red_black)))
    for call, entry, halo in calls:
        if err:
            with pytest.raises(RuntimeError, match="launch failed"):
                call()
        else:
            call()
        name, args = lib.calls[-1]
        assert name == entry and args[-4:-1] == (halo, 131, 197)
    assert sum(trs.launches.values()) == (0 if err else 2)


@pytest.mark.parametrize("err", [0, 1])
def test_sweep_wrappers_pass_mode_and_shape_and_raise_on_refusal(
        monkeypatch, err):
    """The sweep wrappers hand es_sweep_sys the mode (1 red-black, 0
    Jacobi) and the grid's n, m (before the stream; the red-black kernel
    has one window, fixed in its entry), and raise, counting no launch,
    when the entry refuses; the library is a stand-in, since the kernels
    need the card."""
    from contextlib import nullcontext
    from types import SimpleNamespace
    from evostencils_tpu_torch.ops.kernels import _build
    lib = _FakeLibrary(err)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "on_card", lambda u: True)
    monkeypatch.setattr(torch.cuda, "device", lambda d: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=0))
    coeffs, minv, exc, exc_minv, _ = _operator("random", 65)
    us, bs, _ = (tuple(x.float() for x in group)
                 for group in _inputs((65, 130), 15))
    omegas = torch.tensor(OMEGAS, dtype=torch.float32)
    trs.reset_launches()
    calls = ((lambda: trs.fused_rbgs_sweep_sys(us, bs, omegas, 1, coeffs,
                                               minv, exc, exc_minv), 1),
             (lambda: trs.jacobi_sweep_sys(us, bs, omegas, 1, coeffs, minv,
                                           exc, exc_minv), 0))
    for call, red_black in calls:
        if err:
            with pytest.raises(RuntimeError, match="launch failed"):
                call()
        else:
            call()
        name, args = lib.calls[-1]
        assert name == "es_sweep_sys"
        assert args[-4:-1] == (red_black, 65, 130)
    assert trs.launches["fused_rbgs_sweep_sys"] == (0 if err else 1)
    assert trs.launches["jacobi_sweep_sys"] == (0 if err else 1)
