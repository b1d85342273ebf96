"""The block schedule of the variable-coefficient windowed kernels
(evostencils_tpu_torch/csrc/rbgs_var.cu, the legs ``downleg_var_kernel``
and ``upleg_var_kernel`` and the red-black sweep ``rbgs_var_kernel``),
emulated in float64 on the CPU.

The kernels cannot run here, but their halo arithmetic can.  Each block
owns a ``leg_tile(leg, S, red_black)`` tile and stages u, b and the
coefficient stack over a ``LEG_WINDOW`` window with a halo of
``leg_halo(leg, S, red_black)`` cells, zero outside the grid.  Pass p
(a red-black half-sweep, or a Jacobi sweep) updates only the window cells
at a distance >= p from the window edge, with the coefficients of the
staged window and 1/cc formed once per cell, so no update reads outside
the window.  The down-leg then forms the residual on the tile and one row
and column past it and restricts it; the up-leg prolongs e from the
block's staged coarse window before its passes.  The emulation runs every
block at once, as a batch of windows, with the plain versions' update
arithmetic, and stitches the tiles back together.  The result must equal
``presmooth_residual_restrict_var_plain`` and
``prolong_correct_postsmooth_var_plain`` to 1e-12 of their largest
magnitude; a halo one cell short must not, nor a stack whose two
neighbour planes are swapped.

The standalone red-black sweep, a form of the same kernel, is emulated
the same way in its ``SWEEP_WINDOW`` window: a halo of
``SWEEP_HALO``, red on the window cells at a distance >= 1 and black on
those at >= 2, with omega / cc formed once per cell, its TPU body's order
(rbgs_var.py:96, :113).  It must equal ``fused_rbgs_sweep_var_plain``
exactly; a halo one cell short, a swapped pair of neighbour planes and
the legs' omega * (1 / cc) must not.

The plain versions are held against the Pallas kernels in interpret mode
by tests/test_torch_var.py, so the chain reaches the JAX package.  The
stacks are the problem's own (``poisson_2d_variable``) and an anisotropic
random one whose four neighbour planes differ in mean, and the transfer
taps are asymmetric, so that a swapped plane, axis or direction shows; the
shapes are ragged and odd, so the last tiles are cut by the grid, and a
Jacobi leg's odd halo starts its windows at odd indices.  Last, the
wrappers are driven against a stand-in library: they must hand each entry
its leg's halo, or the sweep's window class, and raise when the entry
refuses the launch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F

from evostencils_tpu_torch.ops.apply import axis_restrict_3tap
from evostencils_tpu_torch.ops.kernels import rbgs_var as rv
# the batch of windows and the prolongation from each block's coarse
# window are the 2D Poisson legs' (the same tiling and transfers)
from tests.test_torch_transfer_tiles import _Blocks, _prolong_windows

#: max |emulated - plain| <= RTOL * max |plain|: the same float64
#: arithmetic, in another grouping only where the emulation restricts a
#: tile's residual and prolongs from a tile's coarse window
RTOL = 1e-12
OMEGAS = (0.9, 1.15, 0.8, 1.3)
#: neighbour-plane means of the random stack: north, south, west, east
MEANS = (-1.5, -0.5, -1.25, -0.75)
R_TAPS = ((0.2, 0.5, 0.3), (0.1, 0.6, 0.3))
P_TAPS = ((0.4, 1.0, 0.6), (0.3, 0.9, 0.5))
#: ragged odd shapes with the random stack, and the problem's 255^2 level
SHAPES = (((131, 197), "random"), ((195, 129), "random"),
          ((255, 255), "problem"))


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    n, m = shape
    u, b = (torch.tensor(rng.standard_normal(shape)) for _ in range(2))
    e = torch.tensor(rng.standard_normal(((n - 1) // 2, (m - 1) // 2)))
    return u, b, e


def _stack(shape, kind):
    """(5, n, m) float64 in FIVE_POINT_OFFSETS order."""
    if kind == "problem":
        from evostencils_tpu_torch.problems.poisson import poisson_2d_variable
        level = (shape[0] + 1).bit_length() - 1
        op = poisson_2d_variable(max_level=level, min_level=level - 1) \
            .level_contexts[0].operator.entries[0][0]
        sf = op.stencil_generator.generate_stencil_field(op.grid)
        return rv.five_point_stack(sf, device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(7)
    planes = [6.0 + rng.uniform(0.0, 1.0, shape)]
    planes += [mean + rng.uniform(-0.2, 0.2, shape) for mean in MEANS]
    return torch.tensor(np.stack(planes))


def _apply(u, c):
    """The operator of the staged stack windows c (5, T, wr, wc) on a batch
    of windows, zero past each window: cc*u + cn*up + cs*dn + cw*left +
    ce*right, in that order (rbgs_var.py:222)."""
    cc, cn, cs, cw, ce = c
    p = F.pad(u, (1, 1, 1, 1))
    return (cc * u + cn * p[:, :-2, 1:-1] + cs * p[:, 2:, 1:-1]
            + cw * p[:, 1:-1, :-2] + ce * p[:, 1:-1, 2:])


def _passes(blocks, u, b, c, omegas, ids, red_black):
    """The leg's passes on every window: pass p on the cells (of its
    colour) in the grid at a distance >= p, u + (omega * (1 / cc)) *
    (b - A u), 1/cc formed once per cell (``rbgs_var._leg_sweeps_plain``)."""
    dinv = torch.where(blocks.inside, 1.0 / c[0], 0.0)
    colours = (blocks.red, ~blocks.red) if red_black else (blocks.inside,)
    p = 0
    for i in ids:
        for colour in colours:
            p += 1
            mask = blocks.inside & colour & (blocks.dist >= p)
            upd = omegas[i] * dinv * (b - _apply(u, c))
            u = u + torch.where(mask, upd, 0.0)
    return u


def _windows(blocks, c_stack):
    return torch.stack([blocks.load(plane) for plane in c_stack])


def emulate_down(u, b, c_stack, omegas, ids, taps, red_black, tile, halo):
    """The down-leg kernel's schedule: (smoothed u, coarse residual)."""
    n, m = u.shape
    blocks = _Blocks((n, m), tile, halo)
    bw, cw = blocks.load(b), _windows(blocks, c_stack)
    uw = _passes(blocks, blocks.load(u), bw, cw, omegas, ids, red_black)
    h, tr, tc = halo, blocks.tr, blocks.tc
    u_out = blocks.stitch(uw[:, h:h + tr, h:h + tc], (n, m), tr, tc)
    r = torch.where(blocks.inside, bw - _apply(uw, cw), 0.0)
    r = r[:, h:h + tr + 1, h:h + tc + 1]
    coarse = axis_restrict_3tap(axis_restrict_3tap(r, 1, taps[0]), 2, taps[1])
    rc = blocks.stitch(coarse, ((n - 1) // 2, (m - 1) // 2), tr // 2, tc // 2)
    return u_out, rc


def emulate_up(u, e, b, c_stack, omegas, ids, taps, red_black, tile, halo):
    """The up-leg kernel's schedule: the corrected, smoothed u."""
    n, m = u.shape
    blocks = _Blocks((n, m), tile, halo)
    corr = torch.where(blocks.inside, _prolong_windows(blocks, e, taps), 0.0)
    uw = blocks.load(u) + omegas[ids[0]] * corr
    uw = _passes(blocks, uw, blocks.load(b), _windows(blocks, c_stack),
                 omegas, ids[1:], red_black)
    h = halo
    return blocks.stitch(uw[:, h:h + blocks.tr, h:h + blocks.tc], (n, m),
                         blocks.tr, blocks.tc)


def _deviation(got, want):
    """Largest |got - want| over every array, relative to max |want|."""
    return max(float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


def _down(shape, kind, sweeps, red_black, halo=None, stack=None):
    """Deviation of the emulated down-leg from the plain one; the halo is
    the leg's unless given, the emulation's stack the plain one's unless
    given."""
    u, b, _ = _inputs(shape, 11)
    c = _stack(shape, kind)
    omegas = torch.tensor(OMEGAS, dtype=torch.float64)
    ids = [1, 2, 3][:sweeps]
    tile = rv.leg_tile("down", sweeps, red_black)
    halo = rv.leg_halo("down", sweeps, red_black) if halo is None else halo
    want = rv.presmooth_residual_restrict_var_plain(u, b, omegas, ids, c,
                                                    R_TAPS, red_black)
    got = emulate_down(u, b, c if stack is None else stack(c), omegas, ids,
                       R_TAPS, red_black, tile, halo)
    return _deviation(got, want)


def _up(shape, kind, sweeps, red_black, halo=None, stack=None):
    u, b, e = _inputs(shape, 12)
    c = _stack(shape, kind)
    omegas = torch.tensor(OMEGAS, dtype=torch.float64)
    ids = [0, 1, 2, 3][:sweeps + 1]
    tile = rv.leg_tile("up", sweeps, red_black)
    halo = rv.leg_halo("up", sweeps, red_black) if halo is None else halo
    want = rv.prolong_correct_postsmooth_var_plain(u, e, b, omegas, ids, c,
                                                   P_TAPS, red_black)
    got = emulate_up(u, e, b, c if stack is None else stack(c), omegas, ids,
                     P_TAPS, red_black, tile, halo)
    return _deviation((got,), (want,))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test run's parallel workers would
    otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CASES = [(shape, kind, sweeps, red_black) for shape, kind in SHAPES
         for sweeps in (1, 2, 3) for red_black in (True, False)]
IDS = [f"{s[0]}x{s[1]}-{k}-S{n}-{'rb' if r else 'jacobi'}"
       for s, k, n, r in CASES]


@pytest.mark.parametrize("shape,kind,sweeps,red_black", CASES, ids=IDS)
def test_downleg_block_schedule_matches_plain(shape, kind, sweeps,
                                              red_black):
    assert _down(shape, kind, sweeps, red_black) <= RTOL


@pytest.mark.parametrize("shape,kind,sweeps,red_black", CASES, ids=IDS)
def test_upleg_block_schedule_matches_plain(shape, kind, sweeps, red_black):
    assert _up(shape, kind, sweeps, red_black) <= RTOL


@pytest.mark.parametrize("leg,sweeps,red_black",
                         [("down", 2, True), ("down", 1, False),
                          ("down", 3, False), ("up", 1, True),
                          ("up", 3, True), ("up", 2, False)])
def test_halo_one_short_differs(leg, sweeps, red_black):
    """A halo one cell below leg_halo() (the same tile, a window two cells
    narrower) leaves wrong cells in the tiles."""
    halo = rv.leg_halo(leg, sweeps, red_black) - 1
    run = _down if leg == "down" else _up
    assert run((131, 197), "random", sweeps, red_black, halo) > 1e-3


@pytest.mark.parametrize("leg", ["down", "up"])
@pytest.mark.parametrize("planes", [(1, 2), (3, 4)])
def test_swapped_neighbour_planes_differ(leg, planes):
    """The schedule run on a stack whose north and south (or west and
    east) planes are swapped does not match: the data would show a kernel
    that indexed the planes wrongly."""
    i, j = planes

    def swap(c):
        c = c.clone()
        c[[i, j]] = c[[j, i]]
        return c
    run = _down if leg == "down" else _up
    assert run((131, 197), "random", 2 if leg == "down" else 1, True,
               stack=swap) > 1e-3


def test_leg_rule():
    """The halo is P + 2 down and P up, P = 2S red-black or S Jacobi; the
    tile is the window less the halo; the window fits every leg."""
    assert [rv.leg_halo(leg, s, rb) for rb in (True, False)
            for leg in ("down", "up") for s in (1, 2, 3)] == \
        [4, 6, 8, 2, 4, 6, 3, 4, 5, 1, 2, 3]
    with pytest.raises(ValueError):
        rv.leg_halo("sideways", 1, True)
    rows, cols = rv.LEG_WINDOW
    assert rv.leg_tile("down", 2, True) == (rows - 12, cols - 12)
    assert rv.leg_tile("up", 1, False) == (rows - 2, cols - 2)
    assert min(min(rv.leg_tile(leg, s, rb)) for leg in ("down", "up")
               for s in (1, 2, 3) for rb in (True, False)) > 0
    assert all(rv.leg_tile(leg, s, rb)[0] % 2 == 0 for leg in ("down", "up")
               for s in (1, 2, 3) for rb in (True, False))


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


@pytest.mark.parametrize("err", [0, 1])
@pytest.mark.parametrize("red_black", [True, False])
def test_wrappers_pass_halo_and_raise_on_refusal(monkeypatch, err,
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
    u, b, e = (x.float() for x in _inputs((131, 197), 13))
    c = _stack((131, 197), "random").float()
    omegas = torch.tensor(OMEGAS, dtype=torch.float32)
    rv.reset_launches()
    calls = (
        (lambda: rv.presmooth_residual_restrict_var(
            u, b, omegas, [1, 2], c, R_TAPS, red_black=red_black),
         "es_presmooth_residual_restrict_var", ("down", 2)),
        (lambda: rv.prolong_correct_postsmooth_var(
            u, e, b, omegas, [0, 1], c, P_TAPS, red_black=red_black),
         "es_prolong_correct_postsmooth_var", ("up", 1)))
    for call, entry, (leg, sweeps) in calls:
        if err:
            with pytest.raises(RuntimeError, match="launch failed"):
                call()
        else:
            call()
        name, args = lib.calls[-1]
        assert name == entry and args[-4:-1] == (
            rv.leg_halo(leg, sweeps, red_black), 131, 197)
    assert rv.launches["presmooth_residual_restrict_var"] + \
        rv.launches["prolong_correct_postsmooth_var"] == (0 if err else 2)


# ---------------------------------------------------------------------------
# The standalone red-black sweep (``rbgs_var_kernel``, es_sweep_var), a
# form of the same kernel: the tile ``sweep_tile()``, a halo of
# SWEEP_HALO, red on the window cells at a
# distance >= 1 and black on those at >= 2, with omega / cc formed once
# per cell from the staged centre coefficient, as the TPU body forms dinv
# (rbgs_var.py:96).
# ---------------------------------------------------------------------------

#: max |emulated - plain| <= SWEEP_RTOL * max |plain|: the sweep's own
#: float64 operations in its own order on every updated cell, so the
#: emulation equals the plain version exactly; a factor formed as
#: omega * (1 / cc) rounds differently in the last place and must not
SWEEP_RTOL = 0.0
#: the sweep's shapes: the legs' and, from the sweep's path
#: ([evaluator-var]), 511^2 and 1023^2 with the problem's stack
SWEEP_SHAPES = SHAPES + (((511, 511), "problem"), ((1023, 1023), "problem"))


def emulate_sweep(u, b, c_stack, omega, tile, halo, product=False):
    """The sweep kernel's schedule: the tiles of one red-black sweep.
    ``product``: the factor formed as omega * (1 / cc), the legs' order,
    in place of omega / cc."""
    n, m = u.shape
    blocks = _Blocks((n, m), tile, halo)
    bw, cw = blocks.load(b), _windows(blocks, c_stack)
    dinv = omega * (1.0 / cw[0]) if product else omega / cw[0]
    uw = blocks.load(u)
    for p, colour in ((1, blocks.red), (2, ~blocks.red)):
        mask = blocks.inside & colour & (blocks.dist >= p)
        uw = uw + torch.where(mask, dinv * (bw - _apply(uw, cw)), 0.0)
    h, tr, tc = halo, blocks.tr, blocks.tc
    return blocks.stitch(uw[:, h:h + tr, h:h + tc], (n, m), tr, tc)


def _sweep(shape, kind, halo=rv.SWEEP_HALO, stack=None, product=False):
    """Deviation of the emulated sweep from the plain one, relative to
    max |plain|."""
    u, b, _ = _inputs(shape, 14)
    c = _stack(shape, kind)
    omegas = torch.tensor(OMEGAS, dtype=torch.float64)
    want = rv.fused_rbgs_sweep_var_plain(u, b, omegas, 1, c)
    got = emulate_sweep(u, b, c if stack is None else stack(c), omegas[1],
                        rv.sweep_tile(), halo, product)
    return _deviation((got,), (want,))


@pytest.mark.parametrize("shape,kind", SWEEP_SHAPES,
                         ids=[f"{s[0]}x{s[1]}-{k}" for s, k in SWEEP_SHAPES])
def test_sweep_block_schedule_matches_plain(shape, kind):
    assert _sweep(shape, kind) <= SWEEP_RTOL


@pytest.mark.parametrize("shape,kind", SHAPES[:2],
                         ids=[f"{s[0]}x{s[1]}-{k}" for s, k in SHAPES[:2]])
def test_sweep_halo_one_short_differs(shape, kind):
    assert _sweep(shape, kind, rv.SWEEP_HALO - 1) > 1e-3


@pytest.mark.parametrize("planes", [(1, 2), (3, 4)])
def test_sweep_swapped_neighbour_planes_differ(planes):
    i, j = planes

    def swap(c):
        c = c.clone()
        c[[i, j]] = c[[j, i]]
        return c
    assert _sweep((131, 197), "random", stack=swap) > 1e-3


@pytest.mark.parametrize("shape,kind", SWEEP_SHAPES[::2],
                         ids=[f"{s[0]}x{s[1]}-{k}"
                              for s, k in SWEEP_SHAPES[::2]])
def test_sweep_factor_order_differs(shape, kind):
    """The legs' omega * (1 / cc) in place of the sweep's omega / cc
    rounds differently, and the emulation tells the two apart."""
    assert _sweep(shape, kind, product=True) > SWEEP_RTOL


def test_sweep_windows():
    """The sweep's tile is its window less the halo, with even rows and
    columns; its window is as wide as the legs' and half as tall, in
    blocks of as many threads."""
    rows, cols = rv.SWEEP_WINDOW
    assert rv.SWEEP_HALO == 2
    tr, tc = rv.sweep_tile()
    assert (tr, tc) == (rows - 4, cols - 4)
    assert tr % 2 == 0 and tc % 2 == 0
    assert (2 * rows, cols) == rv.LEG_WINDOW
    assert rv.SWEEP_THREADS == rv.LEG_THREADS
    assert rv.SWEEP_BLOCKS_PER_SM == 2 * rv.LEG_BLOCKS_PER_SM


@pytest.mark.parametrize("err", [0, 1])
def test_sweep_wrappers_pass_window_and_raise_on_refusal(monkeypatch, err):
    """es_sweep_var takes the mode, the output, then n, m and the stream
    (the red-black sweep has one window, fixed in the entry): the
    red-black wrapper hands it mode 1, the Jacobi wrapper 0; each raises,
    counting no launch, when the entry refuses; the library is a
    stand-in, since the kernels need the card."""
    from tests.test_torch_transfer_tiles import _stand_in_card
    lib = _stand_in_card(monkeypatch, err)
    shape = (1023, 1023)
    u, b, _ = (x.float() for x in _inputs(shape, 15))
    c = _stack(shape, "random").float()
    omegas = torch.tensor(OMEGAS, dtype=torch.float32)
    rv.reset_launches()
    calls = ((lambda: rv.fused_rbgs_sweep_var(u, b, omegas, 1, c), 1),
             (lambda: rv.jacobi_sweep_var(u, b, omegas, 2, c), 0))
    for call, red_black in calls:
        if err:
            with pytest.raises(RuntimeError, match="launch failed"):
                call()
        else:
            call()
        name, args = lib.calls[-1]
        assert name == "es_sweep_var"
        assert args[5] == red_black and args[-3:-1] == shape
    assert rv.launches["fused_rbgs_sweep_var"] == (0 if err else 1)
    assert rv.launches["jacobi_sweep_var"] == (0 if err else 1)
