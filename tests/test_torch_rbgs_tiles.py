"""The strip schedule of the single-pass 5-point sweep kernel and the block
schedule of the red-black one (evostencils_tpu_torch/csrc/rbgs.cu,
``sweep_kernel`` and ``fused_rbgs_kernel``), emulated in float64 on the
CPU.

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

The red-black kernel owns a ``fused_tile()`` tile and stages u and b over
a ``FUSED_WINDOW`` window with a halo of ``FUSED_HALO`` cells, zero outside
the grid.  Its red half-sweep updates the window cells at a distance >= 1
from the window edge, its black one those at >= 2, with the TPU kernel's
sum order; the tiles are stitched back together.  The result must equal
``fused_rbgs_sweep_plain`` to 1e-12, and neither a halo one cell short nor
a red pass that leaves out the ring around the tile may.  A black pass
that reaches distance 1 stores the same tiles (the cells it adds lie in
the halo, which no block stores).  Shapes: the single-pass ones and the
gate's 255^2 level.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F

from evostencils_tpu_torch.ops.kernels import _build
from evostencils_tpu_torch.ops.kernels import rbgs as tr
from tests.test_torch_transfer_tiles import _Blocks, _stand_in_card

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


# ---------------------------------------------------------------------------
# the red-black kernel (fused_rbgs_kernel)
# ---------------------------------------------------------------------------

FUSED_SHAPES = SHAPES + ((255, 255),)
_FUSED_IDS = [f"{n}x{m}" for n, m in FUSED_SHAPES]


def _fused_update(u, b, om_dinv, vals):
    """``om_dinv * (b - A u)`` on a batch of windows, zero past each window,
    A u summed c*v + (((up + down) + left) + right) as the kernel does."""
    cc, cu, cd, cl, cr = (float(v) for v in vals)
    p = F.pad(u, (1, 1, 1, 1))
    off = (cu * p[:, :-2, 1:-1] + cd * p[:, 2:, 1:-1] + cl * p[:, 1:-1, :-2]
           + cr * p[:, 1:-1, 2:])
    return om_dinv * (b - (cc * u + off))


def emulate_fused(u, b, omega, vals, halo=tr.FUSED_HALO, reach=(1, 2)):
    """The kernel's schedule: red on the window cells at a distance >=
    reach[0], black on those at >= reach[1], then the tiles."""
    n, m = u.shape
    blocks = _Blocks((n, m), tr.fused_tile(), halo)
    uw, bw = blocks.load(u), blocks.load(b)
    om_dinv = omega * (1.0 / float(vals[0]))
    for dist, colour in zip(reach, (blocks.red, ~blocks.red)):
        mask = blocks.inside & colour & (blocks.dist >= dist)
        uw = uw + torch.where(mask, _fused_update(uw, bw, om_dinv, vals), 0.0)
    h, rows, cols = halo, blocks.tr, blocks.tc
    return blocks.stitch(uw[:, h:h + rows, h:h + cols], (n, m), rows, cols)


def _fused_deviation(shape, **kw):
    u, b = _inputs(shape, 41)
    omegas = torch.tensor(OMEGAS, dtype=torch.float64)
    want = tr.fused_rbgs_sweep_plain(u, b, omegas, 1, VALS)
    got = emulate_fused(u, b, float(omegas[1]), VALS, **kw)
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("shape", FUSED_SHAPES, ids=_FUSED_IDS)
def test_fused_block_schedule_matches_plain(shape):
    assert _fused_deviation(shape) <= RTOL


@pytest.mark.parametrize("shape", FUSED_SHAPES[:3], ids=_FUSED_IDS[:3])
def test_fused_halo_one_short_differs(shape):
    """A halo of 1 (the same tile, a window two cells narrower) leaves
    wrong cells at the tiles' edges."""
    assert _fused_deviation(shape, halo=tr.FUSED_HALO - 1) > 1e-3


def test_fused_red_pass_without_the_ring_differs():
    """A red pass on the tile alone (distance >= 2) leaves the black
    cells at the tile's edge with stale red neighbours."""
    assert _fused_deviation((300, 200), reach=(2, 2)) > 1e-3


def test_fused_black_pass_past_the_tile_stores_the_same_tiles():
    """A black pass that also reaches distance 1 updates halo cells only,
    which no block stores: distance >= 2 is all the tile needs."""
    u, b = _inputs((129, 130), 42)
    omega = OMEGAS[1]
    want = emulate_fused(u, b, omega, VALS)
    got = emulate_fused(u, b, omega, VALS, reach=(1, 1))
    assert torch.equal(got, want)


def test_fused_window_constants():
    """The tile is the window less the halo, with even rows and columns
    (tiles start at even indices, so a window cell's colour is the parity
    of its window indices); the block is whole warps, one a slot row, and
    a thread's rows share a parity."""
    rows, cols = tr.FUSED_WINDOW
    assert tr.FUSED_HALO == 2
    tile_rows, tile_cols = tr.fused_tile()
    assert (tile_rows, tile_cols) == (rows - 4, cols - 4)
    assert tile_rows % 2 == 0 and tile_cols % 2 == 0
    ny = tr.FUSED_THREADS // (cols // 2)
    assert tr.FUSED_THREADS % (cols // 2) == 0 and (cols // 2) % 32 == 0
    assert ny % 2 == 0 and rows % ny == 0
    assert tr.FUSED_BLOCKS_PER_SM * tr.FUSED_THREADS <= 2048


def test_fused_window_constants_match_the_source():
    """The wrapper module's window is the one csrc/rbgs.cu builds: its
    FusedShape's halo, rows, slots (half the columns), thread rows and
    least resident blocks."""
    src = _build.SOURCES[[s.name for s in _build.SOURCES].index("rbgs.cu")]
    text = src.read_text()
    shape = text[text.index("struct FusedShape {"):]
    shape = shape[:shape.index("};")]
    halo = re.search(r"static constexpr int H = (\d+);", shape)
    window = re.search(
        r"static constexpr int WR = (\d+), SL = (\d+), NY = (\d+);", shape)
    blocks = re.search(r"static constexpr int BLOCKS = (\d+);", shape)
    wr, sl, ny = map(int, window.groups())
    assert int(halo.group(1)) == tr.FUSED_HALO
    assert (wr, 2 * sl) == tr.FUSED_WINDOW
    assert sl * ny == tr.FUSED_THREADS
    assert int(blocks.group(1)) == tr.FUSED_BLOCKS_PER_SM


@pytest.mark.parametrize("err", [0, 1])
def test_fused_wrapper_passes_shape_and_raises_on_refusal(monkeypatch, err):
    """fused_rbgs_sweep hands es_fused_rbgs_sweep the grid's n, m (before
    the stream; the kernel has one window, fixed in its entry) at each
    level of the path and a ragged shape, and raises, counting no launch,
    when the entry refuses; the library is a stand-in, since the kernel
    needs the card."""
    lib = _stand_in_card(monkeypatch, err)
    omegas = torch.tensor(OMEGAS, dtype=torch.float32)
    tr.reset_launches()
    shapes = ((1023, 1023), (255, 255), (300, 200))
    for shape in shapes:
        u = torch.zeros(shape, dtype=torch.float32)
        if err:
            with pytest.raises(RuntimeError, match="launch failed"):
                tr.fused_rbgs_sweep(u, u, omegas, 1, VALS)
        else:
            assert tr.fused_rbgs_sweep(u, u, omegas, 1, VALS).shape == shape
        name, args = lib.calls[-1]
        assert name == "es_fused_rbgs_sweep" and args[3] == 1
        assert args[-3:-1] == shape
    assert tr.launches == {"fused_rbgs_sweep": 0 if err else len(shapes),
                           "jacobi_sweep": 0}


#: the levels at which one cycle of each stored 2D Poisson champion of the
#: [evaluator] cell (1023^2, levels 10 -> 5; picked by fitness as
#: chip_smoke.py picks them) calls the red-black sweep and the
#: prolongation-correction
CHAMPION_CALLS = {
    ("poisson2d_1023sq_seeded_gen75", "est_t_conv_ms"):
        [("fused_rbgs_sweep", (1023, 1023)), ("prolong_correct", (255, 255))],
    ("poisson2d_1023sq_seeded_gen50", "fitness_ms_per_iter"):
        [("prolong_correct", (255, 255))],
}


@pytest.mark.parametrize("key,fitness", sorted(CHAMPION_CALLS),
                         ids=[k for k, _ in sorted(CHAMPION_CALLS)])
def test_champion_levels_of_the_red_black_sweep_and_prolongation(
        monkeypatch, key, fitness):
    """Where a champion's cycle reaches the two kernels: its lowering
    takes the wrappers, recorded here with the grid each is called on
    (the wrappers take their plain versions on the CPU, so one float32
    cycle runs as on the card)."""
    import json
    import pathlib
    from evostencils_tpu_torch.compiler.lower import lower_cycle
    from evostencils_tpu_torch.compiler.solve import make_cycle_loop
    from evostencils_tpu_torch.grammar import gp
    from evostencils_tpu_torch.grammar.multigrid import generate_primitive_set
    from evostencils_tpu_torch.ir import transformations
    from evostencils_tpu_torch.ops.kernels import transfer
    from evostencils_tpu_torch.problems.poisson import build_rhs, poisson_2d

    calls = []
    for module, name in ((tr, "fused_rbgs_sweep"),
                         (transfer, "prolong_correct")):
        def record(u, *args, _name=name, _fn=getattr(module, name)):
            calls.append((_name, tuple(u.shape)))
            return _fn(u, *args)
        monkeypatch.setattr(module, name, record)
    entries = json.loads((pathlib.Path(__file__).resolve().parents[1]
                          / "results" / "evolved_champions.json")
                         .read_text())[key]
    grammar = min(entries, key=lambda entry: entry[fitness])["grammar"]
    problem = poisson_2d(max_level=10, min_level=5)
    pset = generate_primitive_set(problem.approximation, problem.rhs_entity,
                                  problem.level_contexts,
                                  problem.coarsest_operator)[0]
    cycle = gp.compile_tree(gp.parse_tree(grammar, pset), pset)[0]
    transformations.assign_cycle_ids(cycle)
    lowered = lower_cycle(cycle, problem.approximation, problem.rhs_entity)
    b = build_rhs(problem, dtype=torch.float32, device="cpu")
    omegas = torch.tensor(lowered.default_omegas, dtype=torch.float32)
    make_cycle_loop(lowered, 1)(tuple(torch.zeros_like(x) for x in b), b,
                                omegas)
    assert calls == CHAMPION_CALLS[(key, fitness)]
