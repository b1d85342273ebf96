"""The block schedule of the 3D leg kernels
(evostencils_tpu_torch/csrc/wavefront3d.cu, ``downleg3d_kernel`` and
``upleg3d_kernel``) and of the standalone kernels that run the same plane
pipeline (csrc/sweep3d.cu ``rb_sweep3d_kernel``, the red-black sweep: the
up-leg with no correction; csrc/leg3d.cu ``residual_restrict3d_kernel``:
the down-leg with no sweep; csrc/leg3d.cu ``prolong_correct3d_kernel``:
the up-leg's prolongation with no sweep), emulated in float64 on the
CPU.

The kernels cannot run here, but their schedule can.  Each block owns a
``TILE[leg]`` x ``TILE[leg]`` tile of the (axis-1, axis-2) plane and loads
a window ``HALO[leg]`` = (before, after) cells wider on both in-plane
axes, zero outside the grid (``HALO_NEEDED[leg]`` is what the schedule
needs; the up-leg's and the sweep's windows have one cell more after the
tile, for odd rows).  It walks a chunk of axis 0 (the kernel's chunk
rule) with ``WARMUP[leg]`` planes loaded before the chunk's first plane and after the
last plane it needs; the planes beyond read as zero and are never updated.
At step s plane s arrives (the up-leg adds its prolonged correction then),
and half-sweep k runs on plane s - 1 - LAG * (k - 1), on the window cells
of its colour at a distance >= k from the window edge.  All half-sweeps of
a step are computed here from the state at the step's start, as the
kernel runs them in one pass: with ``LAG`` = 2 they touch disjoint cells,
so that equals the sequential sweeps, and with a lag of 1 it does not.
The down-leg's owner of a cell forms the residual of the plane one behind
the last half-sweep's; the emulation does too, and restricts the residual
of the tile and one more row and column over the chunk's planes.

Each step runs the plain module's own half-sweep and residual arithmetic
(``wavefront3d._half_sweep``, ``_residual``) on the three planes around
the swept one, and the plain transfers (``axis_restrict_3tap``,
``axis_prolong_3tap``) on the block's windows.  The blocks are stitched
back together and must equal ``downleg_wavefront_3d_plain`` /
``upleg_wavefront_3d_plain`` (``fused_rbgs_sweep_3d_plain``,
``residual_restrict_3d_plain``) to 1e-12 of their largest magnitude; a
halo, a warm-up or a lag one short must not.  The plain versions are held
against the Pallas kernels in interpret mode by
tests/test_torch_wavefront3d.py and tests/test_torch_sweep3d.py, so the
chain reaches the JAX package.
The shapes are ragged and odd, so the last tiles and chunks are cut by the
grid; the stencil is anisotropic and the taps asymmetric on every axis.

The prolongation-correction has no halo: a block's window is its tile.
It stages e's coarse window (``leg3d.PC_TILE`` / 2 + 1 cells a side from
coarse index y0/2 - 1 on) for the chunk's coarse planes only, forms the
axis-0 pass of fine plane s + 1 at step s into a double buffer, and
corrects plane s by the axis-1 and then the axis-2 pass over it; stitched,
it must equal ``prolong_correct_3d_plain`` to 1e-12, and a coarse window
one cell short or a chunk one coarse plane short must not.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from evostencils_tpu_torch.ops.apply import (axis_prolong_3tap,
                                             axis_restrict_3tap)
from evostencils_tpu_torch.ops.kernels import leg3d as l3
from evostencils_tpu_torch.ops.kernels import rbgs3d as r3
from evostencils_tpu_torch.ops.kernels import wavefront3d as tw

#: max |emulated - plain| <= RTOL * max |plain|: the same float64
#: arithmetic on each block's window
RTOL = 1e-12
#: an SM count for the chunking rule (the H100's 132)
SMS = 132
STENCIL = (7.0, -1.5, -0.5, -1.25, -0.75, -2.0, -1.0)
R_TAPS = ((0.2, 0.5, 0.3), (0.1, 0.6, 0.3), (0.3, 0.45, 0.25))
P_TAPS = ((0.4, 1.0, 0.6), (0.3, 0.9, 0.5), (0.7, 1.1, 0.2))
#: the up-leg's correction factor, then the sweeps' (they differ, so a
#: swapped sweep shows)
OMEGAS = (0.9, 1.15, 0.8)
SHAPES = ((35, 67, 45), (45, 35, 69))
#: the standalone kernels' shapes: small and ragged, odd on every axis as
#: the restriction needs (the red-black sweep also takes even sizes)
STANDALONE_SHAPES = {"sweep": ((17, 33, 63), (33, 65, 63), (19, 17, 127),
                               (12, 40, 70)),
                     "restrict": ((17, 33, 63), (33, 65, 63),
                                  (19, 17, 127))}


def _chunk(leg, n0, n1, n2):
    """The kernel's axis-0 chunk on a 132-SM card."""
    if leg == "sweep":
        return r3.rb_chunk_planes(n0, n1, n2, SMS)
    if leg == "restrict":
        return l3.rr_chunk_planes(n0, n1, n2, SMS)
    if leg == "prolong":
        return l3.pc_chunk_planes(n0, n1, n2, SMS)
    return tw.chunk_planes(n0, n1, n2, leg, SMS)


#: each kernel's tile edge, its halo (before, after), the halo its
#: schedule needs and its warm-up
TILE = {"down": tw.TILE, "up": tw.TILE, "sweep": r3.RB_TILE,
        "restrict": l3.RR_TILE, "prolong": l3.PC_TILE}
HALO = dict(tw.HALO, sweep=r3.RB_HALO, restrict=l3.RR_HALO)
HALO_NEEDED = dict(tw.HALO_NEEDED, sweep=r3.RB_HALO_NEEDED,
                   restrict=l3.RR_HALO)
WARMUP = dict(tw.WARMUP, sweep=r3.RB_WARMUP, restrict=l3.RR_WARMUP)


def _window(x, starts, sizes):
    """x over [start, start + size) on every axis, zero outside."""
    out = x.new_zeros(sizes)
    src, dst = [], []
    for s, w, n in zip(starts, sizes, x.shape):
        lo, hi = max(s, 0), min(s + w, n)
        if lo >= hi:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - s, hi - s))
    out[tuple(dst)] = x[tuple(src)]
    return out


class _Block:
    """One block of a leg: its window (planes pa - 1 .. pb + 1, the outer
    two zero; TILE + before + after cells on axes 1 and 2), the grid cells
    in it, their colour parity and distance to the window edge."""

    def __init__(self, shape, leg, by, bx, z0, chunk, halo, warm):
        n0, n1, n2 = shape
        before, after = halo
        self.h, self.t = before, TILE[leg]
        self.w = self.t + before + after
        self.y0, self.x0 = by * self.t - before, bx * self.t - before
        self.z0, self.z1 = z0, min(z0 + chunk, n0)
        self.qmax = min(z0 + chunk, n0 - 1)
        last = self.qmax if leg in ("down", "restrict") else self.z1 - 1
        self.L0 = z0 - warm
        self.pa, self.pb = max(self.L0, 0), min(last + warm, n0 - 1)
        idx = torch.arange(self.w)
        gy, gx = self.y0 + idx[:, None], self.x0 + idx[None, :]
        self.inside = (gy >= 0) & (gy < n1) & (gx >= 0) & (gx < n2)
        self.par = (gy + gx) % 2
        edge = torch.minimum(idx, self.w - 1 - idx)
        self.dist = torch.minimum(edge[:, None], edge[None, :])

    def load(self, x):
        """x's window, with a zero plane before pa and after pb."""
        out = _window(x, (self.pa - 1, self.y0, self.x0),
                      (self.pb - self.pa + 3, self.w, self.w))
        out[0] = out[-1] = 0.0
        return out

    def slot(self, plane):
        return plane - self.pa + 1

    def sweep(self, state, u, b, plane, k, om):
        """Half-sweep k (red when odd) of ``plane`` from ``state`` (the
        step's start) into u, on the cells at distance >= k."""
        if not self.pa <= plane <= self.pb:
            return
        i = self.slot(plane)
        red = (plane + self.par) % 2 == 1
        mask = self.inside & (self.dist >= k) & (red if k % 2 else ~red)
        mask3 = torch.zeros((3, self.w, self.w), dtype=torch.bool)
        mask3[1] = mask
        new = tw._half_sweep(state[i - 1:i + 2], b[i - 1:i + 2], om, mask3,
                             STENCIL)
        u[i] = new[1]

    def store(self, out, u):
        """The tile of planes [z0, z1) of the window into out."""
        t, h = self.t, self.h
        _, n1, n2 = out.shape
        ys, xs = self.y0 + h, self.x0 + h
        ye, xe = min(ys + t, n1), min(xs + t, n2)
        s0, s1 = self.slot(self.z0), self.slot(self.z1)
        out[self.z0:self.z1, ys:ye, xs:xe] = \
            u[s0:s1, h:h + ye - ys, h:h + xe - xs]


def _blocks(shape, leg, halo, warm):
    n0, n1, n2 = shape
    chunk, tile = _chunk(leg, n0, n1, n2), TILE[leg]
    for z0 in range(0, n0, chunk):
        for by in range(-(-n1 // tile)):
            for bx in range(-(-n2 // tile)):
                yield _Block(shape, leg, by, bx, z0, chunk, halo, warm)


def emulate_down(u, b, halo, warm, lag, leg="down", sweeps=2):
    """The down-leg kernel's schedule (``sweeps`` red-black sweeps, the
    residual and its restriction): (u_s, rc); with ``leg`` "restrict" and
    no sweep, the residual restriction's."""
    oms = (OMEGAS[1], OMEGAS[2])
    u_out = torch.zeros_like(u)
    rc = u.new_zeros(tuple((n - 1) // 2 for n in u.shape))
    ct = TILE[leg] // 2
    # the residual's plane, behind s: one behind the last half-sweep's, or
    # behind the arriving plane
    halves = 2 * sweeps
    behind = 1 + lag * (halves - 1) + 1 if halves else 1
    for blk in _blocks(u.shape, leg, halo, warm):
        uw, bw = blk.load(u), blk.load(b)
        t, h = blk.t, blk.h
        res = u.new_zeros((blk.qmax - blk.z0 + 1, t + 1, t + 1))
        for s in range(blk.L0, blk.qmax + behind + 1):
            state = uw.clone()
            for k in range(1, halves + 1):
                blk.sweep(state, uw, bw, s - 1 - lag * (k - 1), k,
                          oms[(k - 1) // 2])
            q = s - behind
            if blk.z0 <= q <= blk.qmax:
                i = blk.slot(q)
                r = tw._residual(uw[i - 1:i + 2], bw[i - 1:i + 2],
                                 STENCIL)[1]
                r = torch.where(blk.inside, r, 0.0)
                res[q - blk.z0] = r[h:h + t + 1, h:h + t + 1]
        blk.store(u_out, uw)
        for axis in range(3):
            res = axis_restrict_3tap(res, axis, R_TAPS[axis])
        c0, ci, cj = blk.z0 // 2, (blk.y0 + h) // 2, (blk.x0 + h) // 2
        ce = min(c0 + res.shape[0], rc.shape[0])
        ie, je = min(ci + ct, rc.shape[1]), min(cj + ct, rc.shape[2])
        rc[c0:ce, ci:ie, cj:je] = res[:ce - c0, :ie - ci, :je - cj]
    return u_out, rc


def _prolong_window(e, firsts, sizes):
    """P(e) on the fine window starting at fine indices ``firsts`` with
    ``sizes``, from e's coarse window starting at floor(first / 2) - 1 on
    every axis (coarse index c feeds fine 2c + 1): axis 0 first, then axis
    1, then axis 2."""
    coarse = [f // 2 - 1 for f in firsts]
    lengths = [w // 2 + 2 for w in sizes]
    corr = _window(e, coarse, lengths)
    for axis, (f, c, m, w) in enumerate(zip(firsts, coarse, lengths,
                                            sizes)):
        corr = axis_prolong_3tap(corr, axis, P_TAPS[axis], 2 * m + 1)
        corr = corr.narrow(axis, f - 2 * c, w)
    return corr


def emulate_up(u, e, b, halo, warm, lag, leg="up"):
    """The up-leg kernel's schedule: the corrected, smoothed u; with
    ``leg`` "sweep" and no e, the red-black sweep's: the smoothed u."""
    u_out = torch.zeros_like(u)
    for blk in _blocks(u.shape, leg, halo, warm):
        uw, bw = blk.load(u), blk.load(b)
        if e is not None:
            planes = blk.pb - blk.pa + 1
            corr = _prolong_window(e, (blk.pa, blk.y0, blk.x0),
                                   (planes, blk.w, blk.w))
            corr = torch.where(blk.inside, OMEGAS[0] * corr, 0.0)
            uw[1:planes + 1] = uw[1:planes + 1] + corr
        for s in range(blk.L0, blk.z1 + lag + 1):
            state = uw.clone()
            for k in (1, 2):
                blk.sweep(state, uw, bw, s - 1 - lag * (k - 1), k,
                          OMEGAS[1])
        blk.store(u_out, uw)
    return u_out


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    u, b = (torch.tensor(rng.standard_normal(shape)) for _ in range(2))
    e = torch.tensor(rng.standard_normal(tuple((n - 1) // 2 for n in shape)))
    return u, b, e


def _omegas():
    return torch.tensor(OMEGAS, dtype=torch.float64)


def _down(shape, halo, warm, lag):
    u, b, _ = _inputs(shape, 3)
    want = tw.downleg_wavefront_3d_plain(u, b, _omegas(), [1, 2], STENCIL,
                                         R_TAPS)
    got = emulate_down(u, b, halo, warm, lag)
    return max(float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


def _up(shape, halo, warm, lag):
    u, b, e = _inputs(shape, 4)
    want = tw.upleg_wavefront_3d_plain(u, e, b, _omegas(), [0, 1], STENCIL,
                                       P_TAPS)
    got = emulate_up(u, e, b, halo, warm, lag)
    return float((got - want).abs().max() / want.abs().max())


def _sweep(shape, halo, warm, lag):
    u, b, _ = _inputs(shape, 5)
    want = r3.fused_rbgs_sweep_3d_plain(u, b, _omegas(), 1, STENCIL)
    got = emulate_up(u, None, b, halo, warm, lag, "sweep")
    return float((got - want).abs().max() / want.abs().max())


def _restrict(shape, halo, warm, lag):
    u, b, _ = _inputs(shape, 6)
    want = l3.residual_restrict_3d_plain(u, b, STENCIL, R_TAPS)
    _, got = emulate_down(u, b, halo, warm, lag, "restrict", sweeps=0)
    return float((got - want).abs().max() / want.abs().max())


def emulate_prolong(u, e, omega, taps, window_short=0, planes_short=0):
    """The prolongation-correction kernel's schedule: u + omega * P(e);
    ``window_short`` coarse window cells and ``planes_short`` of the
    chunk's coarse planes fewer than the kernel stages."""
    n0, n1, n2 = u.shape
    tile, cw = l3.PC_TILE, l3.PC_TILE // 2 + 1
    chunk = l3.pc_chunk_planes(n0, n1, n2, SMS)
    out = torch.zeros_like(u)
    t0, t1, t2 = (torch.tensor(t, dtype=u.dtype) for t in taps)
    # a tile row or column's coarse window index and its weights on it and
    # on the next: fine 2i + 1 + o reads index i + 1 (o = 0) or i, i + 1
    idx = torch.arange(tile)
    a = (idx + 1) // 2
    odd = idx % 2 == 1
    wy = (torch.where(odd, t1[1], t1[2]), torch.where(odd, 0.0, t1[0]))
    wx = (torch.where(odd, t2[1], t2[2]), torch.where(odd, 0.0, t2[0]))
    for z0 in range(0, n0, chunk):
        z1 = min(z0 + chunk, n0)
        # the chunk's coarse planes z0/2 - 1 .. (z1 - 1)/2; past them zero
        c0 = z0 // 2 - 1
        planes = (z1 - 1) // 2 - c0 + 1
        for y0 in range(0, n1, tile):
            for x0 in range(0, n2, tile):
                ew = _window(e, (c0, y0 // 2 - 1, x0 // 2 - 1),
                             (planes + 1, cw + 1, cw + 1))
                ew[planes - planes_short:] = 0.0
                ew[:, cw - window_short:] = 0.0
                ew[:, :, cw - window_short:] = 0.0

                def inner(f):
                    c = (f - 1) // 2 - c0
                    if f % 2:
                        return t0[1] * ew[c]
                    return t0[2] * ew[c] + t0[0] * ew[c + 1]

                ye, xe = min(tile, n1 - y0), min(tile, n2 - x0)
                buf = {z0 % 2: inner(z0)}
                for s in range(z0, z1):
                    pi = buf[s % 2]
                    mid = wy[0][:, None] * pi[a] + wy[1][:, None] * pi[a + 1]
                    corr = wx[0] * mid[:, a] + wx[1] * mid[:, a + 1]
                    out[s, y0:y0 + ye, x0:x0 + xe] = \
                        u[s, y0:y0 + ye, x0:x0 + xe] + omega * corr[:ye, :xe]
                    if s + 1 < z1:
                        buf[(s + 1) % 2] = inner(s + 1)
    return out


def _prolong(shape, window_short=0, planes_short=0):
    u, _, e = _inputs(shape, 8)
    want = l3.prolong_correct_3d_plain(u, e, _omegas(), 0, P_TAPS)
    got = emulate_prolong(u, e, OMEGAS[0], P_TAPS, window_short,
                          planes_short)
    return float((got - want).abs().max() / want.abs().max())


RUN = {"down": _down, "up": _up, "sweep": _sweep, "restrict": _restrict}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the windows are small, and the test run's
    parallel workers would otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("leg", ["down", "up"])
def test_leg_schedule_matches_plain(leg, shape):
    assert RUN[leg](shape, tw.HALO[leg], tw.WARMUP[leg], tw.LAG) <= RTOL


@pytest.mark.parametrize("shape", STANDALONE_SHAPES["sweep"])
def test_sweep_schedule_matches_plain(shape):
    """The red-black sweep: the up-leg's pipeline with no correction."""
    assert _sweep(shape, HALO["sweep"], WARMUP["sweep"], tw.LAG) <= RTOL


@pytest.mark.parametrize("shape", STANDALONE_SHAPES["restrict"])
def test_restrict_schedule_matches_plain(shape):
    """The residual restriction: the down-leg's pipeline with no sweep."""
    assert _restrict(shape, HALO["restrict"], WARMUP["restrict"],
                     tw.LAG) <= RTOL


#: the prolongation-correction's shapes: the levels it runs on below
#: 255^3, with the card's chunks, and two ragged ones
PROLONG_SHAPES = ((63, 63, 63), (127, 127, 127), (65, 127, 255),
                  (19, 17, 127))


@pytest.mark.parametrize("shape", PROLONG_SHAPES)
def test_prolong_schedule_matches_plain(shape):
    """The prolongation-correction: the up-leg's prolongation with no
    sweep, its window the tile."""
    assert _prolong(shape) <= RTOL


@pytest.mark.parametrize("leg", ["down", "up", "sweep", "restrict"])
def test_needed_halo_matches_plain(leg):
    """The halo the schedule needs is enough (the up-leg's and the
    sweep's windows have one cell more after the tile, for odd rows)."""
    shape = SHAPES[1] if leg in tw.HALO else STANDALONE_SHAPES[leg][1]
    assert RUN[leg](shape, HALO_NEEDED[leg], WARMUP[leg], tw.LAG) <= RTOL
    assert all(h >= n for h, n in zip(HALO[leg], HALO_NEEDED[leg]))


def _short(leg, what):
    """The schedule with one of its constants one below what it needs."""
    halo, warm, lag = HALO_NEEDED[leg], WARMUP[leg], tw.LAG
    if what == "halo before":
        halo = (halo[0] - 1, halo[1])
    elif what == "halo after":
        halo = (halo[0], halo[1] - 1)
    elif what == "warm-up":
        warm -= 1
    else:
        lag -= 1
    return halo, warm, lag


@pytest.mark.parametrize("what", ["halo before", "halo after", "warm-up",
                                  "lag"])
@pytest.mark.parametrize("leg", ["down", "up"])
def test_schedule_one_short_differs(leg, what):
    """A halo, a warm-up or a lag one below the schedule's leaves wrong
    values in the stitched result: the emulation shows each is needed."""
    assert RUN[leg](SHAPES[0], *_short(leg, what)) > 1e-6


@pytest.mark.parametrize("leg, what", [
    ("sweep", "halo before"), ("sweep", "halo after"), ("sweep", "warm-up"),
    ("sweep", "lag"), ("restrict", "halo before"),
    ("restrict", "halo after"), ("restrict", "warm-up"),
    ("prolong", "coarse window"), ("prolong", "coarse planes")])
def test_standalone_one_short_differs(leg, what):
    """As test_schedule_one_short_differs for the standalone kernels (the
    restriction has no sweep, so no lag; the prolongation has no halo, and
    its coarse window or the chunk's coarse planes come one short)."""
    if leg == "prolong":
        short = {"window_short": 1} if what == "coarse window" else \
            {"planes_short": 1}
        assert _prolong(PROLONG_SHAPES[2], **short) > 1e-6
    else:
        assert RUN[leg](STANDALONE_SHAPES[leg][0], *_short(leg, what)) > 1e-6


def test_standalone_chunk_rule_at_the_path_levels():
    """The standalone kernels' chunks on a 132-SM card at the levels they
    run on: one wave of two blocks an SM at 255^3 and 127^3 (the
    prolongation's PC_WAVE), the fewest planes a chunk may hold
    (RB_MIN_CHUNK, RR_MIN_CHUNK, PC_MIN_CHUNK) at 63^3."""
    legs = ("sweep", "restrict", "prolong")
    chunks = {(n, leg): _chunk(leg, n, n, n)
              for n in (255, 127, 63) for leg in legs}
    assert chunks == {(n, leg): c for n, c in ((255, 64), (127, 8), (63, 2))
                      for leg in legs}
    per_sm = {"sweep": r3.RB_BLOCKS_PER_SM, "restrict": l3.RR_BLOCKS_PER_SM,
              "prolong": l3.PC_WAVE}
    least = {"sweep": r3.RB_MIN_CHUNK, "restrict": l3.RR_MIN_CHUNK,
             "prolong": l3.PC_MIN_CHUNK}
    for (n, leg), chunk in chunks.items():
        assert chunk % 2 == 0 and chunk >= least[leg]
        tiles = -(-n // TILE[leg]) ** 2
        assert tiles * -(-n // chunk) <= SMS * per_sm[leg]


def test_chunk_rule_at_the_path_levels():
    """The chunking rule on a 132-SM card at the 3D path's levels: one
    wave of blocks at 255^3, MIN_CHUNK planes below."""
    chunks = {(n, leg): tw.chunk_planes(n, n, n, leg, SMS)
              for n in (255, 127, 63) for leg in ("down", "up")}
    assert chunks == {(255, "down"): 128, (255, "up"): 128,
                      (127, "down"): 16, (127, "up"): 16,
                      (63, "down"): 8, (63, "up"): 8}
    for (n, leg), chunk in chunks.items():
        assert chunk % 2 == 0 and chunk >= tw.MIN_CHUNK
        tiles = -(-n // tw.TILE) ** 2
        assert tiles * -(-n // chunk) <= SMS * tw.BLOCKS_PER_SM[leg]


class _FakeLibrary:
    """Stands in for the built library's info entry: fills the values in
    and returns ``err``."""

    def __init__(self, err, values):
        self.err, self.values, self.calls = err, values, []

    def es_wavefront_3d_info(self, down, info):
        self.calls.append(down)
        for k, v in enumerate(self.values):
            info[k] = v
        return self.err

    def es_sweep3d_info(self, info):
        return self.es_wavefront_3d_info("sweep", info)

    def es_residual_restrict_3d_info(self, info):
        return self.es_wavefront_3d_info("restrict", info)

    def es_prolong_correct_3d_info(self, info):
        return self.es_wavefront_3d_info("prolong", info)


@pytest.mark.parametrize("err", [0, 1])
def test_leg_info_reads_the_entry(monkeypatch, err):
    """leg_info asks the entry for the named leg and names its 11 values,
    raising when the entry fails; the library is a stand-in, since the
    query needs the card."""
    from evostencils_tpu_torch.ops.kernels import _build
    lib = _FakeLibrary(err, range(11))
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    for leg, down in (("down", 1), ("up", 0)):
        if err:
            with pytest.raises(RuntimeError, match="CUDA error 1"):
                tw.leg_info(leg)
        else:
            info = tw.leg_info(leg)
            assert list(info) == ["tile", "halo_before", "halo_after",
                                  "warmup", "lag", "min_chunk", "threads",
                                  "blocks_per_sm", "registers",
                                  "local_bytes", "smem_bytes"]
            assert list(info.values()) == list(range(11))
        assert lib.calls[-1] == down
    with pytest.raises(ValueError):
        tw.leg_info("sideways")


@pytest.mark.parametrize("err", [0, 1])
@pytest.mark.parametrize("kernel", ["sweep", "restrict", "prolong"])
def test_standalone_info_reads_the_entry(monkeypatch, kernel, err):
    """rbgs3d.sweep_info, leg3d.restrict_info and leg3d.prolong_info ask
    their entries and name the 11 values as leg_info does, raising when the
    entry fails; the library is a stand-in."""
    from evostencils_tpu_torch.ops.kernels import _build
    lib = _FakeLibrary(err, range(20, 31))
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    read = {"sweep": r3.sweep_info, "restrict": l3.restrict_info,
            "prolong": l3.prolong_info}[kernel]
    if err:
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            read()
    else:
        info = read()
        assert tuple(info) == tw.INFO_KEYS
        assert list(info.values()) == list(range(20, 31))
    assert lib.calls == [kernel]
