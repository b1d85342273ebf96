"""Copy of evostencils_tpu/grammar/seeds.py, kept in the port so that it imports
nothing of the JAX package.

Known-good grammar individuals for seeding evolution runs.

The reference's campaigns start near working configurations (its tutorial
evolves from small populations around the generated default solver;
notebooks/helmholtz.ipynb's journey hand-holds the complex
preconditioner).  On hard problems — the indefinite Helmholtz above all —
a random μ=8 population contains no individual that converges at all, so
selection has almost no gradient; seeding the initial population with the
reference-config V-cycle restores the reference's own starting point.

``v_cycle_string`` emits the grammar string of a standard V(pre, post)
cycle over the full hierarchy: per-level pre-smoothing, guarded descent,
coarse-grid solve discharging the guard (grammar/multigrid.py note), and
post-smoothing on the unguarded return chain.  The string parses against
``generate_primitive_set`` of the same problem (name conventions:
smoothers/residual/cgc/coarsening carry the grammar depth; R/P terminals
carry ABSOLUTE levels; A/zero terminals carry depth indices)."""

from __future__ import annotations


def _rf_index(omega: float, samples: int = 37) -> int:
    """Index of the nearest relaxation-factor sample (linspace 0.1..1.9,
    reference grammar/multigrid.py:428)."""
    step = (1.9 - 0.1) / (samples - 1)
    i = round((omega - 0.1) / step)
    return max(0, min(samples - 1, int(i)))


def v_cycle_string(depth: int, max_level: int, *,
                   smoother: str = "collective_jacobi",
                   omega: float = 1.15, cgc_omega: float = 1.0,
                   partitioning: str = "red_black",
                   pre: int = 2, post: int = 1,
                   samples: int = 37) -> str:
    """Grammar string of the V(pre, post) cycle with ``smoother`` at
    relaxation factor ``omega`` on every level — e.g. the reference
    Poisson solver block (RB-GS 1.15, 2/1) or the Helmholtz
    shifted-Laplace preconditioner (collective RB 0.6)."""
    rf = f"rf_{_rf_index(omega, samples)}"
    rf_c = f"rf_{_rf_index(cgc_omega, samples)}"

    def sm(k: int, state: str, guarded: bool, with_residual: bool) -> str:
        g = f"__C_guard_{k}" if guarded else ""
        if with_residual:
            rg = f"__S_guard_{k}" if guarded else ""
            state = f"residual_{k}{rg}({state})"
        return f"{smoother}_{k}{g}({rf},{partitioning},{state})"

    def level(k: int, state: str, first_eats_c: bool) -> str:
        # pre-smoothing: on coarse levels the first smoother consumes the
        # restricted-residual C state directly
        for s in range(pre):
            state = sm(k, state, guarded=True,
                       with_residual=not (first_eats_c and s == 0))
        if k == depth - 1:
            state = (f"cgs_{k}__C_guard_{k}({rf_c},P_{max_level - k},"
                     f"CGS_{depth},R_{max_level - k},"
                     f"residual_{k}__S_guard_{k}({state}))")
        else:
            rc = (f"coarsening_{k}__C_guard_{k}(A_{k + 1},zero_{k + 1},"
                  f"R_{max_level - k},residual_{k}__S_guard_{k}({state}))")
            cs = level(k + 1, rc, first_eats_c=True)
            state = f"cgc_{k}({rf_c},P_{max_level - k},{cs})"
        for _ in range(post):
            state = sm(k, state, guarded=False, with_residual=True)
        return state

    return level(0, "u_and_f", first_eats_c=False)


def fas_v_cycle_string(depth: int, max_level: int, *,
                       smoother: str = "jacobi_newton",
                       newton_steps: int = 1,
                       omega: float = 0.8, cgc_omega: float = 1.0,
                       pre: int = 2, post: int = 2,
                       samples: int = 37) -> str:
    """Grammar string of the hand-tuned FAS V(pre, post) cycle — e.g. the
    reference nonlinear solver block (damped Newton-Jacobi 0.8, V(2,2);
    reference FAS_2D_Basic_template.exa4:26-34).  The FAS grammar differs
    from the linear one (generate_primitive_set(FAS=True)): smoothers are
    ``jacobi_newton_k(rf, single, newton_N, state)`` /
    ``jacobi_picard_k(rf, single, state)``, partitioning is ``single``
    only, and the coarse-grid correction carries the solution-transfer
    restriction (``cgc_k(rf, P, coarse_state, R)``)."""
    rf = f"rf_{_rf_index(omega, samples)}"
    rf_c = f"rf_{_rf_index(cgc_omega, samples)}"
    extra = f"newton_{newton_steps}," if smoother == "jacobi_newton" else ""

    def sm(k: int, state: str, guarded: bool, with_residual: bool) -> str:
        g = f"__C_guard_{k}" if guarded else ""
        if with_residual:
            rg = f"__S_guard_{k}" if guarded else ""
            state = f"residual_{k}{rg}({state})"
        return f"{smoother}_{k}{g}({rf},single,{extra}{state})"

    def level(k: int, state: str, first_eats_c: bool) -> str:
        for s in range(pre):
            state = sm(k, state, guarded=True,
                       with_residual=not (first_eats_c and s == 0))
        if k == depth - 1:
            state = (f"cgs_{k}__C_guard_{k}({rf_c},P_{max_level - k},"
                     f"CGS_{depth},R_{max_level - k},"
                     f"residual_{k}__S_guard_{k}({state}))")
        else:
            rc = (f"coarsening_{k}__C_guard_{k}(A_{k + 1},zero_{k + 1},"
                  f"R_{max_level - k},residual_{k}__S_guard_{k}({state}))")
            cs = level(k + 1, rc, first_eats_c=True)
            state = (f"cgc_{k}({rf_c},P_{max_level - k},{cs},"
                     f"R_{max_level - k})")
        for _ in range(post):
            state = sm(k, state, guarded=False, with_residual=True)
        return state

    return level(0, "u_and_f", first_eats_c=False)
