"""Restarted GMRES on device, free of ``lax.custom_linear_solve``.

``jax.scipy.sparse.linalg.gmres`` wraps the operator in
``lax.custom_linear_solve``, which must *linearize/transpose* the matvec —
that rejects mathematically-linear operators built from non-linear
primitives (the sliced Ozaki contraction path: mantissa truncation,
exponent bitcasts).  This implementation only ever CALLS the matvec, so
any linear operator works.

Structure: left-preconditioned GMRES(m) with CGS2 Arnoldi and Givens
rotations, everything fixed-shape inside one ``lax.while_loop`` over
restarts (no dynamic shapes, no host sync).

The matvec is traced at exactly ONE site (the Arnoldi body).  The
restart residual is reconstructed from the Arnoldi relation instead of
recomputed — r_new = V^T·(Qᵀ e_fin·g_fin), the standard identity — and
the caller owns any honest final-residual check.  This matters beyond
matvec count: the FEAST/RT shifted solves inline a ~10⁴-op sigma at
every matvec site of the vmapped solve program, so each extra site
grows the program and its compile time.

Replaces the role of scipy's gcrotmk in the reference's shifted solves
(``pymes/solver/feast_eom_ccsd.py:293``).
"""

from functools import partial

import jax
import jax.numpy as jnp


def _dot(x, y):
    return jnp.sum(x * y)


@partial(jax.jit, static_argnames=("matvec", "precond", "restart",
                                   "max_outer"))
def gmres(matvec, b, precond=None, tol=1e-5, restart=20, max_outer=20):
    """Solve A x = b; returns ``(x, rel_res)`` with rel_res the
    PRECONDITIONED residual norm from the Arnoldi relation (same
    convergence test as jax.scipy; exact in exact arithmetic, drifts
    only by rounding across restarts — callers needing a certified
    residual recompute ‖Ax − b‖ themselves, one matvec).

    ``matvec``/``precond``: flat-vector → flat-vector callables (linear;
    need not be built from linear primitives).
    """
    if precond is None:
        def precond(v):
            return v

    n = b.shape[0]
    dtype = b.dtype
    # f32 Krylov mode (the FEAST/RT mixed-precision inner solves): the
    # breakdown/underflow guards must sit above the f32 denormal range
    f32 = jnp.finfo(dtype).bits == 32
    tiny = jnp.asarray(1e-30 if f32 else 1e-300, dtype)
    Mb = precond(b)
    bnorm = jnp.sqrt(_dot(Mb, Mb))
    safe_b = jnp.maximum(bnorm, tiny)

    # breakdown guard: a NEAR-zero (not exactly zero) Krylov vector must
    # not be normalized — dividing by a floored denominator amplifies it
    # by up to 1e150 and the next dot overflows to inf - inf = NaN.
    # Below this norm the direction is noise; replace it with the zero
    # vector (its H column and rotation become inert).
    _BREAK = jnp.asarray(1e-18 if f32 else 1e-140, dtype)

    def _safe_unit(v, norm):
        return jnp.where(norm > _BREAK, 1.0 / jnp.maximum(norm, _BREAK),
                         0.0) * v

    def inner(x0, r0):
        """One GMRES(m) cycle from x0 with preconditioned residual r0;
        returns (x, r_new, prec_res_norm)."""
        beta = jnp.sqrt(_dot(r0, r0))
        V0 = jnp.zeros((restart + 1, n), dtype).at[0].set(
            _safe_unit(r0, beta))

        H0 = jnp.zeros((restart + 1, restart), dtype)
        cs0 = jnp.zeros((restart,), dtype)
        sn0 = jnp.zeros((restart,), dtype)
        g0 = jnp.zeros((restart + 1,), dtype).at[0].set(beta)

        def body(carry):
            j, V, H, cs, sn, g = carry
            w = precond(matvec(V[j]))
            # classical Gram-Schmidt with one reorthogonalisation pass
            # (CGS2) against all rows — rows > j are zero, so their
            # coefficients vanish and no mask is needed.  Two fused
            # broadcast-reduce GEMVs per pass replace a fori_loop MGS's
            # 2·(restart+1) serialized vdot+axpy kernels.  Single-pass
            # CGS can lose enough orthogonality to stall restarts at
            # ~1e-7; the second pass restores MGS-class stability.
            # Elementwise mul+sum runs at the same speed as `V @ w` on an
            # H100 (within 6% either way) and never drops f32 to TF32.
            h = jnp.zeros((restart + 1,), dtype)
            for _ in range(2):
                hp = jnp.sum(V * w[None, :], axis=1)
                w = w - jnp.sum(V * hp[:, None], axis=0)
                h = h + hp
            hnext = jnp.sqrt(_dot(w, w))
            h = h.at[j + 1].set(hnext)
            V = V.at[j + 1].set(_safe_unit(w, hnext))

            # apply existing Givens rotations to the new column
            def rot(i, hcol):
                hi, hi1 = hcol[i], hcol[i + 1]
                use = i < j
                new_i = jnp.where(use, cs[i] * hi + sn[i] * hi1, hi)
                new_i1 = jnp.where(use, -sn[i] * hi + cs[i] * hi1, hi1)
                return hcol.at[i].set(new_i).at[i + 1].set(new_i1)

            h = jax.lax.fori_loop(0, restart, rot, h)
            # new rotation annihilating h[j+1] (identity on a dead column)
            denom = jnp.sqrt(h[j] ** 2 + h[j + 1] ** 2)
            safe_d = jnp.maximum(denom, _BREAK)
            alive = denom > _BREAK
            c = jnp.where(alive, h[j] / safe_d, 1.0)
            s = jnp.where(alive, h[j + 1] / safe_d, 0.0)
            h = h.at[j].set(denom).at[j + 1].set(0.0)
            cs = cs.at[j].set(c)
            sn = sn.at[j].set(s)
            g = g.at[j + 1].set(-s * g[j])
            g = g.at[j].set(c * g[j])
            H = H.at[:, j].set(h)
            return j + 1, V, H, cs, sn, g

        def keep_going(carry):
            # |g[j]| is the preconditioned residual norm of the current
            # least-squares iterate — free early exit (a converged solve
            # otherwise burns the full restart cycle of matvecs)
            j = carry[0]
            g = carry[5]
            return (j < restart) & (jnp.abs(g[j]) > tol * safe_b)

        j_fin, V, H, cs, sn, g = jax.lax.while_loop(
            keep_going, body, (jnp.zeros((), jnp.int32), V0, H0, cs0,
                               sn0, g0))

        # back-substitution of the triangular system R y = g
        def back(k, y):
            i = restart - 1 - k
            def acc_fn(l, acc):
                return acc + jnp.where(l > i, H[i, l] * y[l], 0.0)
            acc = jax.lax.fori_loop(0, restart, acc_fn,
                                    jnp.zeros((), dtype))
            # dead column (early exit / happy breakdown): its y must be 0 —
            # g[i] there holds the residual norm, not a solvable entry
            yi = jnp.where(jnp.abs(H[i, i]) > 1e-300,
                           (g[i] - acc) / jnp.where(
                               jnp.abs(H[i, i]) > 1e-300, H[i, i], 1.0),
                           0.0)
            return y.at[i].set(yi)

        y = jax.lax.fori_loop(0, restart, back,
                              jnp.zeros((restart,), dtype))
        x = x0 + jnp.sum(y[:, None] * V[:restart], axis=0)

        # residual reconstruction (no matvec): in the Krylov basis the
        # least-squares residual is β e₁ − H̄ y = Qᵀ(0,…,0,g[j_fin]), so
        # r_new = Vᵀ·ζ with ζ = Qᵀ e_fin·g[j_fin] — apply the stored
        # rotations transposed in reverse order
        u = jnp.where(jnp.arange(restart + 1) == j_fin, g[j_fin], 0.0)

        def unrot(k, uv):
            i = restart - 1 - k
            ui, ui1 = uv[i], uv[i + 1]
            use = i < j_fin
            new_i = jnp.where(use, cs[i] * ui - sn[i] * ui1, ui)
            new_i1 = jnp.where(use, sn[i] * ui + cs[i] * ui1, ui1)
            return uv.at[i].set(new_i).at[i + 1].set(new_i1)

        u = jax.lax.fori_loop(0, restart, unrot, u)
        r_new = jnp.sum(u[:, None] * V, axis=0)
        # on early exit the residual sits at g[j_fin], not g[restart]
        return x, r_new, jnp.abs(g[j_fin])

    def cond(carry):
        _, _, res, it = carry
        return (res / safe_b > tol) & (it < max_outer)

    def outer(carry):
        x, r, _, it = carry
        x, r, res = inner(x, r)
        return x, r, res, it + 1

    x0 = jnp.zeros_like(b)
    # x0 = 0 ⇒ the preconditioned residual is exactly Mb — no matvec
    x, _, res, _ = jax.lax.while_loop(
        cond, outer, (x0, Mb, bnorm, jnp.zeros((), jnp.int32)))
    return x, res / safe_b


@partial(jax.jit, static_argnames=("matvec", "precond", "max_iter"))
def richardson(matvec, b, precond=None, tol=1e-5, damping=1.0,
               max_iter=400):
    """Damped preconditioned Richardson iteration x ← x + ω·M(b − Ax).

    With M = 1/(z − diag) and ω = 1 this is the classical Jacobi
    iteration — the device equivalent of the reference's ``_jacobi``
    shifted-solve backend (``pymes/solver/feast_eom_ccsd.py:253-293``,
    which fixes 200 passes at ω = 0.01 with the same preconditioner;
    lower ω to that regime for near-metallic windows where the
    off-diagonal coupling rivals the shift).  Here the loop is a
    fixed-shape ``lax.while_loop`` with an early exit on the true
    residual, so a well-conditioned window costs only as many sigma
    matvecs as it needs.  Like :func:`gmres` it only ever CALLS the
    matvec — the sliced (ozaki) sigma runs inside.  Convergence
    requires the window shift to dominate the off-diagonal coupling
    (|1 − ωMA| < 1); GMRES is the production default, this exists for
    capability parity and as a low-memory fallback (no (restart+1, n)
    Krylov basis).

    The iteration matrix 1 - wM(z-H) has |.| > 1 eigen-directions on
    the ill-conditioned contour nodes of a realistic FEAST window for
    ANY w (the reference's fixed-200-pass ``_jacobi`` diverges there the
    same way, it just never checks).  So this carries the BEST iterate
    seen (minimum true residual) and bails once the residual blows 1e3x
    past the RHS norm -- a diverged node returns its best early iterate
    with an honest residual instead of 1e35-scaled garbage, and the
    caller's non-convergence warning fires on it.
    """
    if precond is None:
        def precond(v):
            return v

    dtype = b.dtype
    bnorm = jnp.sqrt(_dot(b, b))
    safe_b = jnp.maximum(bnorm, jnp.asarray(1e-300, dtype))
    om = jnp.asarray(damping, dtype)

    def cond(carry):
        _, res, it, _, _ = carry
        return ((res / safe_b > tol) & (it < max_iter)
                & (res < 1e3 * safe_b))

    def body(carry):
        x, _, it, best_x, best_res = carry
        r = b - matvec(x)
        res = jnp.sqrt(_dot(r, r))
        better = res < best_res
        best_x = jnp.where(better, x, best_x)
        best_res = jnp.where(better, res, best_res)
        return x + om * precond(r), res, it + 1, best_x, best_res

    x0 = jnp.zeros_like(b)
    # entry residual at x0 = 0 is exactly ||b|| (no matvec needed) — it
    # must be finite or the divergence guard in `cond` would never let
    # the loop start
    _, _, _, best_x, best_res = jax.lax.while_loop(
        cond, body, (x0, bnorm, jnp.zeros((), jnp.int32), x0, bnorm))
    return best_x, best_res / safe_b
