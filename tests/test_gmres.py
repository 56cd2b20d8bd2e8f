"""Device GMRES (no custom_linear_solve): accuracy vs dense solve, and
operation inside matvecs built from non-linear primitives (the sliced
Ozaki path), which jax.scipy's gmres rejects."""

import jax
import jax.numpy as jnp
import numpy as np

from pymes_jax.ops.gmres import gmres, richardson


def _system(n, seed=0):
    rng = np.random.default_rng(seed)
    A = np.eye(n) * 4.0 + rng.standard_normal((n, n)) * 0.3
    b = rng.standard_normal(n)
    return A, b


def test_gmres_matches_dense_solve():
    A, b = _system(60)
    x_ref = np.linalg.solve(A, b)
    Aj = jnp.asarray(A)
    x, rel = gmres(lambda v: Aj @ v, jnp.asarray(b), tol=1e-12,
                   restart=20, max_outer=50)
    assert float(rel) < 1e-10
    np.testing.assert_allclose(np.asarray(x), x_ref, atol=1e-8)


def test_gmres_preconditioned():
    A, b = _system(80, seed=1)
    d = jnp.asarray(1.0 / np.diag(A))
    Aj = jnp.asarray(A)
    x, rel = gmres(lambda v: Aj @ v, jnp.asarray(b),
                   precond=lambda v: d * v, tol=1e-12, restart=15,
                   max_outer=60)
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, b),
                               atol=1e-8)


def test_gmres_multi_restart_residual_reconstruction():
    """The restart residual is reconstructed from the Arnoldi relation
    (r = Vᵀ·Qᵀe·g_fin) instead of an extra matvec — a solve needing MANY
    restart cycles must still reach the dense solution, i.e. the
    reconstructed vector stays in sync with the true residual."""
    A, b = _system(120, seed=7)
    Aj = jnp.asarray(A)
    x, rel = gmres(lambda v: Aj @ v, jnp.asarray(b), tol=1e-12,
                   restart=8, max_outer=60)
    x = np.asarray(x)
    true_rel = (np.linalg.norm(A @ x - b) / np.linalg.norm(b))
    assert true_rel < 1e-11
    # the reported (reconstructed) residual agrees with the true one
    assert abs(float(rel) - true_rel) < 1e-9
    np.testing.assert_allclose(x, np.linalg.solve(A, b), atol=1e-8)


def test_richardson_jacobi_solve():
    """ω=1 preconditioned Richardson == classical Jacobi: converges on a
    diagonally-dominant system to the dense solution (the reference's
    _jacobi backend, pymes/solver/feast_eom_ccsd.py:253)."""
    A, b = _system(70, seed=3)
    d = jnp.asarray(1.0 / np.diag(A))
    Aj = jnp.asarray(A)
    x, rel = richardson(lambda v: Aj @ v, jnp.asarray(b),
                        precond=lambda v: d * v, tol=1e-12,
                        max_iter=500)
    assert float(rel) < 1e-11
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, b),
                               atol=1e-9)


def test_richardson_early_exit_budget():
    """The while_loop exits on tol — an easy system must not burn the
    full max_iter matvec budget (counted through a tracing-safe
    side-channel is impossible; instead check a LOW budget still
    converges, i.e. iterations-to-tol is small)."""
    A, b = _system(40, seed=4)
    d = jnp.asarray(1.0 / np.diag(A))
    Aj = jnp.asarray(A)
    x, rel = richardson(lambda v: Aj @ v, jnp.asarray(b),
                        precond=lambda v: d * v, tol=1e-10, max_iter=80)
    assert float(rel) < 1e-10


def test_gmres_with_ozaki_matvec():
    """The matvec runs through ozaki.matmul (trunc/bitcast primitives) —
    jax.scipy.sparse.linalg.gmres raises inside custom_linear_solve on
    this operator; ours just calls it."""
    from pymes_jax.ops import ozaki
    A, b = _system(64, seed=2)
    Aj = jnp.asarray(A)

    def mv(v):
        return ozaki.matmul(Aj, v[:, None], n_slices=9, t_cutoff=9)[:, 0]

    x, rel = gmres(mv, jnp.asarray(b), tol=1e-11, restart=20,
                   max_outer=50)
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, b),
                               atol=1e-7)
