"""FEAST-EOM-CCSD: contour-integral energy-filtered excited states.

Capability parity with the reference (``pymes/solver/feast_eom_ccsd.py:17``):
the spectral projector onto an energy window [e_c − e_r, e_c + e_r] is built
by Gauss-Legendre quadrature of the resolvent over a half-circle contour,
``Q = −Σ_e w_e/2 · Re[e_r e^{iθ_e} (z_e − H̄)⁻¹ U]``, each node requiring a
complex shifted linear solve with the matrix-free sigma build; the tiny
oblique projected eigenproblem ``H_proj v = λ B v`` is solved on host.

Device structure: the shifted solves are preconditioned GMRES
(``jax.scipy.sparse.linalg.gmres``) on the packed complex vector with the
sigma build inside the matvec — one jitted solve, vmappable over quadrature
nodes (the reference fanned these out with joblib processes; here the
per-node solves batch on device).  The same machinery serves the real-time
propagator (:mod:`pymes_jax.solver.rt_eom_ccsd`) through the ``is_rt`` /
``phase`` variant of the matvec (z·x − i·dt·H̄·x).
"""

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from scipy.linalg import eig

from pymes_jax.log import print_logging_info, print_title
from pymes_jax.solver.eom_ccsd import (EOM_CCSD, build_hbar,
                                       get_diag_doubles, get_diag_singles,
                                       preslice_sigma_hbar,
                                       sigma_doubles, sigma_doubles_hbar,
                                       sigma_singles, sigma_singles_hbar)


def get_gauss_legendre_quadrature(n):
    return np.polynomial.legendre.leggauss(n)


def normalize_amps(u_singles, u_doubles):
    norm = np.tensordot(np.conj(u_singles), u_singles, axes=2)
    norm += np.tensordot(np.conj(u_doubles), u_doubles, axes=4)
    scale = np.sqrt(norm)
    return u_singles / scale, u_doubles / scale


def _node_ops(f, dict_t_V, T2, z_pair, diag_vec, no, nv, is_rt=False,
              dt=0.0, hbar=None, contract_mode="xla", sigma_sliced=None):
    """(matvec, precond) for one contour node's shifted operator — shared
    by the solve program and the detached residual-check program."""
    n1 = nv * no
    zr, zi = z_pair

    def H(x):
        u1 = x[:n1].reshape(nv, no)
        u2 = x[n1:].reshape(nv, nv, no, no)
        if hbar is not None:  # factorized sigma: T2 pieces precontracted
            w1 = sigma_singles_hbar(f, dict_t_V, hbar, u1, u2, T2,
                                    contract_mode=contract_mode)
            w2 = sigma_doubles_hbar(f, dict_t_V, hbar, u1, u2, T2,
                                    contract_mode=contract_mode,
                                    sliced=sigma_sliced)
        else:
            w1 = sigma_singles(f, dict_t_V, u1, u2, T2)
            w2 = sigma_doubles(f, dict_t_V, u1, u2, T2)
        return jnp.concatenate([w1.ravel(), w2.ravel()])

    def matvec(pair):
        xr, xi = pair
        # ONE vmapped sigma over the stacked (Re, Im) pair instead of two
        # separate H instantiations: the sigma body is by far the largest
        # subgraph in the solve program and compile time scales with its
        # replication count.
        # Trial-batched pairs (m, N) ride the same vmap as a 2m-row
        # data batch (the fused Davidson applies the sigma this way).
        if xr.ndim == 2:
            mb = xr.shape[0]
            hs = jax.vmap(H)(jnp.concatenate([xr, xi], axis=0))
            hr, hi = hs[:mb], hs[mb:]
        else:
            hs = jax.vmap(H)(jnp.stack([xr, xi]))
            hr, hi = hs[0], hs[1]
        if is_rt:
            # (z − i·dt·H̄)(xr + i xi)
            return (zr * xr - zi * xi + dt * hi,
                    zr * xi + zi * xr - dt * hr)
        return (zr * xr - zi * xi - hr,
                zr * xi + zi * xr - hi)

    # complex diagonal preconditioner as a real pair: 1/(z − diag + 0.01)
    # for FEAST; for RT the operator is (z − i·dt·H̄) so its diagonal is
    # z − i·dt·diag (the reference's _jacobi applies the same scaling,
    # pymes/solver/feast_eom_ccsd.py:276-280).  The mismatch only slowed
    # GMRES, but diverges the ω=1 Richardson/Jacobi backend.
    if is_rt:
        den_r = jnp.broadcast_to(zr + 0.01, diag_vec.shape)
        den_i = zi - dt * diag_vec
    else:
        den_r = zr - diag_vec + 0.01
        den_i = jnp.broadcast_to(zi, den_r.shape)
    den2 = den_r ** 2 + den_i ** 2
    m_r, m_i = den_r / den2, -den_i / den2

    def precond(pair):
        xr, xi = pair
        return (m_r * xr - m_i * xi, m_r * xi + m_i * xr)

    return matvec, precond


def _shifted_solve_impl(f, dict_t_V, T2, b_pair, z_pair, diag_vec, no, nv,
                        is_rt=False, dt=0.0, ls_max_iter=20, restart=20,
                        ls_conv_tol=1e-4, hbar=None, contract_mode="xla",
                        linear_solver="inhouse", sigma_sliced=None,
                        ls_damping=1.0):
    """Solve (z − H̄)x = b (or (z − i·dt·H̄)x = b for RT) with diagonal-
    preconditioned GMRES, everything on device.

    Complex arithmetic is expressed through its **real embedding** — the
    unknown is the (Re x, Im x) pair and the real H̄ applies to each part,
    so every GEMM stays real f64 (a native complex128 path is an open
    design item).  GMRES runs on the pytree pair with the real inner
    product; the caller recombines to complex on host.

    ``linear_solver``:

    * ``"inhouse"`` (default): :func:`pymes_jax.ops.gmres.gmres` — only
      ever CALLS the matvec, so the sliced (ozaki) sigma backend and
      plan-attached ladder slices run INSIDE the solve (VERDICT r2
      task 1).
    * ``"jacobi"``: :func:`pymes_jax.ops.gmres.richardson` — the damped
      preconditioned Richardson iteration matching the reference's
      ``_jacobi`` backend (``pymes/solver/feast_eom_ccsd.py:253``);
      matvec-only like ``"inhouse"``, no Krylov basis in memory.
    * ``"opt"``: alias for the in-house GMRES, kept for capability parity
      with the reference's ``_opt_solver``
      (``pymes/solver/feast_eom_ccsd.py:221-249``), which runs
      ``scipy.optimize.minimize(method="CG")`` on ‖(z−H)x − b‖ with
      finite-difference gradients.  GMRES minimizes exactly that
      objective over the Krylov subspace, matvec-only and without the
      thousands of finite-difference sigma evaluations, so it is the
      honest device-native form of the same solver.  (The reference's
      third alternative, ``_bicgstab:353``, crashes on a shape mismatch
      in its own test and is not reproduced.)
    * ``"jsp"``: ``jax.scipy.sparse.linalg.gmres``, whose
      ``lax.custom_linear_solve`` must linearize/transpose the matvec;
      non-linear primitives (mantissa truncation, exponent bitcasts) are
      rejected, so the ozaki machinery is stripped and the sigma runs in
      plain f64.  Kept as the fallback.

    Returns ``(x_pair, rel_res)`` — the relative residual ‖(z−H)x − b‖/‖b‖
    is measured explicitly (one extra matvec) because a silently
    non-converged node corrupts the spectral projector (VERDICT r1 weak 6).
    """
    if linear_solver not in ("inhouse", "jacobi", "opt"):
        from pymes_jax.ops.ueg_ladder import BlockLadder
        lad = dict_t_V.get("abcd_ladder")
        if isinstance(lad, BlockLadder) and lad.presliced is not None:
            dict_t_V = dict(dict_t_V)
            dict_t_V["abcd_ladder"] = lad._replace(presliced=None)
        contract_mode = "xla"
        sigma_sliced = None

    matvec, precond = _node_ops(f, dict_t_V, T2, z_pair, diag_vec, no,
                                nv, is_rt=is_rt, dt=dt, hbar=hbar,
                                contract_mode=contract_mode,
                                sigma_sliced=sigma_sliced)

    if linear_solver in ("inhouse", "jacobi", "opt"):
        # trial-batched rhs (m, N): the m systems STACK into one flat
        # real-embedded vector of length 2mN — block-diagonal operator
        # (identical per lane), so ONE Krylov polynomial serves all
        # lanes and the iteration count tracks the worst lane; per-lane
        # accuracy is enforced by the caller's detached honest-residual
        # check + refinement passes, not by this solve's norm.  Chosen
        # over per-lane-state batched GMRES (jax.vmap-of-while or a
        # hand-batched lock-step solver) because this program is
        # structurally IDENTICAL to the unbatched solver, just with
        # longer rows.  The matvec still applies the sigma to all m
        # lanes at once — the win.
        if b_pair[0].ndim == 2:
            mb, N = b_pair[0].shape

            def unflat(v):
                return (v[:mb * N].reshape(mb, N),
                        v[mb * N:].reshape(mb, N))
        else:
            N = b_pair[0].shape[0]

            def unflat(v):
                return (v[:N], v[N:])

        def matvec_flat(v):
            yr, yi = matvec(unflat(v))
            return jnp.concatenate([yr.ravel(), yi.ravel()])

        def precond_flat(v):
            yr, yi = precond(unflat(v))
            return jnp.concatenate([yr.ravel(), yi.ravel()])

        bflat = jnp.concatenate([b_pair[0].ravel(), b_pair[1].ravel()])
        if linear_solver == "jacobi":
            from pymes_jax.ops.gmres import richardson as _rich
            # ls_max_iter counts restart-sized work units for GMRES; give
            # Richardson the same matvec budget
            xflat, rel = _rich(matvec_flat, bflat, precond=precond_flat,
                               tol=ls_conv_tol, damping=ls_damping,
                               max_iter=ls_max_iter * restart)
        else:
            from pymes_jax.ops.gmres import gmres as _gmres
            xflat, rel = _gmres(matvec_flat, bflat,
                                precond=precond_flat, tol=ls_conv_tol,
                                restart=restart, max_outer=ls_max_iter)
        x = unflat(xflat)
    else:
        x, _ = jax.scipy.sparse.linalg.gmres(
            matvec, b_pair, tol=ls_conv_tol, atol=0.0, restart=restart,
            maxiter=ls_max_iter, M=precond, solve_method="batched")
        rel = jnp.zeros(())  # jsp reports nothing; the detached check rules
    # the HONEST residual ‖(z−H)x − b‖/‖b‖ is computed by the caller in a
    # detached program (`_residual_nodes`) — keeping the extra matvec out
    # of this while(while) program cuts its compile size; `rel` is the
    # solver's internal estimate only
    return x, rel


_shifted_solve = partial(jax.jit, static_argnames=(
    "no", "nv", "is_rt", "ls_max_iter", "restart",
    "contract_mode", "linear_solver"))(_shifted_solve_impl)


def _krylov_budget_bytes(explicit):
    """Bytes the trial lanes' Krylov bases may take at once: ``explicit``
    when given, else a quarter of the device's memory limit (the operator,
    the sigma intermediates and the refinement vectors share the rest),
    else unbounded on a backend that reports no limit."""
    if explicit is not None:
        return float(explicit)
    limit = (jax.devices()[0].memory_stats() or {}).get("bytes_limit")
    return limit / 4 if limit else float("inf")


# ---------------------------------------------------------------------------
# mixed-precision scan-over-nodes engine (VERDICT r3 task 1)
# ---------------------------------------------------------------------------

def _strip_ozaki(tree):
    """Drop attached ozaki machinery (presliced sector blocks) so a
    casted-f32 copy of the operator runs plain f32 GEMMs."""
    from pymes_jax.ops.ueg_ladder import BlockLadder
    if isinstance(tree, BlockLadder):
        return tree._replace(presliced=None)
    if isinstance(tree, dict):
        return {k: _strip_ozaki(v) for k, v in tree.items()}
    return tree


def _cast_f32(tree):
    """f32 copy of an operator structure (Fock/V-dict/T2/hbar/diag):
    every f64 leaf casts to f32; gather indices/plans pass through."""
    tree = _strip_ozaki(tree)
    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32)
        if (hasattr(x, "dtype") and x.dtype == jnp.float64) else x, tree)


def _nodes_scan_impl(f, dict_t_V, T2, rhs_pairs, z_pairs, diag_vec, no, nv,
                     is_rt=False, dt=0.0, ls_max_iter=20, restart=20,
                     ls_conv_tol=1e-4, hbar=None, contract_mode="xla",
                     linear_solver="inhouse", ls_damping=1.0):
    """Sequential ``lax.map`` over contour nodes with per-node rhs.

    The solve subgraph (GMRES with the ~10⁴-op sigma inside every matvec
    site) appears ONCE in the program regardless of node count, where
    the vmapped batch form replicates it per node.  A second win: each
    node runs only its
    OWN Krylov iterations — a batched while_loop runs every node to the
    slowest node's count (the near-real-axis nodes), wasting matvecs on
    the easy far-contour nodes.
    """
    def solve1(zr, zi, br, bi):
        (xr, xi), rel = _shifted_solve_impl(
            f, dict_t_V, T2, (br, bi), (zr, zi), diag_vec, no, nv,
            is_rt=is_rt, dt=dt, ls_max_iter=ls_max_iter, restart=restart,
            ls_conv_tol=ls_conv_tol, hbar=hbar,
            contract_mode=contract_mode, linear_solver=linear_solver,
            ls_damping=ls_damping)
        return xr, xi, rel

    # rhs (n_nodes, N) or trial-batched (n_nodes, m, N): either rank
    # flows through solve1 — the batched form stacks the m systems of a
    # node into one flat GMRES whose matvec applies the sigma to all m
    # lanes at once (see _shifted_solve_impl)
    def one(args):
        zr, zi, br, bi = args
        return solve1(zr, zi, br, bi)

    return jax.lax.map(one, (z_pairs[0], z_pairs[1],
                             rhs_pairs[0], rhs_pairs[1]))


_shifted_solve_nodes_scan = partial(jax.jit, static_argnames=(
    "no", "nv", "is_rt", "ls_max_iter", "restart", "contract_mode",
    "linear_solver"))(_nodes_scan_impl)


@partial(jax.jit, static_argnames=("n",))
def _broadcast_rhs(b_pair, phases, n):
    """(n, N) per-node right-hand sides from one vector and optional
    per-node complex phases (the RT rhs is ``e^{z_e}·b``)."""
    br, bi = b_pair
    if phases is None:
        return (jnp.broadcast_to(br, (n,) + br.shape),
                jnp.broadcast_to(bi, (n,) + bi.shape))
    pr, pi = phases
    pr = pr.reshape((n,) + (1,) * br.ndim)
    pi = pi.reshape((n,) + (1,) * br.ndim)
    return (pr * br[None] - pi * bi[None],
            pr * bi[None] + pi * br[None])


@jax.jit
def _accum_x(x_pairs, dx_r, dx_i):
    """f64 accumulation of a refinement update (dx arrives f32)."""
    return (x_pairs[0] + dx_r.astype(jnp.float64),
            x_pairs[1] + dx_i.astype(jnp.float64))

def _nodes_impl(f, dict_t_V, T2, b_pair, z_pairs, diag_vec, no, nv,
                is_rt=False, dt=0.0, ls_max_iter=20, restart=20,
                ls_conv_tol=1e-4, hbar=None, contract_mode="xla",
                phases=None, linear_solver="inhouse", sigma_sliced=None,
                ls_damping=1.0):
    def solve_one(rhs, z_pair):
        return _shifted_solve_impl(f, dict_t_V, T2, rhs, z_pair,
                                   diag_vec, no, nv, is_rt=is_rt, dt=dt,
                                   ls_max_iter=ls_max_iter,
                                   restart=restart,
                                   ls_conv_tol=ls_conv_tol, hbar=hbar,
                                   contract_mode=contract_mode,
                                   linear_solver=linear_solver,
                                   sigma_sliced=sigma_sliced,
                                   ls_damping=ls_damping)

    if phases is None:
        return jax.vmap(lambda zp: solve_one(b_pair, zp))(z_pairs)

    # RT: per-node complex phase on the rhs (b ← e^{z_e}·b)
    def one_ph(z_pair, ph):
        pr, pi = ph
        br, bi = b_pair
        rhs = (pr * br - pi * bi, pr * bi + pi * br)
        return solve_one(rhs, z_pair)

    return jax.vmap(one_ph)(z_pairs, phases)


# all quadrature nodes in one batched dispatch: vmap over the shift z_e
# (the reference fans the nodes out over joblib processes,
# feast_eom_rccsd.py:90-108; here they vectorize — and shard over a
# device mesh axis via ``node_mesh`` in multi-chip runs, each device
# owning n_quad/n_dev independent GMRES solves)
_shifted_solve_nodes = partial(jax.jit, static_argnames=(
    "no", "nv", "is_rt", "ls_max_iter", "restart", "contract_mode",
    "linear_solver"))(_nodes_impl)


def _residual_impl(f, dict_t_V, T2, x_pairs, rhs_pairs, z_pairs, diag_vec,
                   no, nv, is_rt=False, dt=0.0, hbar=None,
                   contract_mode="xla", sigma_sliced=None):
    """Honest per-node relative residuals ‖(z−H)x − b‖/‖b‖ for a solved
    batch — ONE sigma application per node, in a program detached from
    the solve (a silently non-converged node corrupts the spectral
    projector, VERDICT r1; folding this matvec into the while(while)
    solve program inflates its compile).

    ``rhs_pairs`` is per-node, (n, N) — built by :func:`_broadcast_rhs`.
    Returns ``(rel, res_r, res_i)``: the norms AND the residual vectors
    ``r = b − (z−H)x``, which are the next right-hand sides of the
    mixed-precision iterative refinement (VERDICT r3 task 1).

    Sequential ``lax.map`` over nodes, like the solve program: ONE sigma
    instance in the program regardless of node count."""
    def one(args):
        xr, xi, zr, zi, br, bi = args
        matvec, _ = _node_ops(f, dict_t_V, T2, (zr, zi), diag_vec, no,
                              nv, is_rt=is_rt, dt=dt, hbar=hbar,
                              contract_mode=contract_mode,
                              sigma_sliced=sigma_sliced)
        ar, ai = matvec((xr, xi))
        rr = br - ar
        ri = bi - ai
        res = jnp.sqrt(jnp.sum(rr * rr) + jnp.sum(ri * ri))
        bnorm = jnp.sqrt(jnp.sum(br ** 2) + jnp.sum(bi ** 2))
        return res / jnp.maximum(bnorm, 1e-300), rr, ri

    return jax.lax.map(one, (x_pairs[0], x_pairs[1], z_pairs[0],
                             z_pairs[1], rhs_pairs[0], rhs_pairs[1]))


_residual_nodes = partial(jax.jit, static_argnames=(
    "no", "nv", "is_rt", "contract_mode"))(_residual_impl)


class FEAST_EOM_CCSD(EOM_CCSD):
    """FEAST eigensolver in an energy window (reference API:
    ``feast_eom_ccsd.py:29``)."""

    def __init__(self, no, e_c=0.0, e_r=1.0, n_trial=5, max_iter=20,
                 tol=1e-12, n_quad=8, seed=None, n_excit=2,
                 ls_conv_tol=1e-4, node_mesh=None, **kwargs):
        self.no = int(no)
        self.e_c = e_c
        self.e_r = e_r
        self.n_trial = n_trial
        self.n_excit = int(n_excit)   # trial-space seeding (explicit ctor
        self.max_iter = max_iter      # arg; was silently fixed at 2)
        self.tol = tol
        self.n_quad = n_quad
        self.linear_solver = "gmres"
        # device GMRES backend: "inhouse" runs the ozaki sigma inside the
        # solves; "jsp" is the linearization-constrained jax.scipy
        # fallback; None = auto (inhouse exactly when the ozaki
        # machinery is in play — otherwise jsp compiles ~2x faster and
        # is numerically identical)
        self.ls_backend = None
        self.ls_max_iter = 20
        # GMRES(m) restart length.  The near-real-axis contour nodes are
        # nearly singular shifted systems; restarted GMRES stagnates on
        # them at small m — raise this (with ls_max_iter) for tight
        # windows (each Krylov vector costs 2N of the solve dtype)
        self.ls_restart = 20
        self.ls_conv_tol = float(ls_conv_tol)
        # Richardson damping for ls_backend="jacobi" (ω = 1 is the
        # classical Jacobi iteration; the reference's _jacobi runs ω=0.01)
        self.ls_damping = 1.0
        self.node_mesh = node_mesh    # shard quadrature nodes over a mesh
        self.node_axis = "a"
        # solve precision (VERDICT r3 task 1): "mixed" (default) runs the
        # Krylov iterations in f32 — half the bytes of f64 per Krylov
        # vector and sigma operand —
        # inside a scan-over-nodes program (ONE sigma subgraph total),
        # then iteratively refines in f64: r = b − (z−H)x is measured with
        # the full-precision operator (the detached honest-residual
        # program) and re-solved in f32 until ‖r‖/‖b‖ < ls_conv_tol.
        # Each pass contracts the residual by ~the f32 solve tolerance,
        # so 1-2 passes reach 1e-4 and ~3 reach 1e-8.  "f64" restores the
        # round-3 all-f64 path.
        self.ls_precision = "mixed"
        self.ls_refine_max = 4
        # contour nodes per dispatch of the mixed scan path: normalizes
        # dispatch shapes (compile reuse across windows) and bounds rhs
        # memory.  The vmapped-f64 path runs every node in one dispatch.
        self.max_nodes_per_scan = 8
        # bytes the trial lanes' f32 Krylov bases may take at once (None:
        # a quarter of the device's memory limit)
        self.krylov_mem_budget_bytes = None
        # relative singular-value floor for the rank-revealing
        # orthonormalisation of the filtered trial set (None = auto:
        # 10x ls_conv_tol, floored at 1e-12).  The rational filter leaves
        # the set's directions at wildly different scales — in-window
        # states at |rho| ~ 1, borderline states at |rho| ~ 1e-2..1e-3,
        # and junk at the shifted-solve noise floor — so the raw Gram
        # matrix of the oblique projected problem is numerically singular
        # and scipy.eig(H_proj, B) returns finite-but-wrong pairs spread
        # across the window even with every node solve converged
        # (a round-5 nP=57 window: |ev-gold| 9.2e-3 at
        # max_ls_res 9.5e-7).  An SVD of the filtered set with this
        # noise-floor truncation preserves the span, makes B == I to
        # machine precision, and deflates the junk directions.
        self.svd_drop_tol = None
        self.last_ls_residuals = None
        self.u_singles = []
        self.u_doubles = []
        self.eigvals = np.array([e_c - e_r, e_c + e_r])
        self.eigvecs = None
        self._rng = np.random.default_rng(seed)

    def dump_log(self):
        pass

    def _reset_op_cache(self, f, dict_t_V, T2):
        """Drop the per-operator intermediates (hbar, sigma slices, f32
        copies) when the (f, V, T2) triple changes — and ONLY then: the
        RT propagator calls solve() once per time step with the same
        operator, and rebuilding the intermediates per step would
        dominate a long trace."""
        key = (id(f), id(dict_t_V), id(T2))
        if getattr(self, "_op_cache_key", None) != key:
            self._hbar = None
            self._sigma_sliced = None
            self._f32_op = None
            self._op_cache_key = key

    # matvec application for projected matrices; overridable for fake Hams
    def _apply_H(self, f, dict_t_V, u1, u2, T2):
        # factorized-sigma path: handles the no-ovvv dict (gather plans
        # instead of iabc/abic blocks), which the legacy term-list sigma
        # cannot
        hbar = self._get_hbar(f, dict_t_V, T2)
        cm = self._cm()
        w1 = np.asarray(sigma_singles_hbar(f, dict_t_V, hbar,
                                           jnp.asarray(u1), jnp.asarray(u2),
                                           T2, contract_mode=cm))
        w2 = np.asarray(sigma_doubles_hbar(f, dict_t_V, hbar,
                                           jnp.asarray(u1), jnp.asarray(u2),
                                           T2, contract_mode=cm))
        return w1, w2

    def _cm(self):
        from pymes_jax.ops import contract as _ct
        return getattr(self, "contract_mode", None) or _ct.get_mode()

    def _backend(self, dict_t_V):
        """Resolve the GMRES backend (see ``ls_backend``)."""
        backend = getattr(self, "ls_backend", None)
        if backend is not None:
            return backend
        if getattr(self, "ls_precision", "mixed") == "mixed":
            # the mixed engine needs a matvec-only solver (the f32 scan
            # program) — jsp's custom_linear_solve buys nothing there
            return "inhouse"
        from pymes_jax.ops import contract as _ct
        from pymes_jax.ops.ueg_ladder import BlockLadder
        lad = dict_t_V.get("abcd_ladder")
        ozaki_on = (_ct.parse_mode(self._cm()) is not None
                    or (isinstance(lad, BlockLadder)
                        and lad.presliced is not None))
        return "inhouse" if ozaki_on else "jsp"

    def _get_hbar(self, f, dict_t_V, T2):
        """Factorized-sigma intermediates, built once per (f, V, T2)."""
        if getattr(self, "_hbar", None) is None:
            self._hbar = build_hbar(f, dict_t_V, T2,
                                    contract_mode=self._cm())
            self._sigma_sliced = preslice_sigma_hbar(dict_t_V, self._hbar,
                                                     T2, self._cm())
        return self._hbar

    def _warn_unconverged(self, rel_res):
        """Surface non-converged shifted solves instead of silently
        polluting the spectral projector."""
        rel_res = np.atleast_1d(np.asarray(rel_res))
        self.last_ls_residuals = rel_res
        bad = np.nonzero(rel_res > 10 * self.ls_conv_tol)[0]
        if len(bad):
            import warnings
            warnings.warn(
                "FEAST shifted solve(s) not converged: nodes "
                f"{bad.tolist()} rel. residuals "
                f"{rel_res[bad].tolist()} (ls_conv_tol={self.ls_conv_tol}, "
                f"ls_restart={self.ls_restart}, "
                f"ls_max_iter={self.ls_max_iter}) — near-real-axis nodes "
                "stagnate under short restarts: raise ls_restart (120 "
                "closed a tight nP=123 window where 20 stalled at rel "
                "residual ~1), raise ls_max_iter, or loosen the window",
                stacklevel=3)

    def _solve_node(self, f, dict_t_V, T2, b_vec, ze, diag_vec, nv,
                    is_rt=False, dt=0.0, phase=None):
        if phase is not None:
            b_vec = np.asarray(b_vec) * phase
        b_vec = np.asarray(b_vec, dtype=complex)
        b_pair = (jnp.asarray(b_vec.real), jnp.asarray(b_vec.imag))
        z_pair = (jnp.asarray(np.real(ze)), jnp.asarray(np.imag(ze)))
        diag = jnp.asarray(diag_vec)
        (xr, xi), _ = _shifted_solve(
            f, dict_t_V, T2, b_pair, z_pair, diag,
            self.no, nv, is_rt=is_rt, dt=dt,
            ls_max_iter=self.ls_max_iter,
            restart=int(getattr(self, "ls_restart", 20)),
            ls_conv_tol=self.ls_conv_tol,
            hbar=self._get_hbar(f, dict_t_V, T2),
            contract_mode=self._cm(),
            linear_solver=self._backend(dict_t_V),
            sigma_sliced=getattr(self, "_sigma_sliced", None),
            ls_damping=getattr(self, "ls_damping", 1.0))
        rhs_b = _broadcast_rhs(b_pair, None, 1)
        rel_res, _, _ = _residual_nodes(
            f, dict_t_V, T2, (xr[None], xi[None]), rhs_b,
            (z_pair[0][None], z_pair[1][None]), diag, self.no, nv,
            is_rt=is_rt, dt=dt, hbar=self._get_hbar(f, dict_t_V, T2),
            contract_mode=self._cm(),
            sigma_sliced=getattr(self, "_sigma_sliced", None))
        self._warn_unconverged(rel_res)
        return np.asarray(xr) + 1j * np.asarray(xi)

    def _solve_nodes_engine(self, f, dict_t_V, T2, b_vec, z_arr, diag_vec,
                            nv, is_rt=False, dt=0.0, phases=None):
        """(n_nodes, N) solutions of (z_e − H̄)x = b_e on device; returns
        ``(X, rel_res)`` — shared by the FEAST window and the RT
        propagator (whose per-node rhs is ``e^{z_e}·b``, via ``phases``).

        Default path (``ls_precision="mixed"``): f32 Krylov inside a
        scan-over-nodes program + f64 iterative refinement against the
        detached honest-residual program.  ``ls_precision="f64"`` (or a
        ``node_mesh``) takes the round-3 vmapped f64 path.
        """
        no = self.no
        b_vec = np.asarray(b_vec, dtype=complex)
        # (m, N): trial-batched rhs — the mixed scan engine solves all m
        # systems of a node in one vmapped GMRES (sigma applied to the
        # whole batch per matvec); returns (n_nodes, m, N)
        batched = b_vec.ndim == 2
        b_pair = (jnp.asarray(b_vec.real), jnp.asarray(b_vec.imag))
        z_arr = np.asarray(z_arr)
        diag = jnp.asarray(diag_vec)
        hbar = self._get_hbar(f, dict_t_V, T2)
        backend = self._backend(dict_t_V)
        sigma_sliced = getattr(self, "_sigma_sliced", None)
        damping = getattr(self, "ls_damping", 1.0)
        mixed = (getattr(self, "ls_precision", "mixed") == "mixed"
                 and backend in ("inhouse", "opt", "jacobi")
                 and self.node_mesh is None)
        cap = (getattr(self, "max_nodes_per_scan", 8) if mixed
               else len(z_arr))
        ph_all = None if phases is None else np.asarray(phases)

        # trial-axis chunking: each batched lane carries its own
        # (restart+1, 2N) f32 Krylov basis (~640 MB at restart=120,
        # nP=123), so the lanes of one chunk are bounded by a memory
        # budget; the sigma-sharing win saturates quickly anyway (the
        # V-block traffic is amortised across the lanes in a chunk).
        t_cap = int(getattr(self, "max_trials_per_batch", 3) or 0)
        if mixed and batched and t_cap > 1:
            lane_bytes = ((int(getattr(self, "ls_restart", 20)) + 1)
                          * 2 * b_vec.shape[-1] * 4)
            budget = _krylov_budget_bytes(
                getattr(self, "krylov_mem_budget_bytes", None))
            if budget < t_cap * lane_bytes:
                t_auto = max(1, int(budget // lane_bytes))
                print_logging_info(
                    f"Krylov memory guard: {t_cap} trial lanes × "
                    f"{lane_bytes / 1e9:.2f} GB basis exceeds the "
                    f"{budget / 1e9:.1f} GB budget — batching "
                    f"{t_auto} lane(s) at a time", level=2)
                t_cap = t_auto
        xs, rels = [], []
        for lo in range(0, len(z_arr), cap):
            z_c = z_arr[lo:lo + cap]
            z_pairs = (jnp.asarray(z_c.real), jnp.asarray(z_c.imag))
            ph_c = None
            if ph_all is not None:
                p = ph_all[lo:lo + cap]
                ph_c = (jnp.asarray(p.real), jnp.asarray(p.imag))
            rhs64 = _broadcast_rhs(b_pair, ph_c, len(z_c))
            if mixed and batched and t_cap and b_vec.shape[0] > t_cap:
                # even chunks (4 with cap 3 → 2+2, not 3+1): fewer
                # distinct program shapes to compile
                m_all = b_vec.shape[0]
                t_cap = -(-m_all // (-(-m_all // t_cap)))
                xs_t, rels_t = [], []
                for tl in range(0, m_all, t_cap):
                    x_t, rel_t = self._solve_chunk_mixed(
                        f, dict_t_V, T2, hbar,
                        (rhs64[0][:, tl:tl + t_cap],
                         rhs64[1][:, tl:tl + t_cap]), z_pairs, diag, nv,
                        is_rt=is_rt, dt=dt, backend=backend,
                        damping=damping, sigma_sliced=sigma_sliced)
                    xs_t.append(x_t)
                    rels_t.append(np.atleast_2d(np.asarray(rel_t)))
                x_c = np.concatenate(xs_t, axis=1)
                rel_c = np.concatenate(rels_t, axis=1)
            elif mixed:
                x_c, rel_c = self._solve_chunk_mixed(
                    f, dict_t_V, T2, hbar, rhs64, z_pairs, diag, nv,
                    is_rt=is_rt, dt=dt, backend=backend, damping=damping,
                    sigma_sliced=sigma_sliced)
            elif batched:
                # legacy f64 vmapped path has no trial axis: loop trials
                xs_l, rels_l = [], []
                for l in range(b_vec.shape[0]):
                    x_l, rel_l = self._solve_chunk_f64(
                        f, dict_t_V, T2, hbar,
                        (b_pair[0][l], b_pair[1][l]),
                        (rhs64[0][:, l], rhs64[1][:, l]), z_pairs, diag,
                        nv, is_rt=is_rt, dt=dt, backend=backend,
                        damping=damping, sigma_sliced=sigma_sliced,
                        phases=ph_c)
                    xs_l.append(x_l)
                    rels_l.append(np.atleast_1d(np.asarray(rel_l)))
                x_c = np.stack(xs_l, axis=1)
                rel_c = np.stack(rels_l, axis=1)
            else:
                x_c, rel_c = self._solve_chunk_f64(
                    f, dict_t_V, T2, hbar, b_pair, rhs64, z_pairs, diag,
                    nv, is_rt=is_rt, dt=dt, backend=backend,
                    damping=damping, sigma_sliced=sigma_sliced,
                    phases=ph_c)
            xs.append(x_c)
            rels.append(np.atleast_1d(np.asarray(rel_c)))
        rels = np.concatenate(rels)
        self._warn_unconverged(rels)
        return np.concatenate(xs, axis=0), rels

    def _solve_chunk_f64(self, f, dict_t_V, T2, hbar, b_pair, rhs64,
                         z_pairs, diag, nv, is_rt, dt, backend, damping,
                         sigma_sliced, phases):
        """Round-3 path: vmapped f64 solves (node-mesh shardable)."""
        f_c, V_c, T2_c, b_c, diag_c = f, dict_t_V, T2, b_pair, diag
        if self.node_mesh is not None:
            from pymes_jax.parallel import sharding as psh
            z_pairs = psh.shard_over_nodes(z_pairs, self.node_mesh,
                                           axis=self.node_axis)
            f_c, V_c, T2_c, b_c, diag_c = psh.replicate(
                (f, dict_t_V, T2, b_pair, diag), self.node_mesh)
        (xr, xi), _ = _shifted_solve_nodes(
            f_c, V_c, T2_c, b_c, z_pairs, diag_c, self.no, nv,
            is_rt=is_rt, dt=dt, ls_max_iter=self.ls_max_iter,
            restart=int(getattr(self, "ls_restart", 20)),
            ls_conv_tol=self.ls_conv_tol, hbar=hbar,
            contract_mode=self._cm(), phases=phases,
            linear_solver=backend, sigma_sliced=sigma_sliced,
            ls_damping=damping)
        # honest residuals, detached program (one sigma per node)
        rel, _, _ = _residual_nodes(
            f_c, V_c, T2_c, (xr, xi), rhs64, z_pairs, diag_c, self.no,
            nv, is_rt=is_rt, dt=dt, hbar=hbar, contract_mode=self._cm(),
            sigma_sliced=sigma_sliced)
        return np.asarray(xr) + 1j * np.asarray(xi), rel

    def _get_f32_operator(self, f, dict_t_V, T2, hbar, diag):
        """f32 copies of the solve-invariant operator pieces, built once
        per (f, V, T2) — reset alongside ``_hbar``."""
        if getattr(self, "_f32_op", None) is None:
            self._f32_op = (_cast_f32(f), _cast_f32(dict_t_V),
                            _cast_f32(T2), _cast_f32(hbar),
                            diag.astype(jnp.float32))
        return self._f32_op

    def _solve_chunk_mixed(self, f, dict_t_V, T2, hbar, rhs64, z_pairs,
                           diag, nv, is_rt, dt, backend, damping,
                           sigma_sliced):
        """f32 scan-over-nodes Krylov + f64 iterative refinement."""
        no = self.no
        f3, V3, T3, h3, d3 = self._get_f32_operator(f, dict_t_V, T2,
                                                    hbar, diag)
        z3 = (z_pairs[0].astype(jnp.float32),
              z_pairs[1].astype(jnp.float32))
        # the f32 Krylov stalls near f32 rounding; each refinement pass
        # re-solves against the f64 residual, so the inner tolerance only
        # sets the per-pass contraction factor
        tol32 = max(self.ls_conv_tol, 1e-5)
        n = z_pairs[0].shape[0]
        x_pairs = (jnp.zeros_like(rhs64[0]), jnp.zeros_like(rhs64[1]))
        cur = rhs64
        rel = np.full((n,), np.inf)
        rel_prev = rel
        for _ in range(max(1, int(getattr(self, "ls_refine_max", 4)))):
            rhs32 = (cur[0].astype(jnp.float32),
                     cur[1].astype(jnp.float32))
            # full-f32 dots: the default precision lets GPUs run f32
            # matmuls in TF32, and a 10-bit mantissa contracts each
            # refinement pass only ~1e-3
            with jax.default_matmul_precision("float32"):
                dx_r, dx_i, _ = _shifted_solve_nodes_scan(
                    f3, V3, T3, rhs32, z3, d3, no, nv, is_rt=is_rt,
                    dt=dt, ls_max_iter=self.ls_max_iter,
                    restart=int(getattr(self, "ls_restart", 20)),
                    ls_conv_tol=tol32, hbar=h3, contract_mode="xla",
                    linear_solver=backend, ls_damping=damping)
            x_pairs = _accum_x(x_pairs, dx_r, dx_i)
            # trial-batched (n, m, N): flatten (node, trial) → n·m map
            # entries so the residual program keeps its
            # one-sigma-per-entry shape
            if rhs64[0].ndim == 3:
                nn, mm, NN = rhs64[0].shape
                z_res = (jnp.repeat(z_pairs[0], mm),
                         jnp.repeat(z_pairs[1], mm))
                rel_j, rr, ri = _residual_nodes(
                    f, dict_t_V, T2,
                    (x_pairs[0].reshape(nn * mm, NN),
                     x_pairs[1].reshape(nn * mm, NN)),
                    (rhs64[0].reshape(nn * mm, NN),
                     rhs64[1].reshape(nn * mm, NN)),
                    z_res, diag, no, nv, is_rt=is_rt, dt=dt, hbar=hbar,
                    contract_mode=self._cm(), sigma_sliced=sigma_sliced)
                rel_j = rel_j.reshape(nn, mm)
                rr = rr.reshape(nn, mm, NN)
                ri = ri.reshape(nn, mm, NN)
            else:
                rel_j, rr, ri = _residual_nodes(
                    f, dict_t_V, T2, x_pairs, rhs64, z_pairs, diag, no,
                    nv, is_rt=is_rt, dt=dt, hbar=hbar,
                    contract_mode=self._cm(), sigma_sliced=sigma_sliced)
            rel = np.asarray(rel_j)
            if np.all(rel <= self.ls_conv_tol):
                break
            if np.max(rel) > 0.5 * np.max(rel_prev):
                # the inner solver is STALLING (restarted GMRES stagnates
                # on near-singular contour nodes at small restart m) —
                # more refinement passes repeat the same stagnation;
                # raise ls_restart/ls_max_iter instead (the caller's
                # non-convergence warning fires on the honest residual)
                break
            rel_prev = rel
            cur = (rr, ri)
        return np.asarray(x_pairs[0]) + 1j * np.asarray(x_pairs[1]), rel

    def _solve_all_nodes(self, f, dict_t_V, T2, b_vec, z_arr, diag_vec, nv):
        """(n_nodes, N) solutions of (z_e − H̄)x = b on device.

        Subclasses that override the per-node solver (e.g. dense test
        Hamiltonians) automatically fall back to a per-node loop.  With
        ``node_mesh`` set, the node axis is sharded over the mesh —
        the device-mesh version of the reference's joblib fan-out.
        """
        if type(self)._solve_node is not FEAST_EOM_CCSD._solve_node:
            return np.stack([
                self._solve_node(f, dict_t_V, T2, b_vec, ze, diag_vec, nv)
                for ze in np.asarray(z_arr)])
        X, _ = self._solve_nodes_engine(f, dict_t_V, T2, b_vec, z_arr,
                                        diag_vec, nv)
        return X

    def solve(self, t_fock_dressed_pq, dict_t_V_dressed, t_T_abij):
        """FEAST iteration (reference flow, ``feast_eom_ccsd.py:72-181``)."""
        print_title("FEAST-EOM-CCSD Solver")
        time_init = time.time()
        no = self.no
        self._reset_op_cache(t_fock_dressed_pq, dict_t_V_dressed, t_T_abij)
        f = jnp.asarray(t_fock_dressed_pq)
        T2 = jnp.asarray(t_T_abij)
        diag_ai = np.asarray(get_diag_singles(f, dict_t_V_dressed, T2))
        diag_abij = np.asarray(get_diag_doubles(f, dict_t_V_dressed, T2))
        diag_vec = np.concatenate([diag_ai.ravel(), diag_abij.ravel()])
        nv = diag_ai.shape[0]
        n1 = nv * no

        print_logging_info("Initialising u tensors...", level=1)
        # a second solve() must not inherit the previous run's converged
        # subspace on top of fresh randoms (silently changing the subspace
        # size across calls) — start clean every time
        self.u_singles = []
        self.u_doubles = []
        for _ in range(self.n_excit):
            self.u_singles.append(0.5 - self._rng.random(diag_ai.shape))
            self.u_doubles.append(
                (0.5 - self._rng.random(diag_abij.shape)) * 0.01)
        for l in range(len(self.u_singles)):
            self.u_singles[l], self.u_doubles[l] = normalize_amps(
                self.u_singles[l], self.u_doubles[l])

        x, w = get_gauss_legendre_quadrature(self.n_quad)
        theta = -np.pi / 2 * (x - 1)
        z = self.e_c + self.e_r * np.exp(1j * theta)

        e_norm_prev = 1e10
        self.iter_walls = []   # per-outer-iteration seconds (profiling)
        for it in range(self.max_iter):
            t_iter0 = time.time()
            m = len(self.u_singles)
            Q = [np.zeros(n1 + nv * nv * no * no) for _ in range(m)]
            # orthonormalise the trial SET (not just each vector): after a
            # couple of filter applications all trial vectors collapse
            # toward the dominant filtered directions, the Gram matrix B
            # of the oblique projected problem goes numerically singular,
            # and the Ritz values drift by ~1e-2 even with node solves
            # converged to 1e-6 (nP=123, round 4).  QR preserves
            # the span, so exact-arithmetic behavior is unchanged.
            U_set = np.stack([np.concatenate([s.ravel(), d.ravel()])
                              for s, d in zip(self.u_singles,
                                              self.u_doubles)])
            q_set = np.linalg.qr(U_set.T)[0].T
            for l in range(m):
                self.u_singles[l] = q_set[l, :n1].reshape(nv, no)
                self.u_doubles[l] = q_set[l, n1:].reshape(nv, nv, no, no)
            node_weight = (w / 2 * self.e_r * np.exp(1j * theta))
            B = np.stack([np.concatenate([self.u_singles[l].ravel(),
                                          self.u_doubles[l].ravel()])
                          for l in range(m)])
            if type(self)._solve_node is not FEAST_EOM_CCSD._solve_node:
                # subclassed per-node solver (dense test Hamiltonians):
                # per-trial fallback
                X = np.stack([self._solve_all_nodes(
                    f, dict_t_V_dressed, T2, B[l], z, diag_vec, nv)
                    for l in range(m)], axis=1)
            else:
                # all m trials in one trial-batched engine call per node
                X, _ = self._solve_nodes_engine(f, dict_t_V_dressed, T2,
                                                B, z, diag_vec, nv)
            for l in range(m):  # (n_nodes, m, N)
                Q[l] = -np.real(node_weight[:, None] * X[:, l, :]).sum(
                    axis=0)

            # rank-revealing orthonormalisation of the filtered set
            # before the projected problem (see svd_drop_tol in __init__:
            # the raw Gram matrix is numerically singular and poisons
            # every Ritz value, not just the junk ones)
            drop = (self.svd_drop_tol if self.svd_drop_tol is not None
                    else max(10.0 * self.ls_conv_tol, 1e-12))
            _, sv, vt = np.linalg.svd(np.stack(Q), full_matrices=False)
            m_eff = max(int(np.count_nonzero(sv > drop * sv[0])), 1)
            Q = [vt[i] for i in range(m_eff)]

            # projected oblique eigenproblem on the filtered subspace
            # (B == I to machine precision after the SVD; kept explicit
            # so the oblique formulation stays visible for parity with
            # the reference, feast_eom_ccsd.py:148)
            H_proj = np.zeros((m_eff, m_eff))
            B = np.zeros((m_eff, m_eff))
            W = []
            for i in range(m_eff):
                q1 = Q[i][:n1].reshape(nv, no)
                q2 = Q[i][n1:].reshape(nv, nv, no, no)
                w1, w2 = self._apply_H(f, dict_t_V_dressed, q1, q2, T2)
                W.append(np.concatenate([w1.ravel(), w2.ravel()]))
            for i in range(m_eff):
                for j in range(m_eff):
                    H_proj[j, i] = Q[j] @ W[i]
                    B[j, i] = Q[j] @ Q[i]
            self.eigvals, self.eigvecs = eig(H_proj, B)
            # a singular B (trial space larger than the window eigencount)
            # yields inf/nan pairs — drop those COLUMNS from the update and
            # the convergence norm (each eigenvector still has m rows: the
            # rotation must always sum over the full subspace dimension)
            finite = np.isfinite(self.eigvals)
            if not finite.all():
                self.eigvals = self.eigvals[finite]
                self.eigvecs = self.eigvecs[:, finite]
            if len(self.eigvals) == 0:
                print_logging_info(
                    "No finite eigenvalues in the energy window.", level=1)
                break

            # rotate/extend trial space with the filtered Ritz vectors
            if m < self.n_trial:
                for l in range(len(self.eigvals)):
                    new = sum(np.real(self.eigvecs[i, l]) * Q[i]
                              for i in range(len(Q)))
                    self.u_singles.append(new[:n1].reshape(nv, no))
                    self.u_doubles.append(
                        new[n1:].reshape(nv, nv, no, no))
            elif getattr(self, "trial_update", "replace") == "accumulate":
                # reference behavior (feast_eom_ccsd.py:162-166): ADD the
                # filtered Ritz vectors onto the previous trial set.  This
                # damps the subspace iteration — out-of-window pollution
                # decays like (1/(1+ρ))^k instead of (ρ_out/ρ_in)^k, and a
                # 3-iteration window solve at nP=123 stalled ~2e-2 off the
                # true pairs with every node solve converged to 1e-6
                # (round 4).  Kept for parity studies only.
                for l in range(len(self.eigvals)):
                    upd = sum(np.real(self.eigvecs[i, l]) * Q[i]
                              for i in range(len(Q)))
                    self.u_singles[l] = self.u_singles[l] \
                        + upd[:n1].reshape(nv, no)
                    self.u_doubles[l] = self.u_doubles[l] \
                        + upd[n1:].reshape(nv, nv, no, no)
            else:
                # classical FEAST subspace iteration: REPLACE the trial
                # set with the Ritz rotation of the filtered vectors
                for l in range(len(self.eigvals)):
                    upd = sum(np.real(self.eigvecs[i, l]) * Q[i]
                              for i in range(len(Q)))
                    self.u_singles[l] = upd[:n1].reshape(nv, no)
                    self.u_doubles[l] = upd[n1:].reshape(nv, nv, no, no)

            self.iter_walls.append(time.time() - t_iter0)
            e_norm = np.linalg.norm(self.eigvals)
            if np.abs(e_norm - e_norm_prev) < self.tol:
                break
            print_logging_info(
                f"Iter = {it}, Eigenvalues: {self.eigvals}", level=1)
            e_norm_prev = e_norm

        print_logging_info(
            f"FEAST-EOM-CCSD finished in {time.time() - time_init:.2f} "
            "seconds.", level=0)
        self.e_excit = self.eigvals
        return self.eigvals
