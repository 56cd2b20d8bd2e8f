"""DIIS (Pulay) convergence acceleration, on-device.

Functionally equivalent to the reference mixer (``pymes/mixer/diis.py:9``):
a sliding window of the last ``dim_space`` (error, amplitude) pairs, a
bordered least-squares system ``L c = (0,…,0,−1)`` with
``L[i,j] = Re⟨err_i, err_j⟩`` and a −1 Lagrange border, solved through an
eigendecomposition with linear-dependence pruning (|λ| > 1e−12), and the
mixed amplitudes ``Σ_a c_a amp_a``.

Device design: instead of Python lists of tensors, the state is a pair of
fixed-shape ring buffers ``(m, N)`` carried through ``lax.while_loop`` — the
whole CC iteration, DIIS included, stays inside one jitted fixed-point loop.
Unused slots are masked, making the masked L-matrix block the identity so
their coefficients vanish exactly.

A stateful :class:`DIIS` wrapper preserves the reference's ``mix(errors,
amplitudes)`` list API for host-driven loops.
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
from jax import lax


def _gauss_solve(A, b):
    """Dense solve by Gaussian elimination with partial pivoting.

    Written in elementwise jnp ops + ``lax.fori_loop``: the DIIS system
    is a tiny bordered saddle matrix, and this solve reproduces the CPU
    DIIS trajectory exactly on every backend (replacing it with
    ``jnp.linalg.solve`` is an open design item).  The caller
    regularises near-singular systems (ridge on the normalised B).
    """
    n = A.shape[0]
    Ab = jnp.concatenate([A, b[:, None]], axis=1)

    # n ≤ diis_dim+1 is a small static size: unrolled straight-line HLO
    # (a fori_loop version pushed the remote XLA compile of the enclosing
    # solver while_loop from ~40 s to ~10 min)
    for k in range(n):
        col = jnp.abs(Ab[:, k])
        col = jnp.where(jnp.arange(n) < k, -1.0, col)
        p = jnp.argmax(col)
        rk, rp = Ab[k], Ab[p]
        Ab = Ab.at[k].set(rp).at[p].set(rk)
        piv = Ab[k, k]
        piv = jnp.where(jnp.abs(piv) < 1e-300, 1e-300, piv)
        factors = Ab[:, k] / piv
        factors = jnp.where(jnp.arange(n) <= k, 0.0, factors)
        Ab = Ab - factors[:, None] * Ab[k][None, :]

    x = jnp.zeros_like(b)
    for k in range(n - 1, -1, -1):
        # Ab[k, j<k] is eliminated (0) and x[k] is still 0, so the full dot
        # yields exactly the already-solved tail contribution
        s = Ab[k, n] - jnp.dot(Ab[k, :n], x)
        x = x.at[k].set(s / Ab[k, k])
    return x


class DIISState(NamedTuple):
    """Ring buffers of flattened amplitudes/errors plus an insertion counter.

    ``B`` carries the Gram matrix ``Re<err_i, err_j>`` incrementally: each
    insertion recomputes only the new row/column (m dots) instead of all
    m² pairwise dots, each a full pass over the m·N ring.  Invariant: every entry
    equals the dot of the *current* ring contents (overwriting slot k
    refreshes row and column k against all live errors), so it can always
    be rebuilt from ``errs`` alone (checkpoint restore does).
    """

    amps: jnp.ndarray   # (m, N)
    errs: jnp.ndarray   # (m, N)
    count: jnp.ndarray  # scalar int — total number of insertions so far
    B: jnp.ndarray      # (m, m) real Gram matrix of errs


def init_state(dim_space: int, n_flat: int, dtype,
               err_dtype=None) -> DIISState:
    """``err_dtype`` (default: ``dtype``): carrier of the ERROR ring.
    The errors only feed the Gram matrix, whose entries condition the
    tiny bordered solve — an f32 carrier (half the bytes of f64 over the
    m·N ring) perturbs the
    DIIS coefficients at ~1e-7 relative, far below the solver's
    self-correcting Jacobi step; the AMPLITUDE ring stays full
    precision (the mixed output is the solver state)."""
    real_dtype = jnp.zeros((), dtype=dtype).real.dtype
    return DIISState(
        amps=jnp.zeros((dim_space, n_flat), dtype=dtype),
        errs=jnp.zeros((dim_space, n_flat),
                       dtype=err_dtype if err_dtype is not None else dtype),
        count=jnp.zeros((), dtype=jnp.int32),
        B=jnp.zeros((dim_space, dim_space), dtype=real_dtype),
    )


def gram_from_errs(errs):
    """Rebuild the carried Gram matrix from the error ring (restore path)."""
    return jnp.real(errs.conj() @ errs.T)


def mix(state: DIISState, err_flat: jnp.ndarray, amp_flat: jnp.ndarray):
    """Insert (err, amp), solve the DIIS system, return (new_state, mixed_amp).

    Pure function of fixed-shape arrays — safe inside jit/while_loop/shard_map.
    """
    m = state.amps.shape[0]
    slot = state.count % m
    amps = state.amps.at[slot].set(amp_flat)
    # the error ring may carry a lower dtype (see init_state.err_dtype) —
    # insert and take the Gram row in THAT dtype
    err_ins = err_flat.astype(state.errs.dtype)
    errs = state.errs.at[slot].set(err_ins)
    count = state.count + 1
    n_valid = jnp.minimum(count, m)

    valid = (jnp.arange(m) < n_valid).astype(amps.real.dtype)

    # B[i,j] = Re<err_i, err_j>, masked outside the valid window; only the
    # inserted slot's row/column is recomputed (see DIISState docstring).
    # Normalised by its largest diagonal entry: a uniform scaling of B
    # leaves the DIIS coefficients invariant (only the Lagrange multiplier
    # rescales) but keeps the bordered matrix well-conditioned against the
    # −1 constraint border as the errors shrink — without this, the
    # absolute eigenvalue-pruning threshold below misclassifies directions
    # once ‖err‖² ≲ 1e-6 (a DIIS noise floor wherever eigh has larger
    # relative error on tiny eigenvalues).
    row = jnp.real(jnp.sum(errs.conj() * err_ins[None, :],
                           axis=1)).astype(state.B.dtype)
    B_raw = state.B.at[slot, :].set(row).at[:, slot].set(row)
    mask2 = valid[:, None] * valid[None, :]
    B = B_raw * mask2
    beta = jnp.maximum(jnp.max(jnp.diagonal(B)), 1e-300)
    B = B / beta
    # ridge against linearly dependent error vectors (the reference prunes
    # small eigenvalues instead, diis.py:85-95; a relative ridge is the
    # factorization-free equivalent)
    B = B + 1e-14 * jnp.diag(valid)

    # bordered system: L = [[B, -1], [-1, 0]] on valid rows; identity on
    # invalid rows so the solve stays well-posed with c_invalid = 0
    L = jnp.zeros((m + 1, m + 1), dtype=B.dtype)
    L = L.at[:m, :m].set(B + jnp.diag(1.0 - valid))
    L = L.at[:m, m].set(-valid)
    L = L.at[m, :m].set(-valid)

    rhs = jnp.zeros(m + 1, dtype=B.dtype).at[m].set(-1.0)

    c = _gauss_solve(L, rhs)

    coeff = (c[:m] * valid).astype(amps.dtype)
    mixed = jnp.sum(coeff[:, None] * amps, axis=0)
    return DIISState(amps=amps, errs=errs, count=count, B=B_raw), mixed


class DIIS:
    """Stateful wrapper with the reference list-of-tensors API.

    ``mix(errors, amplitudes)`` takes lists of tensors (e.g. ``[dT1, dT2]``,
    ``[T1, T2]``) and returns the mixed amplitudes as a list with the original
    shapes, like ``pymes/mixer/diis.py:16``.
    """

    def __init__(self, dim_space: int = 5):
        self.dim_space = dim_space
        self._state = None
        self._shapes = None
        self._sizes = None

    def reset(self):
        self._state = None

    def mix(self, error, amplitude):
        err_flat = jnp.concatenate([jnp.ravel(e) for e in error])
        amp_flat = jnp.concatenate([jnp.ravel(a) for a in amplitude])
        if self._state is None:
            self._shapes = [np.shape(a) for a in amplitude]
            self._sizes = [int(np.prod(s)) for s in self._shapes]
            self._state = init_state(self.dim_space, amp_flat.size,
                                     amp_flat.dtype)
        self._state, mixed = mix(self._state, err_flat, amp_flat)
        out, off = [], 0
        for shape, size in zip(self._shapes, self._sizes):
            out.append(mixed[off:off + size].reshape(shape))
            off += size
        return out
