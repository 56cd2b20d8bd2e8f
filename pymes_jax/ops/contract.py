"""Precision-mode dispatch for the solvers' two-operand contractions.

Every hot einsum in the CC residual/sigma builders goes through
:func:`contract` so the numeric backend can be swapped without touching
solver code (the reference hardwired ``np.einsum``; CTF's distributed
einsum played this role historically, ``pymes/solver/ccd.py:11``):

* ``"xla"`` (default) — ``jnp.einsum`` in the working dtype: native f64
  GEMMs (cuBLAS on a GPU).
* ``"ozaki"`` — f64 operands split into bf16 mantissa slices whose
  products are exact (:mod:`pymes_jax.ops.ozaki`); near-f64 accuracy at
  ``n_slices²`` bf16 products per f64 product.  Tiny contractions (below
  ``_MIN_FLOPS`` or with a short contracted axis) stay on XLA, where
  slicing overhead would dominate.  Tune the accuracy/cost point with
  ``set_mode``'s ``n_slices``/``t_cutoff`` — (9, 9) is full f64 (~1e-15
  normwise), (7, 6) is ~1e-9, ample for a |dE| < 1e-8 fixed point.  No
  default selects it: on an H100 it ran the nP=219 CCD iteration 8-12x
  slower than ``"xla"``.

Mode strings: ``"xla"``, ``"ozaki"`` (= ``"ozaki:9:9"``), or
``"ozaki:S:T"``.  Solvers thread the mode as a *static jit argument* —
a module global alone would silently go stale against jax's trace cache —
and the module-level default only seeds calls that don't pass one.
"""

import jax.numpy as jnp
import numpy as np

from pymes_jax.ops import ozaki

_MODE = "xla"
_MIN_FLOPS = 1 << 24
_MIN_K = 96


def parse_mode(mode):
    """Validate a mode string; return (n_slices, t_cutoff) or None for xla."""
    if mode == "xla":
        return None
    if mode == "ozaki":
        return 9, 9
    parts = mode.split(":")
    if len(parts) == 3 and parts[0] == "ozaki":
        return int(parts[1]), int(parts[2])
    raise ValueError(
        f"contract mode must be 'xla', 'ozaki' or 'ozaki:S:T', got {mode!r}")


def set_mode(mode):
    global _MODE
    parse_mode(mode)
    _MODE = mode


def get_mode():
    return _MODE


def _shape_stats(spec, a, b):
    """(contracted length K, FLOPs) of a two-operand einsum."""
    sa, sb, out, batch, fa, fb, con, dim = ozaki._plan(spec, a.shape,
                                                       b.shape)
    k = int(np.prod([dim[c] for c in con], initial=1))
    flops = 2 * int(np.prod([dim[c] for c in set(sa + sb)], initial=1))
    return k, flops


def contract(spec, a, b, mode=None):
    """``jnp.einsum(spec, a, b)`` through the selected precision backend."""
    opts = parse_mode(_MODE if mode is None else mode)
    if (opts is not None and a.dtype == jnp.float64
            and b.dtype == jnp.float64):
        k, flops = _shape_stats(spec, a, b)
        if k >= _MIN_K and flops >= _MIN_FLOPS:
            return ozaki.einsum2(spec, a, b, n_slices=opts[0],
                                 t_cutoff=opts[1])
    return jnp.einsum(spec, a, b)
