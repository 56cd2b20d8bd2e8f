"""Ozaki-split f64 matmul from exact bf16 slice products.

For matrix units without f64, the Ozaki scheme (Ozaki et al., Numer.
Algorithms 59, 2012; int8 variant Ootomo et al., IJHPCA 2024) recovers f64
accuracy by making every low-precision product *exact* (a double-single
scheme bottoms out at ~1e-7 relative because its per-product f32
accumulation rounds).  On an H100, which has f64 tensor cores, this path
ran the nP=219 CCD iteration 8-12x slower than plain f64 GEMMs, so nothing
selects it by default (``contract_mode="ozaki:S:T"`` opts in):

* scale each row of A (column of B) by a power of two so |x| < 1,
* split the scaled mantissa into ``n_slices`` signed 6-bit integer slices
  (``x = sum_s q_s * 64**-(s+1)``, |q_s| <= 63, truncation toward zero),
* multiply bf16-carried slices with f32 accumulation (products <= 2^12
  and partial sums below 2^24 are exact in f32; K is chunked past that
  and partials accumulate in f64),
* reconstruct in f64: slice-pair diagonals d = i+j share the scale
  ``64**-(d+2)``, so all pairs on a diagonal are fused into ONE matmul by
  concatenating slices along K, leaving ~``t_cutoff+1`` integer matmuls
  and one f64 scale-and-add sweep per diagonal.

Exactness: each slice-pair dot is exact (f32-carried products with
K-chunked f64 accumulation, see ``_pair_dot``).  Dropped pairs (i+j >
``t_cutoff``) and the slice-representation tail bound the error at
~``(t_cutoff+2)*2**(-6*(t_cutoff+1)) + 2**(-6*n_slices+1)`` relative to
``K * rowmax(A) * colmax(B)`` — defaults (9, 9) land at ~1e-15 normwise,
i.e. genuine f64; (5, 4) is a cheap ~1e-8 tier for early CC iterations.

Replaces the role of the reference's CTF/BLAS dgemm underneath every hot
contraction (``pymes/solver/ccd.py:187`` and friends); no reference code
is used.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

SLICE_BITS = 6
RADIX = float(1 << SLICE_BITS)  # 64
_PROD_MAX = 63 * 63


def _pow2_f32(e):
    """Exact f32 2**e for int32 ``e`` in [-126, 127]: assemble the
    exponent field directly (f32 exp2 is a polynomial — NOT exact)."""
    bits = ((e.astype(jnp.int32) + 127) << 23)
    return jax.lax.bitcast_convert_type(bits, jnp.float32)


def _pow2(e):
    """Exact f64 2**e for int32 ``e`` in [-252, 254].

    Builds two exact f32 power-of-two factors from raw exponent bits and
    multiplies in f64 (no f64 ``ldexp``/``frexp``, which some XLA backends
    rewrite through s64 bitcasts).
    """
    e1 = e // 2
    e2 = e - e1
    return (_pow2_f32(e1).astype(jnp.float64)
            * _pow2_f32(e2).astype(jnp.float64))


def _slice_scaled(x, n_slices, axis):
    """Split f64 ``x`` into int8 slices with power-of-two scales.

    Returns ``(slices, e)`` with ``slices`` of shape ``(n_slices,) + x.shape``
    (bf16-carried 6-bit integers) and ``e`` int32 exponents broadcastable against ``x`` along
    ``axis`` such that ``x = 2.**e * sum_s slices[s] * RADIX**-(s+1)``
    up to a ``2**(-SLICE_BITS*n_slices)`` relative-to-scale tail.

    The exponent comes from f32 ``frexp`` of the row max (the
    f64→f32 conversion can over-round to the next power of two, which only
    shifts slice alignment one harmless bit).  Rows with |max| below the
    f32 subnormal range collapse to zero slices.
    """
    amax = jnp.max(jnp.abs(x), axis=axis, keepdims=True)
    # frexp on f32: amax <= m * 2^e with m in [0.5, 1]
    _, e = jnp.frexp(amax.astype(jnp.float32))
    e = jnp.where(amax > 0, e, 0).astype(jnp.int32)
    y = x * _pow2(-e)
    slices = []
    for _ in range(n_slices):
        y = y * RADIX
        q = jnp.trunc(y)
        # bf16 carrier: |q| <= 63 is exact in bf16, bf16 products
        # accumulate exactly in f32, and no per-call cast of the big
        # sliced operand is needed (an int8 store needs a 4x f32
        # materialization per dot)
        slices.append(q.astype(jnp.bfloat16))
        y = y - q
    return jnp.stack(slices), e


def slice_rows(a, n_slices):
    """Pre-slice the left operand (scales per row). a: (M, K) f64."""
    s, e = _slice_scaled(a, n_slices, axis=1)
    return s, e[:, 0]


def slice_tensor(x, n_slices):
    """Slice a whole tensor against ONE global scale.

    Returns ``(slices, e)`` with ``slices`` of shape ``(n_slices,) + x.shape``
    and a scalar int32 ``e`` such that
    ``x = 2.**e * sum_s slices[s] * RADIX**-(s+1)`` up to the usual tail.

    Unlike :func:`slice_rows`/:func:`slice_cols` the representation is
    *layout-independent*: any transpose/reshape of the slice stack is a
    valid slicing of the transposed tensor, so one slicing serves every
    index order a contraction needs (the per-row scale ties slices to one
    specific matrix view).  The price is accuracy relative to the GLOBAL
    max instead of the row max — for CC amplitudes/integrals (dynamic
    range ≲ 2¹⁰) that costs ~2 of the ``6*n_slices`` mantissa bits.
    """
    amax = jnp.max(jnp.abs(x))
    _, e = jnp.frexp(amax.astype(jnp.float32))
    e = jnp.where(amax > 0, e, 0).astype(jnp.int32)
    y = x * _pow2(-e)
    slices = []
    for _ in range(n_slices):
        y = y * RADIX
        q = jnp.trunc(y)
        slices.append(q.astype(jnp.bfloat16))
        y = y - q
    return jnp.stack(slices), e


def slice_cols(b, n_slices):
    """Pre-slice the right operand (scales per column). b: (K, N) f64."""
    s, e = _slice_scaled(b, n_slices, axis=0)
    return s, e[0, :]


# exact-f32 accumulation bound: slice products are <= 63*63, and f32
# holds integers exactly below 2^24, so a dot over K <= _F32_CHUNK is
# EXACT with an f32 carrier; longer K is chunked with f64 partial sums.
# chip_smoke.py checks this on the GPU: the nP=219 CCD agrees between
# "xla" and "ozaki:7:6" to 1e-8 Ha.
_F32_CHUNK = ((1 << 24) - 1) // _PROD_MAX


def _slice_dot_f32(a8, b8):
    return jax.lax.dot_general(
        a8, b8, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)


def _pair_dot(a8, b8):
    """Exact f64 product of two slice matrices (K-chunked f32 dots).

    A few chunks unroll; long K (the small-output projections contract
    no·nv² ≈ 3·10⁵) runs ONE batched dot over zero-padded chunks instead
    of ~75 sliced dots."""
    k = a8.shape[1]
    if k <= _F32_CHUNK:
        return _slice_dot_f32(a8, b8).astype(jnp.float64)
    n_ch = -(-k // _F32_CHUNK)
    if n_ch <= 4:
        acc = None
        for lo in range(0, k, _F32_CHUNK):
            hi = min(k, lo + _F32_CHUNK)
            p = _slice_dot_f32(a8[:, lo:hi],
                               b8[lo:hi, :]).astype(jnp.float64)
            acc = p if acc is None else acc + p
        return acc
    m, n = a8.shape[0], b8.shape[1]
    kp = n_ch * _F32_CHUNK
    a_p = jnp.pad(a8, ((0, 0), (0, kp - k)))
    b_p = jnp.pad(b8, ((0, kp - k), (0, 0)))
    a3 = jnp.transpose(a_p.reshape(m, n_ch, _F32_CHUNK), (1, 0, 2))
    b3 = b_p.reshape(n_ch, _F32_CHUNK, n)
    c = jax.lax.dot_general(a3, b3, (((2,), (1,)), ((0,), (0,))),
                            preferred_element_type=jnp.float32)
    return c.astype(jnp.float64).sum(axis=0)


def _scale_outer(acc, ea, eb):
    """``acc * 2**(ea ⊕ eb)`` for exponents that are per-row/col vectors
    (shape (M,)/(N,)) or global scalars (0-d, from :func:`slice_tensor`)."""
    ea = ea[:, None] if ea.ndim == 1 else ea
    eb = eb[None, :] if eb.ndim == 1 else eb
    return acc * _pow2(ea + eb)


# below this many columns (rows), the N-stacked (M-stacked) fast path is
# used: the big stationary operand's slices are read ONCE each instead of
# once per diagonal pair — the slice-pair loop is bandwidth-bound on the
# big operand (measured 7.0 -> ~3 ms for the nP=123 ladder)
_STACK_MAX = 4096


def matmul_presliced(sa, ea, sb, eb, t_cutoff):
    """f64 C = A @ B from pre-sliced operands.

    ``sa``: (S, M, K) bf16-carried slices, ``ea``: (M,) int32 row
    exponents of A; ``sb``: (S, K, N), ``eb``: (N,) column exponents.

    When one free dimension is small (CC amplitudes: N or M = no² ≪ nv²),
    the small operand's slices are stacked along that dimension and the
    big operand's slices each enter ONE matmul — all S² slice pairs
    are then reconstructed (a superset of the requested ``t_cutoff``
    diagonals, so accuracy is ≥ the pair-loop path), with the big slices
    read once each instead of once per diagonal.
    """
    n_slices = sa.shape[0]
    t_max = min(int(t_cutoff), 2 * n_slices - 2)

    m_dim, n_dim = sa.shape[1], sb.shape[2]
    if n_dim * n_slices <= _STACK_MAX and n_dim <= m_dim:
        # stationary A: B slices stacked along N — each A slice is read
        # ONCE (the pair loop re-reads the big operand per diagonal)
        b_cat = jnp.concatenate(list(sb), axis=1)     # (K, S*N)
        acc = None
        for i in range(n_slices):
            c = _pair_dot(sa[i], b_cat)
            c = c.reshape(m_dim, n_slices, n_dim)
            scale = jnp.asarray(
                [2.0 ** (-SLICE_BITS * (i + j + 2))
                 for j in range(n_slices)], jnp.float64)
            term = (c * scale[None, :, None]).sum(axis=1)
            acc = term if acc is None else acc + term
        return _scale_outer(acc, ea, eb)
    if m_dim * n_slices <= _STACK_MAX and m_dim < n_dim:
        # stationary B: A slices stacked along M
        a_cat = sa.reshape(n_slices * m_dim, sa.shape[2])
        acc = None
        for j in range(n_slices):
            c = _pair_dot(a_cat, sb[j])
            c = c.reshape(n_slices, m_dim, n_dim)
            scale = jnp.asarray(
                [2.0 ** (-SLICE_BITS * (i + j + 2))
                 for i in range(n_slices)], jnp.float64)
            term = (c * scale[:, None, None]).sum(axis=0)
            acc = term if acc is None else acc + term
        return _scale_outer(acc, ea, eb)

    acc = None
    for d in range(t_max + 1):
        pairs = [(i, d - i)
                 for i in range(max(0, d - n_slices + 1),
                                min(d, n_slices - 1) + 1)]
        if len(pairs) == 1:
            dmat = _pair_dot(sa[pairs[0][0]], sb[pairs[0][1]])
        else:
            # fuse the whole diagonal into ONE dot by concatenating the
            # participating slices along K: per-chunk f32 sums stay exact
            # across pair boundaries (products <= 63^2, <= _F32_CHUNK of
            # them < 2^24), and the f64 accumulation traffic drops from
            # one output-sized add per PAIR to one per K-chunk
            a_cat = jnp.concatenate([sa[i] for i, _ in pairs], axis=1)
            b_cat = jnp.concatenate([sb[j] for _, j in pairs], axis=0)
            dmat = _pair_dot(a_cat, b_cat)
        term = dmat * (2.0 ** (-SLICE_BITS * (d + 2)))
        acc = term if acc is None else acc + term
    return _scale_outer(acc, ea, eb)


@partial(jax.jit, static_argnames=("n_slices", "t_cutoff"))
def matmul(a, b, n_slices=9, t_cutoff=9):
    """f64-accurate C = A @ B with all multiplies as Ozaki slice products."""
    sa, ea = slice_rows(a, n_slices)
    sb, eb = slice_cols(b, n_slices)
    return matmul_presliced(sa, ea, sb, eb, t_cutoff)


# ---------------------------------------------------------------------------
# two-operand einsum adapter
# ---------------------------------------------------------------------------

def _plan(spec, a_shape, b_shape):
    ins, out = spec.replace(" ", "").split("->")
    sa, sb = ins.split(",")
    if len(set(sa)) != len(sa) or len(set(sb)) != len(sb):
        raise ValueError(f"repeated index within an operand: {spec}")
    contracted = [c for c in sa if c in sb and c not in out]
    batch = [c for c in sa if c in sb and c in out]
    free_a = [c for c in sa if c not in sb]
    free_b = [c for c in sb if c not in sa]
    if set(out) != set(batch + free_a + free_b):
        raise ValueError(f"output indices do not match inputs: {spec}")
    dim = {}
    for c, n in list(zip(sa, a_shape)) + list(zip(sb, b_shape)):
        if dim.setdefault(c, n) != n:
            raise ValueError(f"dimension mismatch for '{c}' in {spec}")
    return sa, sb, out, batch, free_a, free_b, contracted, dim


def _transpose_grouped(x, perm):
    """``jnp.transpose(x, perm)`` via maximal contiguous runs: collapse
    each run of consecutive source axes with ``reshape`` (free), transpose
    the collapsed dims, reshape back.  A 4-D transpose whose output
    carries tiny trailing axes materializes in the (8, 128)-tiled layout
    at up to ~20× padding (e.g. ``ijcd->cdij`` at no=7); the collapsed
    2-D form pads only the last run."""
    runs = [[perm[0]]]
    for p in perm[1:]:
        if p == runs[-1][-1] + 1:
            runs[-1].append(p)
        else:
            runs.append([p])
    if len(runs) == len(perm):
        return jnp.transpose(x, perm)
    # collapse: source order of the runs
    src_order = sorted(range(len(runs)), key=lambda r: runs[r][0])
    collapsed = [int(np.prod([x.shape[ax] for ax in runs[r]]))
                 for r in src_order]
    y = x.reshape(collapsed)
    y = jnp.transpose(y, [src_order.index(r) for r in range(len(runs))])
    return y.reshape([x.shape[ax] for r in runs for ax in r])


def _as_matrix_slices(op, idx, groups, n_slices, is_left):
    """Bring one einsum operand into (S, rows, cols) sliced form.

    ``op`` is either a plain f64 array (sliced here, per-row/col scales)
    or a ``(slices, e)`` pair from :func:`slice_tensor` (global scale —
    the stack is transposed in bf16, ~4× cheaper than transposing f64
    and re-running the trunc chain).
    """
    rows, cols = groups
    if isinstance(op, tuple):
        s, e = op
        perm = [0] + [1 + idx.index(c) for c in rows + cols]
        st = _transpose_grouped(s, perm)
        m = int(np.prod([s.shape[1 + idx.index(c)] for c in rows],
                        initial=1))
        k = int(np.prod([s.shape[1 + idx.index(c)] for c in cols],
                        initial=1))
        return st.reshape(s.shape[0], m, k), e
    t = _transpose_grouped(op, [idx.index(c) for c in rows + cols])
    m = int(np.prod([op.shape[idx.index(c)] for c in rows], initial=1))
    k = int(np.prod([op.shape[idx.index(c)] for c in cols], initial=1))
    t = t.reshape(m, k)
    return slice_rows(t, n_slices) if is_left else slice_cols(t, n_slices)


def einsum2_sliced(spec, a, b, n_slices=9, t_cutoff=9):
    """``jnp.einsum(spec, a, b)`` where either operand may arrive
    pre-sliced (a ``(slices, e)`` pair from :func:`slice_tensor`).

    This is the shared-slice entry point for the CC residual engines:
    loop-invariant integral blocks are sliced ONCE at setup and the
    amplitudes ONCE per iteration — the per-contraction trunc chain
    (as expensive as the GEMM itself)
    disappears from the hot path.  No batch indices (none occur in the
    residuals); falls back to :func:`einsum2` semantics otherwise.
    """
    a_shape = a[0].shape[1:] if isinstance(a, tuple) else a.shape
    b_shape = b[0].shape[1:] if isinstance(b, tuple) else b.shape
    sa_idx, sb_idx, out, batch, fa, fb, con, dim = _plan(spec, a_shape,
                                                         b_shape)
    if batch:
        raise NotImplementedError(
            f"einsum2_sliced does not support batch indices: {spec}")
    # a plain operand is sliced to the same depth as its pre-sliced
    # partner (matmul_presliced pairs slices index-by-index)
    for op in (a, b):
        if isinstance(op, tuple):
            n_slices = op[0].shape[0]
    sa, ea = _as_matrix_slices(a, sa_idx, (fa, con), n_slices, True)
    sb, eb = _as_matrix_slices(b, sb_idx, (con, fb), n_slices, False)
    c = matmul_presliced(sa, ea, sb, eb, t_cutoff)
    c = c.reshape([dim[ch] for ch in fa + fb])
    order = [(fa + fb).index(ch) for ch in out]
    return _transpose_grouped(c, order)


def einsum2(spec, a, b, n_slices=9, t_cutoff=9):
    """``jnp.einsum(spec, a, b)`` computed through the Ozaki matmul.

    Handles any single-contraction spec (batch indices via ``jax.vmap``).
    """
    sa, sb, out, batch, fa, fb, con, dim = _plan(spec, a.shape, b.shape)
    szb = [dim[c] for c in batch]
    m = int(np.prod([dim[c] for c in fa], initial=1))
    k = int(np.prod([dim[c] for c in con], initial=1))
    n = int(np.prod([dim[c] for c in fb], initial=1))

    at = _transpose_grouped(a, [sa.index(c) for c in batch + fa + con])
    bt = _transpose_grouped(b, [sb.index(c) for c in batch + con + fb])
    at = at.reshape(szb + [m, k])
    bt = bt.reshape(szb + [k, n])

    f = partial(matmul, n_slices=n_slices, t_cutoff=t_cutoff)
    if batch:
        at = at.reshape([-1, m, k])
        bt = bt.reshape([-1, k, n])
        c = jax.vmap(f)(at, bt)
    else:
        c = f(at, bt)
    c = c.reshape(szb + [dim[ch] for ch in fa + fb])
    order = [(batch + fa + fb).index(ch) for ch in out]
    return jnp.transpose(c, order)
