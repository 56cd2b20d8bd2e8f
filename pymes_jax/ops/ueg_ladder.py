"""Matrix-free particle-particle ladder for the UEG.

The UEG two-body integrals carry momentum-conservation structure:
``V[a,b,c,d] = w(k_c − k_a) · δ(k_a + k_b = k_c + k_d)`` where w is the
(p,r)-only weight of the integral class (Coulomb 4π/q²/Ω, or any of the
hermitian TC classes — everything except the non-hermitian rs-dependent
term).  The pp-ladder contraction therefore collapses from a dense
O(nv⁴·no²) matmul over an nv⁴ tensor (16 GB at nP=219!) to

``R_abij = Σ_q w(q) · T[c(a,q), d(b,q), i, j]``

a weighted gather-sum over the ~nq distinct momentum transfers —
O(nq·nv²·no²) flops and **no nv⁴ storage**, which the reference's dense
CTF contraction cannot reach: the loop over q is a
``lax.scan`` of masked gathers, bandwidth-bound on the (small) T2 tensor.

Exact against the dense ladder for the generated integral classes
(``tests/test_ueg_ladder.py``).
"""

from functools import partial
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp


class UEGLadder(NamedTuple):
    """Precomputed gather plan: for each transfer q, the virtual-orbital
    images c(a,q), d(b,q) (−1 = leaves the basis) and the weight w(q)."""

    C: jnp.ndarray   # (nq, nv) int32
    D: jnp.ndarray   # (nq, nv) int32
    w: jnp.ndarray   # (nq,) float


def _transfer_weights(ueg_model, q_vecs, correlator=None, **integral_flags):
    """w(q) for the transfer-only integral classes (Coulomb, RPA-approx,
    hermitian-TC) on integer transfer vectors ``q_vecs`` (n, 3)."""
    from pymes_jax.models.ueg import _call_correlator

    qp = q_vecs * 2.0 * np.pi / ueg_model.L
    q2 = np.einsum("nx,nx->n", qp, qp)
    with np.errstate(divide="ignore"):
        coul = np.where(q2 > 0, 4.0 * np.pi / np.where(q2 > 0, q2, 1.0),
                        0.0)
    if correlator is None and not integral_flags:
        return coul / ueg_model.Omega
    if integral_flags.get("is_rpa_approx"):
        u = _call_correlator(correlator, q2, scalar_path=True)
        return np.where(
            q2 > 0, -ueg_model.n_ele * q2 * u ** 2 / ueg_model.Omega ** 2,
            0.0)
    if integral_flags.get("is_only_hermi_2b"):
        # Coulomb + Σ∇u·∇u convolution + q²u(q²): all transfer-only
        u = _call_correlator(correlator, q2, scalar_path=True)
        ueg_model.correlator = correlator
        u_mat = ueg_model._sum_nabla_u_squared(
            q_vecs.reshape(-1, 1, 3), None).reshape(-1)
        return np.where(q2 > 0, (coul + u_mat + q2 * u) / ueg_model.Omega,
                        u_mat / ueg_model.Omega)
    raise NotImplementedError(
        "gather plans support the Coulomb, RPA-approx and hermitian-TC "
        "integral classes (transfer-only weights); for the non-hermitian "
        "classes use build_block_ladder, whose sector blocks carry the "
        "(c,d)-dependent term")


def _nh_flags(integral_flags):
    """Split the integral flags of a NON-HERMITIAN class into the
    transfer-only base class + a marker to add the −(kp_c−kp_d)·q·u(q²)/Ω
    sector term (reference ``pymes/model/ueg.py:441-470``, the rs-dependent
    term; VERDICT r2 task 6).  Returns (base_flags | None, needs_nh)."""
    f = dict(integral_flags)
    if f.pop("is_only_2b", False):
        # hermitian base (coul + Σ∇u·∇u + q²u) + the nh term
        f["is_only_hermi_2b"] = True
        return f, True
    if f.pop("is_only_non_hermi_2b", False):
        # coulomb base + the nh term (matches eval_2b_integrals: at q=0
        # the class value is 0)
        return (f or None), True
    return integral_flags, False


def _sector_nh(ueg_model, tvec_int, kcd_int, correlator):
    """Non-hermitian sector term ``nh[i,j] = −(kp_c−kp_d)·q·u(q²)/Ω`` with
    q = tvec (the transfer k_c − k_p of the (bra_i, ket_j) element) and
    (kp_c − kp_d) of ket pair j.  Twist shifts cancel in both differences,
    so integer k arithmetic is exact."""
    from pymes_jax.models.ueg import _call_correlator

    two_pi_L = 2.0 * np.pi / ueg_model.L
    qv = tvec_int * two_pi_L                        # (mB_, mK_, 3)
    q2 = np.einsum("ijx,ijx->ij", qv, qv)
    u = _call_correlator(correlator, q2, scalar_path=True)
    cd = kcd_int * two_pi_L                          # (mK_, 3)
    return -np.einsum("jx,ijx->ij", cd, qv) * u / ueg_model.Omega


class OVVVPlan(NamedTuple):
    """Gather plan for ``out[p,q,r,j] = Σ_s V[p,q,r,s] T1[s,j]`` on a
    momentum-structured block whose LAST axis is virtual.

    ``V[p,q,r,s] = w(k_r − k_p) δ(k_p+k_q = k_r+k_s)`` fixes s given
    (p,q,r): ``S[p,q,r]`` is its virtual index (−1 = outside the basis)
    and ``W[p,r] = w(k_r − k_p)``.  This removes every nv³no-sized ovvv
    block from the matrix-free CCSD path — their only uses contract a T1
    factor first (VERDICT r1 task 6: three resident ovvv blocks ran
    nP=219 out of memory)."""

    S: jnp.ndarray   # (n0, n1, n2) int32 — virtual index of k_p+k_q−k_r
    W: jnp.ndarray   # (n0, n2) float — w(k_r − k_p)


def build_ovvv_t1_plan(ueg_model, ranges, correlator=None,
                       dtype=np.float64, **integral_flags):
    """Build an :class:`OVVVPlan` for leading-axis orbital ``ranges``
    (3-char string of 'o'/'v'/'a'); the contracted 4th axis is virtual."""
    no = ueg_model.n_ele // 2
    n_p = ueg_model.n_spatial
    k_int = ueg_model.basis.k_int
    sel = {"o": k_int[:no], "v": k_int[no:], "a": k_int}
    k0, k1, k2 = (sel[c] for c in ranges)

    ksum = (k0[:, None, None, :] + k1[None, :, None, :]
            - k2[None, None, :, :])
    S = ueg_model._lookup_flat(ksum)
    S = np.where(S >= no, S - no, -1)

    d = (k2[None, :, :] - k0[:, None, :]).reshape(-1, 3)
    q_vecs, inv = np.unique(d, axis=0, return_inverse=True)
    w = _transfer_weights(ueg_model, q_vecs, correlator, **integral_flags)
    W = w[inv].reshape(len(k0), len(k2))
    return OVVVPlan(S=jnp.asarray(S, dtype=jnp.int32),
                    W=jnp.asarray(W, dtype=dtype))


def ovvv_t1_apply(plan: OVVVPlan, T1):
    """``out[p,q,r,j] = Σ_s V[p,q,r,s] T1[s,j]`` via the gather plan."""
    T1 = jnp.asarray(T1)
    nv = T1.shape[0]
    Tg = T1[jnp.clip(plan.S, 0, nv - 1)]          # (n0, n1, n2, no)
    Tg = jnp.where((plan.S >= 0)[..., None], Tg, 0.0)
    return Tg * plan.W[:, None, :, None]


def ovvv_t1_apply_j(plan: OVVVPlan, T1):
    """Occupied-leading variant: ``out[j,p,q,r] = Σ_s V[p,q,r,s] T1[s,j]``.

    Gathering rows of length no=7 into a TRAILING axis makes the
    innermost dimension tiny; with j leading, the gather runs along the
    last axis of ``T1.T`` and the big orbital dims stay trailing.
    Chain-style consumers (the T1 dressing) are layout-agnostic."""
    T1 = jnp.asarray(T1)
    nv = T1.shape[0]
    S = plan.S
    flat = jnp.clip(S, 0, nv - 1).ravel()
    Tg = jnp.take(T1.T, flat, axis=1).reshape((T1.shape[1],) + S.shape)
    Tg = jnp.where((S >= 0)[None], Tg, 0.0)
    return Tg * plan.W[None, :, None, :]


def build_ueg_ladder(ueg_model, correlator=None, dtype=np.float64,
                     bra="virtual", **integral_flags):
    """Build the ladder plan from a UEG model.

    The weights are taken from the same vectorized integral engine as the
    dense path (so every (p,r)-structured integral class is supported);
    transfers with all-invalid images are pruned.

    ``bra="virtual"`` builds the plain pp-ladder plan (images of virtual
    orbitals); ``bra="all"`` spans all orbitals on the bra side — the plan
    needed for the T1-*dressed* ladder of CCSD
    (:func:`dressed_ladder_apply`), whose W intermediate carries occupied
    bra indices.
    """
    no = ueg_model.n_ele // 2
    n_p = ueg_model.n_spatial
    nv = n_p - no
    k_int = ueg_model.basis.k_int
    k_bra = k_int if bra == "all" else k_int[no:]

    # distinct transfers q = k_c − k_p over (bra, virtual) pairs
    d_int = (k_int[None, no:, :] - k_bra[:, None, :]).reshape(-1, 3)
    q_vecs, _ = np.unique(d_int, axis=0, return_inverse=True)

    # weights from the integral engine: transfer-only for the supported
    # classes (shared with the ovvv-gather plans)
    w = _transfer_weights(ueg_model, q_vecs, correlator, **integral_flags)

    # gather images: c(p, q) = lookup(k_p + q) − no (virtual index), and
    # d(p', q) = lookup(k_p' − q) − no
    C = ueg_model._lookup_flat(k_bra[None, :, :] + q_vecs[:, None, :])
    D = ueg_model._lookup_flat(k_bra[None, :, :] - q_vecs[:, None, :])
    C = np.where(C >= no, C - no, -1)     # images must be virtual (c, d)
    D = np.where(D >= no, D - no, -1)

    keep = ~((C < 0).all(axis=1) | (D < 0).all(axis=1) | (w == 0.0))
    return UEGLadder(C=jnp.asarray(C[keep], dtype=jnp.int32),
                     D=jnp.asarray(D[keep], dtype=jnp.int32),
                     w=jnp.asarray(w[keep], dtype=dtype))


def ueg_ladder_apply(ladder: UEGLadder, T_abij, chunk=1):
    """R_abij = Σ_q w(q) T[c(a,q), d(b,q), i, j] via a scan over chunks of
    transfers, each chunk a vmapped masked gather.

    The op is gather-bandwidth-bound, so the default stays at the simple
    per-q scan (chunk=1)."""
    T_abij = jnp.asarray(T_abij)
    nv = T_abij.shape[0]
    nq = ladder.w.shape[0]
    pad = (-nq) % chunk
    w = jnp.pad(ladder.w, (0, pad))
    C = jnp.pad(ladder.C, ((0, pad), (0, 0)), constant_values=-1)
    D = jnp.pad(ladder.D, ((0, pad), (0, 0)), constant_values=-1)
    n_bra = ladder.C.shape[1]
    w = w.reshape(-1, chunk)
    C = C.reshape(-1, chunk, n_bra)
    D = D.reshape(-1, chunk, n_bra)

    def one_q(w_q, c_q, d_q):
        valid = ((c_q >= 0)[:, None] & (d_q >= 0)[None, :])
        Tg = T_abij[jnp.clip(c_q, 0, nv - 1)][:, jnp.clip(d_q, 0, nv - 1)]
        return w_q * jnp.where(valid[:, :, None, None], Tg, 0.0)

    def step(acc, qcd):
        w_c, c_c, d_c = qcd
        contrib = jax.vmap(one_q)(w_c, c_c, d_c)
        return acc + contrib.sum(axis=0), None

    # output bra dims follow the plan (nv for the plain ladder, nb for the
    # all-bra plan of the dressed ladder)
    out_shape = (C.shape[-1], D.shape[-1]) + T_abij.shape[2:]
    acc0 = jnp.zeros(out_shape, T_abij.dtype)
    out, _ = jax.lax.scan(step, acc0, (w, C, D))
    return out


def ueg_ladder_apply_ij(ladder: UEGLadder, T_ijab, chunk=1):
    """Occupied-leading variant: ``R_ijab = Σ_q w(q) T[i,j,c(a,q),d(b,q)]``.

    Same math as :func:`ueg_ladder_apply` with T2 carried as
    ``T[i,j,a,b]`` (trailing axes virtual, so the per-step accumulator's
    innermost dimensions are the large ones)."""
    T = jnp.asarray(T_ijab)
    nv = T.shape[-1]
    nq = ladder.w.shape[0]
    pad = (-nq) % chunk
    w = jnp.pad(ladder.w, (0, pad)).reshape(-1, chunk)
    n_bra = ladder.C.shape[1]
    C = jnp.pad(ladder.C, ((0, pad), (0, 0)),
                constant_values=-1).reshape(-1, chunk, n_bra)
    D = jnp.pad(ladder.D, ((0, pad), (0, 0)),
                constant_values=-1).reshape(-1, chunk, n_bra)

    def one_q(w_q, c_q, d_q):
        valid = (c_q >= 0)[:, None] & (d_q >= 0)[None, :]
        Tg = T[:, :, jnp.clip(c_q, 0, nv - 1), :]
        Tg = Tg[:, :, :, jnp.clip(d_q, 0, nv - 1)]
        return w_q * jnp.where(valid[None, None], Tg, 0.0)

    def step(acc, qcd):
        w_c, c_c, d_c = qcd
        return acc + jax.vmap(one_q)(w_c, c_c, d_c).sum(axis=0), None

    out_shape = T.shape[:2] + (n_bra, n_bra)
    acc0 = jnp.zeros(out_shape, T.dtype)
    out, _ = jax.lax.scan(step, acc0, (w, C, D))
    return out


class BlockGroup(NamedTuple):
    """One padded-size bucket of total-momentum sectors."""

    blocks: jnp.ndarray    # (nS, mB, mK) — V values, 0 on padding
    perm_ket: jnp.ndarray  # (nS, mK) int32 — ket-pair flat ids (pad→0)


class BlockLadder(NamedTuple):
    """Momentum-block-diagonal ladder plan.

    ``V[p,q,c,d] = w(k_c − k_p) δ(k_p+k_q = k_c+k_d)`` is block-diagonal
    in the total momentum K = k_p+k_q: the ladder contraction is a set of
    small DENSE matmuls ``R_K = V_K · T_K`` over the pair sectors — the
    matmul-shaped form of what :func:`ueg_ladder_apply` does as nq masked
    gathers (which are bound by gather bandwidth).
    Sectors are bucketed by padded (m_bra, m_ket) so each bucket is one
    batched matmul; every bra pair lands in exactly one sector, so the
    scatter back is a gather through ``inv_bra`` (a permutation with a
    trailing zero-column for bra pairs whose K has no ket pair).
    """

    groups: tuple        # of BlockGroup
    inv_bra: jnp.ndarray  # (n_bra^2,) int32 into concat-R columns
    n_bra: int
    nv: int
    w0: float = 0.0      # zero-transfer weight w(q=0) (diagonal V_abab)
    presliced: object = None  # optional ozaki int8 slices of the sector
    #   blocks (see preslice_block_ladder) — when present, the apply
    #   functions run the sector matmuls as bf16 slice products (f64-exact
    #   at 9 slices)


def _pad_to(m, schedule="fine"):
    """Bucket size for a sector dimension.

    ``"fine"`` (default): multiples of 8 up to 64, of 16 up to 128, of 32
    up to 256, of 64 above — measured padded-work ratio 1.19× at nP=219
    (vs 2.01× for ``"pow2"``), at the cost of ~3× more bucket shapes
    (23 vs 8).  The padding inflates BOTH the sector GEMMs and the
    gather/scatter traffic, so it lands directly on the mf-CCSD
    batched-ladder wall (VERDICT r4 task 6).  ``"pow2"``: next power of
    two, minimum 8.  Both schedules are open to re-derivation for the
    GPU's GEMM tiles.
    """
    if schedule == "pow2":
        p = 8
        while p < m:
            p *= 2
        return p
    if m <= 8:
        return 8
    step = 8 if m <= 64 else 16 if m <= 128 else 32 if m <= 256 else 64
    return -(-m // step) * step


def build_block_ladder(ueg_model, correlator=None, dtype=np.float64,
                       bra="virtual", preslice=None, pad_sectors=1,
                       pad="fine", **integral_flags):
    """Build a :class:`BlockLadder` (exact vs the dense block,
    ``tests/test_ueg_ladder.py``).

    Weight classes: everything :func:`build_ueg_ladder` supports PLUS the
    non-hermitian TC classes (``is_only_2b``, ``is_only_non_hermi_2b``) —
    the rs-dependent term −(kp_c−kp_d)·q·u(q²)/Ω is not transfer-only, but
    within a total-momentum sector it is a plain function of the (bra,
    ket-pair) element, so it lands in the dense sector blocks at build
    time with zero extra apply cost (VERDICT r2 task 6; reference keeps
    this class dense-only, ``pymes/model/ueg.py:441-470``).

    ``preslice`` (int or None): attach ozaki slices of the sector blocks
    so applications run the sector matmuls through the sliced bf16 path;
    9 slices reconstruct full f64.  ``None`` (default) keeps plain f64
    batched matmuls.

    ``pad_sectors``: round every bucket's sector count up to a multiple
    (with zero blocks), so the sector axis divides a device-mesh axis —
    see :func:`shard_block_ladder`.

    ``pad`` ("fine" | "pow2"): sector padding schedule — see
    :func:`_pad_to`.
    """
    no = ueg_model.n_ele // 2
    n_p = ueg_model.n_spatial
    nv = n_p - no
    k_int = np.asarray(ueg_model.basis.k_int)
    k_ket = k_int[no:]
    k_bra = k_int if bra == "all" else k_int[no:]
    n_bra = len(k_bra)

    # total-momentum keys of every bra / ket pair
    span = 2 * int(np.abs(k_int).max()) + 1

    def enc(K):
        off = K + (span // 2) * 2  # guard: K in [-2 kmax, 2 kmax]
        return (off[..., 0] * (2 * span) + off[..., 1]) * (2 * span) \
            + off[..., 2]

    K_ket = enc((k_ket[:, None, :] + k_ket[None, :, :]).reshape(-1, 3))
    K_bra = enc((k_bra[:, None, :] + k_bra[None, :, :]).reshape(-1, 3))

    # weight table over the transfer cube t = k_c − k_p.  Non-hermitian TC
    # classes split into a transfer-only base + the (c,d)-dependent nh
    # sector term added below (VERDICT r2 task 6).
    base_flags, needs_nh = _nh_flags(integral_flags)
    tmax = int(np.abs(k_ket[:, None, :] - k_bra[None, :, :]).max())
    grid = np.arange(-tmax, tmax + 1)
    T3 = np.stack(np.meshgrid(grid, grid, grid, indexing="ij"),
                  axis=-1).reshape(-1, 3)
    wtab = _transfer_weights(ueg_model, T3,
                             None if (needs_nh and not base_flags)
                             else correlator,
                             **(base_flags or {})).reshape(
        2 * tmax + 1, 2 * tmax + 1, 2 * tmax + 1)

    def w_of(tvec):
        i = tvec + tmax
        return wtab[i[..., 0], i[..., 1], i[..., 2]]

    # sector membership
    order_k = np.argsort(K_ket, kind="stable")
    keys_k, starts_k = np.unique(K_ket[order_k], return_index=True)
    order_b = np.argsort(K_bra, kind="stable")
    keys_b, starts_b = np.unique(K_bra[order_b], return_index=True)
    ends_k = np.append(starts_k[1:], len(order_k))
    ends_b = np.append(starts_b[1:], len(order_b))
    pos_b = {k: i for i, k in enumerate(keys_b)}

    buckets = {}
    sector_list = []
    for si, key in enumerate(keys_k):
        ket_ids = order_k[starts_k[si]:ends_k[si]]
        bi = pos_b[key]  # ket pairs ⊆ bra pairs for both bra modes
        bra_ids = order_b[starts_b[bi]:ends_b[bi]]
        mB, mK = _pad_to(len(bra_ids), pad), _pad_to(len(ket_ids), pad)
        buckets.setdefault((mB, mK), []).append((bra_ids, ket_ids))
        sector_list.append((mB, mK, len(buckets[(mB, mK)]) - 1))

    # assemble groups + global output-column offsets
    groups = []
    offsets = {}
    col0 = 0
    inv_bra = np.full(n_bra * n_bra, -1, np.int64)
    for (mB, mK), secs in sorted(buckets.items()):
        nS = -(-len(secs) // int(pad_sectors)) * int(pad_sectors)
        blocks = np.zeros((nS, mB, mK), dtype)
        perm_ket = np.zeros((nS, mK), np.int32)
        for t, (bra_ids, ket_ids) in enumerate(secs):
            nb_, nk_ = len(bra_ids), len(ket_ids)
            tvec = (k_ket[ket_ids // nv][None, :, :]
                    - k_bra[bra_ids // n_bra][:, None, :])
            blocks[t, :nb_, :nk_] = w_of(tvec)
            if needs_nh:
                kcd = k_ket[ket_ids // nv] - k_ket[ket_ids % nv]
                blocks[t, :nb_, :nk_] += _sector_nh(ueg_model, tvec, kcd,
                                                    correlator)
            perm_ket[t, :nk_] = ket_ids
            inv_bra[bra_ids] = col0 + t * mB + np.arange(nb_)
        groups.append(BlockGroup(blocks=jnp.asarray(blocks),
                                 perm_ket=jnp.asarray(perm_ket)))
        offsets[(mB, mK)] = col0
        col0 += nS * mB
    inv_bra[inv_bra < 0] = col0  # zero column: bra K with no ket pair
    plan = BlockLadder(groups=tuple(groups),
                       inv_bra=jnp.asarray(inv_bra, dtype=jnp.int32),
                       n_bra=n_bra, nv=nv,
                       w0=float(wtab[tmax, tmax, tmax]))
    if preslice:
        plan = plan._replace(
            presliced=preslice_block_ladder(plan, int(preslice)))
    return plan


def block_ladder_apply_ij(plan: BlockLadder, T_ijab):
    """``R_ijpq = Σ_cd V_pqcd T_ijcd`` with T carried ``[i,j,c,d]`` —
    batched sector matmuls, one output gather.

    Static dims come from array shapes (int NamedTuple fields are pytree
    leaves and trace to scalars under jit)."""
    if plan.presliced is not None:
        return block_ladder_apply_ij_ozaki(plan, T_ijab, plan.presliced)
    T = jnp.asarray(T_ijab)
    no2 = T.shape[0] * T.shape[1]
    nv = T.shape[-1]
    n_bra = int(round(plan.inv_bra.shape[0] ** 0.5))
    T2 = T.reshape(no2, nv * nv)
    cols = [jnp.zeros((no2, 1), T.dtype)]
    for g in plan.groups:
        Tg = jnp.take(T2, g.perm_ket.ravel(), axis=1)
        Tg = Tg.reshape(no2, g.perm_ket.shape[0], g.perm_ket.shape[1])
        Rg = jnp.einsum("nsk,smk->nsm", Tg, g.blocks)
        cols.append(Rg.reshape(no2, -1))
    # concat order must match the builder's offsets (zero col first would
    # shift them) — so put the zero column LAST
    R_all = jnp.concatenate(cols[1:] + cols[:1], axis=1)
    out = jnp.take(R_all, plan.inv_bra, axis=1)
    return out.reshape(T.shape[0], T.shape[1], n_bra, n_bra)


def block_ladder_apply(plan: BlockLadder, T_abij):
    """abij-layout variant: ``R_pqij = Σ_cd V_pqcd T_cdij``."""
    if plan.presliced is not None:
        return block_ladder_apply_ab_ozaki(plan, T_abij)
    T = jnp.asarray(T_abij)
    no2 = T.shape[2] * T.shape[3]
    nv = T.shape[0]
    n_bra = int(round(plan.inv_bra.shape[0] ** 0.5))
    T2 = T.reshape(nv * nv, no2)
    rows = []
    for g in plan.groups:
        Tg = jnp.take(T2, g.perm_ket.ravel(), axis=0)
        Tg = Tg.reshape(g.perm_ket.shape[0], g.perm_ket.shape[1], no2)
        Rg = jnp.einsum("smk,skn->smn", g.blocks, Tg)
        rows.append(Rg.reshape(-1, no2))
    rows.append(jnp.zeros((1, no2), T.dtype))
    R_all = jnp.concatenate(rows, axis=0)
    out = jnp.take(R_all, plan.inv_bra, axis=0)
    return out.reshape(n_bra, n_bra, T.shape[2], T.shape[3])


def preslice_block_ladder(plan: BlockLadder, n_slices=7):
    """Ozaki-preslice every sector block (loop-invariant, once per plan):
    returns a tuple over groups of ``(slices, exps)`` from
    ``vmap(slice_rows)`` over the sector axis.

    Jitted over the group blocks: the eager form ran the ~30-op trunc
    chain op-by-op per group, one dispatch per op."""
    return _preslice_groups(tuple(g.blocks for g in plan.groups),
                            int(n_slices))


@partial(jax.jit, static_argnames=("n_slices",))
def _preslice_groups(group_blocks, n_slices):
    from pymes_jax.ops import ozaki
    return tuple(jax.vmap(lambda b: ozaki.slice_rows(b, n_slices))(blocks)
                 for blocks in group_blocks)


def _block_ozaki_rows(plan, Xs_per_group, no2, dtype, t_cutoff):
    """Shared core: sector matmuls ``C_s = B_s · X_s`` as slice products,
    output gathered through the inverse bra-pair permutation.
    ``Xs_per_group[g]``: (nS, mK, no2) gathered amplitudes."""
    from pymes_jax.ops import ozaki
    rows = []
    for (sb, eb), X in zip(plan.presliced, Xs_per_group):
        sx, ex = jax.vmap(lambda x: ozaki.slice_cols(x, sb.shape[1]))(X)
        C = jax.vmap(lambda a, ea_, b, eb_: ozaki.matmul_presliced(
            a, ea_, b, eb_, t_cutoff=t_cutoff))(sb, eb, sx, ex)
        rows.append(C.reshape(-1, no2))
    rows.append(jnp.zeros((1, no2), dtype))
    R_all = jnp.concatenate(rows, axis=0)
    return jnp.take(R_all, plan.inv_bra, axis=0)           # (n_bra^2, no2)


def block_ladder_apply_ij_ozaki(plan: BlockLadder, T_ijab, presliced=None,
                                t_cutoff=None):
    """ij-layout block ladder with the sector matmuls as Ozaki slice
    products (:mod:`pymes_jax.ops.ozaki`): per sector ``C = B_s · X_s`` with the
    loop-invariant B slices from :func:`preslice_block_ladder` and the
    gathered amplitudes sliced per call.  f64-exact for the default
    slice counts (sector K ≤ a few hundred ≪ the int32 headroom; the
    stacked fast path reconstructs all slice pairs)."""
    if presliced is not None and plan.presliced is None:
        plan = plan._replace(presliced=presliced)
    if t_cutoff is None:
        t_cutoff = 2 * plan.presliced[0][0].shape[1] - 2
    T = jnp.asarray(T_ijab)
    no2 = T.shape[0] * T.shape[1]
    nv = T.shape[-1]
    n_bra = int(round(plan.inv_bra.shape[0] ** 0.5))
    T2 = T.reshape(no2, nv * nv)
    Xs = []
    for g in plan.groups:
        nS, mK = g.perm_ket.shape
        Tg = jnp.take(T2, g.perm_ket.ravel(), axis=1)
        Xs.append(Tg.reshape(no2, nS, mK).transpose(1, 2, 0))
    out = _block_ozaki_rows(plan, Xs, no2, T.dtype, t_cutoff)
    return out.T.reshape(T.shape[0], T.shape[1], n_bra, n_bra)


def block_ladder_apply_ab_ozaki(plan: BlockLadder, T_abij, t_cutoff=None):
    """abij-layout sliced (Ozaki) block ladder (no layout transposes: the
    ket-pair gather runs on axis 0 of the (nv², no²) amplitudes)."""
    if t_cutoff is None:
        t_cutoff = 2 * plan.presliced[0][0].shape[1] - 2
    T = jnp.asarray(T_abij)
    no2 = T.shape[2] * T.shape[3]
    nv = T.shape[0]
    n_bra = int(round(plan.inv_bra.shape[0] ** 0.5))
    T2 = T.reshape(nv * nv, no2)
    Xs = []
    for g in plan.groups:
        nS, mK = g.perm_ket.shape
        Xs.append(jnp.take(T2, g.perm_ket.ravel(),
                           axis=0).reshape(nS, mK, no2))
    out = _block_ozaki_rows(plan, Xs, no2, T.dtype, t_cutoff)
    return out.reshape(n_bra, n_bra, T.shape[2], T.shape[3])


def shard_block_ladder(plan: BlockLadder, mesh, axis="a"):
    """Distribute the plan's sector axis over a mesh axis (the K-sectors
    are independent — CTF's distributed-contraction role for the ladder,
    with zero communication until the output gather).  Build the plan
    with ``pad_sectors = mesh.shape[axis]`` so every bucket divides the
    axis.  The apply functions are unchanged: under ``jit`` GSPMD
    partitions the batched sector matmuls along the sharded axis."""
    from jax.sharding import NamedSharding, PartitionSpec
    sec = NamedSharding(mesh, PartitionSpec(axis))
    rep = NamedSharding(mesh, PartitionSpec())
    groups = tuple(BlockGroup(blocks=jax.device_put(g.blocks, sec),
                              perm_ket=jax.device_put(g.perm_ket, sec))
                   for g in plan.groups)
    presliced = plan.presliced
    if presliced is not None:
        presliced = tuple((jax.device_put(s, sec), jax.device_put(e, sec))
                          for s, e in presliced)
    return plan._replace(groups=groups, presliced=presliced,
                         inv_bra=jax.device_put(plan.inv_bra, rep))


def ladder_apply(plan, T_abij, chunk=1):
    """Dispatch on plan type: gather-scan (:class:`UEGLadder`) or
    momentum-block matmuls (:class:`BlockLadder`), abij layout."""
    if isinstance(plan, BlockLadder):
        return block_ladder_apply(plan, T_abij)
    return ueg_ladder_apply(plan, T_abij, chunk=chunk)


def ladder_apply_ij(plan, T_ijab, chunk=1):
    """Occupied-leading dispatch (see :func:`ladder_apply`)."""
    if isinstance(plan, BlockLadder):
        return block_ladder_apply_ij(plan, T_ijab)
    return ueg_ladder_apply_ij(plan, T_ijab, chunk=chunk)


def build_ovvv_plans(ueg_model, correlator=None, dtype=np.float64,
                     **integral_flags):
    """The three ovvv gather plans the matrix-free CCSD dressing needs
    (leading-range patterns vvo/ovv/vov), keyed for
    ``dict_t_V["_ovvv_plans"]``."""
    return {pat: build_ovvv_t1_plan(ueg_model, pat, correlator,
                                    dtype=dtype, **integral_flags)
            for pat in ("vvo", "ovv", "vov")}


def dressed_ladder_apply_ij(ladder_all: UEGLadder, T_ai, T_ijab, no,
                            W=None):
    """Occupied-leading variant of :func:`dressed_ladder_apply`:
    ``R_ijab = Σ_cd V̄_abcd T_cdij`` with T2 and the result carried as
    ``[i,j,a,b]`` and the all-bra W as ``W[i,j,p,q]``."""
    if W is None:
        W = ladder_apply_ij(ladder_all, T_ijab)
    W_vv = W[:, :, no:, no:]
    W_ov = W[:, :, :no, no:]
    W_vo = W[:, :, no:, :no]
    W_oo = W[:, :, :no, :no]
    T1 = jnp.asarray(T_ai)
    R = W_vv
    R = R - jnp.einsum("ak,ijkb->ijab", T1, W_ov)
    R = R - jnp.einsum("bl,ijal->ijab", T1, W_vo)
    R = R + jnp.einsum("ak,bl,ijkl->ijab", T1, T1, W_oo)
    return R


def dressed_ladder_apply(ladder_all: UEGLadder, T_ai, T_abij, no, W=None):
    """T1-dressed ladder  R_abij = Σ_cd V̄_abcd T_cdij  without building
    V̄_abcd: the bra dressing is rank-1 (Λ = I − T̂, ccsd formalism), so

    ``R = W[v,v] − T1·W[o,v] − W[v,o]·T1 + T1·W[o,o]·T1``

    with ``W_pqij = Σ_cd V_pqcd T_cdij`` from the all-bra gather plan
    (the ket dressing is the identity on the all-virtual ket of abcd).
    ``W`` may be precomputed by the caller (the CCSD iteration reuses it
    for the singles residual).
    """
    if W is None:
        W = ladder_apply(ladder_all, T_abij)
    W_vv = W[no:, no:]
    W_ov = W[:no, no:]
    W_vo = W[no:, :no]
    W_oo = W[:no, :no]
    T1 = jnp.asarray(T_ai)
    R = W_vv
    R = R - jnp.einsum("ak,kbij->abij", T1, W_ov)
    R = R - jnp.einsum("bl,alij->abij", T1, W_vo)
    R = R + jnp.einsum("ak,bl,klij->abij", T1, T1, W_oo)
    return R
