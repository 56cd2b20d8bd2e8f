"""CCD / DCD (+ Brueckner, drCCD dispatch) ground-state solver.

Equation parity with the reference (``pymes/solver/ccd.py:24,164,256``)
including the transcorrelated (non-Hermitian) generality: ``V_ijab`` and
``V_abij`` enter as independent blocks, and the DCD flag drops the quadratic
ring/ladder renormalisation terms (Kats-Manby distinguishable-cluster
approximation).

Architecture (not a port):

* :func:`doubles_residual` is a pure jitted function of (Fock, T2, V-blocks) —
  ~20 einsums XLA fuses and maps onto GEMM libraries; the particle-particle
  ladder ``V_abcd·T_cdij`` (the FLOP hot spot) runs as one matmul (dense),
  or as momentum-sector GEMMs (:mod:`pymes_jax.ops.ueg_ladder`), in plain
  f64 or on the sliced engine (:mod:`pymes_jax.ops.ozaki`) — no custom
  kernels.
* the Jacobi + DIIS iteration is a single ``lax.while_loop`` fixed point
  carried entirely on device (T2, DIIS ring buffer, energy, iteration
  counter); one scalar (converged energy) syncs back to host at the end.
* energies are evaluated with the same direct/exchange split as the
  reference for oracle comparison.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from pymes_jax.log import print_logging_info
from pymes_jax.mixer import diis
from pymes_jax.ops import contract as _ct
from pymes_jax.ops import ozaki
from pymes_jax.ops.contract import contract
from pymes_jax.solver import mp2


class CCDBlocks(NamedTuple):
    """The 7 integral blocks entering the doubles amplitude equation.

    ``ladder`` may replace the dense ``abcd`` with a matrix-free UEG
    gather plan (:mod:`pymes_jax.ops.ueg_ladder`) — set ``abcd=None`` then.
    """

    klij: jnp.ndarray
    ijab: jnp.ndarray
    abij: jnp.ndarray
    iajb: jnp.ndarray
    iabj: jnp.ndarray
    abcd: jnp.ndarray
    iabc: jnp.ndarray = None  # unused by CCD; placeholder for dressing reuse
    ladder: object = None     # optional UEGLadder plan
    ladder_W: object = None   # optional precomputed all-bra W_pqij


def blocks_from_full(no, t_V_pqrs):
    o, v = slice(None, no), slice(no, None)
    return CCDBlocks(
        klij=t_V_pqrs[o, o, o, o],
        ijab=t_V_pqrs[o, o, v, v],
        abij=t_V_pqrs[v, v, o, o],
        iajb=t_V_pqrs[o, v, o, v],
        iabj=t_V_pqrs[o, v, v, o],
        abcd=t_V_pqrs[v, v, v, v],
    )


def blocks_from_dict(dict_t_V):
    return CCDBlocks(klij=dict_t_V["klij"], ijab=dict_t_V["ijab"],
                     abij=dict_t_V["abij"], iajb=dict_t_V["iajb"],
                     iabj=dict_t_V["iabj"], abcd=dict_t_V["abcd"])


@partial(jax.jit, static_argnames=("is_dcd", "is_bruekner", "contract_mode",
                                   "ring_mesh", "ring_axis"))
def doubles_residual(t_fock_ab, t_fock_ij, t_T_abij, blocks: CCDBlocks,
                     is_dcd=False, is_bruekner=False, t_T_ai=None,
                     contract_mode="xla", abcd_presliced=None,
                     ring_mesh=None, ring_axis="a"):
    """CCD/DCD doubles residual R_abij.

    Same diagrams as ``pymes/solver/ccd.py:164``: particle-particle ladder,
    hole-hole ladder (+ its T2 renormalisation unless DCD), ring and
    crossed-ring terms with the spin-adapted 2T−T^x combination, quadratic
    ring terms (unless DCD), and the X_ac/X_ki dressed-Fock contributions —
    symmetrised at the end by P(ab,ij).

    ``contract_mode`` selects the matmul backend for the hot contractions
    (:mod:`pymes_jax.ops.contract`); ``abcd_presliced`` optionally carries
    the loop-invariant Ozaki slices of ``V.abcd`` so the fixed point never
    re-slices the nv⁴ tensor.
    """
    V = blocks
    cm = contract_mode

    def c2(spec, x, y):
        return contract(spec, x, y, mode=cm)

    tilde_T = 2.0 * t_T_abij - jnp.einsum("baij->abij", t_T_abij)

    # hole-hole ladder intermediate (T2-renormalised unless DCD)
    I_klij = V.klij
    if not is_dcd:
        I_klij = I_klij + c2("klcd,cdij->klij", V.ijab, t_T_abij)

    R = V.abij
    R = R + c2("klij,abkl->abij", I_klij, t_T_abij)
    if V.ladder is not None:
        # matrix-free UEG ladder: gather-sum over momentum transfers;
        # with T1 present the plan must be all-bra and the rank-1 bra
        # dressing is applied around the gather (T1-dressed CCSD)
        from pymes_jax.ops.ueg_ladder import (dressed_ladder_apply,
                                              ladder_apply)
        no_ = t_fock_ij.shape[0]
        if t_T_ai is not None:
            R = R + dressed_ladder_apply(V.ladder, t_T_ai, t_T_abij, no_,
                                         W=V.ladder_W)
        else:
            W = ladder_apply(V.ladder, t_T_abij)
            if W.shape[0] != t_T_abij.shape[0]:  # all-bra plan: take vv
                W = W[no_:, no_:]
            R = R + W
    elif ring_mesh is not None:
        # explicit-collective path: V row-sharded, T2 shards ride the ring
        # (ppermute) instead of being all-gathered — CTF's distributed
        # contraction role, now inside the jitted fixed point
        from pymes_jax.parallel.ring_ladder import ring_ladder_inside
        R = R + ring_ladder_inside(V.abcd, t_T_abij, ring_mesh, ring_axis)
    elif abcd_presliced is not None:
        nv, no_ = t_T_abij.shape[1], t_T_abij.shape[3]
        sa, ea = abcd_presliced
        opts = _ct.parse_mode(cm) or (9, 9)
        sb, eb = ozaki.slice_cols(
            t_T_abij.reshape(nv * nv, no_ * no_), sa.shape[0])
        W = ozaki.matmul_presliced(sa, ea, sb, eb, t_cutoff=opts[1])
        R = R + W.reshape(nv, nv, no_, no_)
    else:
        R = R + jnp.einsum("abcd,cdij->abij", V.abcd, t_T_abij)  # pp ladder

    if not is_dcd:
        X_alcj = c2("klcd,adkj->alcj", V.ijab, t_T_abij)
        R = R + c2("alcj,cbil->abij", X_alcj, t_T_abij)

    # quadratic ring with spin-adapted amplitudes
    X_cbkj = c2("klcd,dblj->cbkj", V.ijab, tilde_T)
    R = R + c2("acik,cbkj->abij", tilde_T, X_cbkj)

    # dressed one-particle intermediates; the reference applies the ±1/2
    # T~·V term once as the base dressing and once more in the non-DCD
    # branch (net factor 1 for CCD, 1/2 for DCD, 0 for Brueckner)
    coeff = (0.0 if is_bruekner else 0.5) + (0.0 if is_dcd else 0.5)
    X_ac = t_fock_ab - coeff * c2("adkl,lkdc->ac", tilde_T, V.ijab)
    X_ki = t_fock_ij + coeff * c2("cdil,lkdc->ki", tilde_T, V.ijab)

    Ex = c2("ac,cbij->abij", X_ac, t_T_abij)
    Ex = Ex - c2("ki,abkj->abij", X_ki, t_T_abij)
    Ex = Ex - c2("kaic,cbkj->abij", V.iajb, t_T_abij)
    Ex = Ex - c2("kbic,ackj->abij", V.iajb, t_T_abij)
    Ex = Ex + c2("acik,kbcj->abij", tilde_T, V.iabj)

    if not is_dcd:
        X_alci = c2("klcd,daki->alci", V.ijab, t_T_abij)
        Ex = Ex - c2("alci,cblj->abij", X_alci, t_T_abij)
        Ex = Ex + c2("alci,bclj->abij", X_alci, t_T_abij)

    R = R + Ex + jnp.einsum("abij->baji", Ex)  # P(ab,ij) symmetrisation
    return R


class CCDBlocksIJ(NamedTuple):
    """Loop-invariant blocks pre-permuted for the occupied-leading layout.

    Every in-loop operand/temporary is kept in ``[occ..., vir...]``
    order (T2 carried as ``T[i,j,a,b]``), so the innermost axes are the
    large virtual ones rather than occupied ones of size no≈7 (whether
    this beats the ``abij`` order on a GPU is an open design item).
    Built once outside the ``while_loop`` by :func:`blocks_ij_from`.
    """

    klij: jnp.ndarray    # V[k,l,i,j] (all-occupied, unchanged)
    ijab: jnp.ndarray    # V[i,j,a,b] (already occ-leading)
    ijab_x: jnp.ndarray  # V[i,j,b,a] (exchange image, for the energy)
    abij_t: jnp.ndarray  # V[a,b,i,j] -> [i,j,a,b]
    ikac: jnp.ndarray    # V_iajb[k,a,i,c] -> [i,k,a,c]
    kjcb: jnp.ndarray    # V_iabj[k,b,c,j] -> [k,j,c,b]
    abcd: jnp.ndarray    # dense ladder block (may be None with presliced)
    ladder: object = None    # optional matrix-free UEGLadder plan
    ladder_W: object = None  # optional precomputed all-bra W[i,j,p,q]
    ladder_presliced: object = None  # optional ozaki slices of the
    #   BlockLadder sector blocks (preslice_block_ladder)
    sliced: object = None  # optional {"ijab"/"ikac"/"kjcb": slice_tensor}
    #   global-scale ozaki slices of the ring blocks (preslice_ring_blocks)
    ex_half: object = None  # optional extra term for the Ex accumulator,
    #   applied BEFORE the P(ab,ij) symmetrisation — carries the
    #   half-symmetric T1 dressing of the abij block (S with S + P(S) =
    #   full dressing; ccsd.dressed_block(half_symmetric=True)), so the
    #   residual's one symmetrising transpose serves the dressing too


def blocks_ij_from(blocks: CCDBlocks):
    return CCDBlocksIJ(
        klij=blocks.klij,
        ijab=blocks.ijab,
        ijab_x=jnp.transpose(blocks.ijab, (0, 1, 3, 2)),
        abij_t=jnp.transpose(blocks.abij, (2, 3, 0, 1)),
        ikac=jnp.transpose(blocks.iajb, (2, 0, 1, 3)),
        kjcb=jnp.transpose(blocks.iabj, (0, 3, 2, 1)),
        abcd=blocks.abcd,
        ladder=blocks.ladder,
    )


def preslice_ring_blocks(V_ij: CCDBlocksIJ, n_slices):
    """Global-scale ozaki slices of the ring blocks (slice ONCE per solve
    — or once per iteration for T1-dressed blocks — instead of inside
    every contraction; the trunc chain costs as much as the GEMM it
    feeds)."""
    return {"ijab": ozaki.slice_tensor(V_ij.ijab, n_slices),
            "ikac": ozaki.slice_tensor(V_ij.ikac, n_slices),
            "kjcb": ozaki.slice_tensor(V_ij.kjcb, n_slices)}


# engage the shared-slice ring engine only where slicing overhead beats
# the per-contraction dispatch (tiny test problems stay on `contract`)
_SLICED_MIN_OV = 512


@partial(jax.jit, static_argnames=("is_dcd", "is_bruekner", "contract_mode",
                                   "ring_mesh", "ring_axis"))
def doubles_residual_ij(t_fock_ab, t_fock_ij, t_T_ijab, V: CCDBlocksIJ,
                        is_dcd=False, is_bruekner=False, t_T_ai=None,
                        contract_mode="xla", abcd_presliced=None,
                        ring_mesh=None, ring_axis="a"):
    """CCD/DCD doubles residual in the occupied-leading layout.

    Same diagrams as :func:`doubles_residual` (reference
    ``pymes/solver/ccd.py:164``) with every contraction re-indexed so both
    operands and the output carry ``[occ..., vir...]`` axis order
    (virtual axes trailing).  Verified element-exact against the abij form
    (``tests/test_ccd_layout.py``).
    """
    cm = contract_mode

    def c2(spec, x, y):
        return contract(spec, x, y, mode=cm)

    t = t_T_ijab
    tilde = 2.0 * t - jnp.transpose(t, (0, 1, 3, 2))  # 2T - T^(a<->b)

    # shared-slice ring engine: V blocks arrive pre-sliced (or are sliced
    # here once), T/tilde are sliced once and every ring GEMM consumes the
    # stacks directly — transposes happen on bf16 slices, never on f64
    opts = _ct.parse_mode(cm)
    if opts is not None and t.shape[0] * t.shape[2] >= _SLICED_MIN_OV:
        S, tcut = opts
        sl = V.sliced or {}
        Vs = sl.get("ijab") or ozaki.slice_tensor(V.ijab, S)
        Viks = sl.get("ikac") or ozaki.slice_tensor(V.ikac, S)
        Vkjs = sl.get("kjcb") or ozaki.slice_tensor(V.kjcb, S)
        t_s = ozaki.slice_tensor(t, S)
        tilde_s = ozaki.slice_tensor(tilde, S)

        def cs(spec, x, y):
            return ozaki.einsum2_sliced(spec, x, y, n_slices=S,
                                        t_cutoff=tcut)
    else:
        Vs, Viks, Vkjs, t_s, tilde_s = V.ijab, V.ikac, V.kjcb, t, tilde
        cs = c2

    I_klij = V.klij
    if not is_dcd:
        I_klij = I_klij + cs("klcd,ijcd->klij", Vs, t_s)

    R = cs("klij,klab->ijab", I_klij, t_s)
    if V.abij_t is not None:
        R = R + V.abij_t

    # particle-particle ladder: R_ij,ab += T_ij,cd V_ab,cd
    if V.ladder is not None:
        # matrix-free UEG ladder in the occupied-leading layout; with T1
        # present the plan must be all-bra and the rank-1 bra dressing is
        # applied around the gather (T1-dressed CCSD)
        from pymes_jax.ops.ueg_ladder import (block_ladder_apply_ij_ozaki,
                                              dressed_ladder_apply_ij,
                                              ladder_apply_ij)
        no_ = t.shape[0]
        if t_T_ai is not None:
            R = R + dressed_ladder_apply_ij(V.ladder, t_T_ai, t, no_,
                                            W=V.ladder_W)
        elif V.ladder_presliced is not None:
            opts = _ct.parse_mode(cm) or (9, 9)
            W = block_ladder_apply_ij_ozaki(V.ladder, t, V.ladder_presliced,
                                            t_cutoff=opts[1])
            if W.shape[-1] != t.shape[-1]:  # all-bra plan: take vv corner
                W = W[:, :, no_:, no_:]
            R = R + W
        else:
            W = ladder_apply_ij(V.ladder, t)
            if W.shape[-1] != t.shape[-1]:  # all-bra plan: take vv corner
                W = W[:, :, no_:, no_:]
            R = R + W
    elif ring_mesh is not None:
        # explicit-collective path in the occupied-leading layout: V
        # row-sharded on a, T2 shards ride the ring (ppermute); the
        # per-shard matmul runs as Ozaki slices when the contraction
        # mode is ozaki (distributed x fast path, VERDICT r2 task 3)
        from pymes_jax.parallel.ring_ladder import ring_ladder_inside_ij
        opts = _ct.parse_mode(cm)
        R = R + ring_ladder_inside_ij(V.abcd, t, ring_mesh, ring_axis,
                                      n_slices=opts[0] if opts else None)
    elif abcd_presliced is not None:
        no_, nv = t.shape[1], t.shape[2]
        sb, eb = abcd_presliced  # slices of V.abcd^T, columns = (a,b)
        opts = _ct.parse_mode(cm) or (9, 9)
        sa, ea = ozaki.slice_rows(t.reshape(no_ * no_, nv * nv), sb.shape[0])
        W = ozaki.matmul_presliced(sa, ea, sb, eb, t_cutoff=opts[1])
        R = R + W.reshape(no_, no_, nv, nv)
    else:
        R = R + c2("ijcd,abcd->ijab", t, V.abcd)

    if not is_dcd:
        X_ljac = cs("klcd,kjad->ljac", Vs, t_s)
        R = R + cs("ljac,ilcb->ijab", X_ljac, t_s)

    # quadratic ring with spin-adapted amplitudes
    X_kjcb = cs("klcd,ljdb->kjcb", Vs, tilde_s)
    R = R + cs("ikac,kjcb->ijab", tilde_s, X_kjcb)

    coeff = (0.0 if is_bruekner else 0.5) + (0.0 if is_dcd else 0.5)
    X_ac = t_fock_ab - coeff * cs("klad,lkdc->ac", tilde_s, Vs)
    X_ki = t_fock_ij + coeff * cs("ilcd,lkdc->ki", tilde_s, Vs)

    Ex = cs("ac,ijcb->ijab", X_ac, t_s)
    Ex = Ex - c2("ki,kjab->ijab", X_ki, t)
    Ex = Ex - cs("ikac,kjcb->ijab", Viks, t_s)
    Ex = Ex - cs("ikbc,kjac->ijab", Viks, t_s)
    Ex = Ex + cs("ikac,kjcb->ijab", tilde_s, Vkjs)

    if not is_dcd:
        X_lica = cs("klcd,kida->lica", Vs, t_s)
        Ex = Ex - cs("lica,ljcb->ijab", X_lica, t_s)
        Ex = Ex + cs("lica,ljbc->ijab", X_lica, t_s)

    if V.ex_half is not None:  # half-symmetric T1 dressing of abij
        Ex = Ex + V.ex_half
    R = R + Ex + jnp.transpose(Ex, (1, 0, 3, 2))  # P(ab,ij)
    return R


@jax.jit
def ccd_energy_ij(t_T_ijab, t_V_ijab, t_V_ijab_x):
    """(direct, exchange) energy in the occupied-leading layout — pure
    elementwise mul + sum, no transposes in the loop."""
    e_dir = 2.0 * jnp.sum(t_T_ijab * t_V_ijab)
    e_exc = -1.0 * jnp.sum(t_T_ijab * t_V_ijab_x)
    return e_dir, e_exc


@jax.jit
def ccd_energy(t_T_abij, t_V_ijab):
    """(direct, exchange) CCD correlation energy pieces.

    Written as transpose + elementwise multiply + sum; the transposed V
    is loop-invariant (hoisted out of the solver while_loop by XLA).
    """
    V_d = jnp.transpose(t_V_ijab, (2, 3, 0, 1))   # [a,b,i,j] = V[i,j,a,b]
    V_x = jnp.transpose(t_V_ijab, (3, 2, 0, 1))   # [a,b,i,j] = V[i,j,b,a]
    e_dir = 2.0 * jnp.sum(t_T_abij * V_d)
    e_exc = -1.0 * jnp.sum(t_T_abij * V_x)
    return e_dir, e_exc


@partial(jax.jit, static_argnames=("n_slices", "layout"))
def preslice_abcd(abcd, n_slices, layout="abij"):
    """Ozaki-slice the loop-invariant ladder block for the given loop
    layout (abij: rows of V; ijab: columns of Vᵀ — the amplitudes then
    supply the other operand each iteration)."""
    nv = abcd.shape[0]
    V2 = abcd.reshape(nv * nv, nv * nv)
    if layout == "ijab":
        return ozaki.slice_cols(V2.T, n_slices)
    return ozaki.slice_rows(V2, n_slices)


class CCDCarry(NamedTuple):
    T: jnp.ndarray
    eps_i: jnp.ndarray
    eps_a: jnp.ndarray
    diis: diis.DIISState
    e_last: jnp.ndarray
    dE: jnp.ndarray
    it: jnp.ndarray
    e_hist: jnp.ndarray  # per-iteration energies (observability)


@partial(jax.jit, static_argnames=("no", "is_dcd", "is_diis", "is_dr_ccd",
                                   "is_bruekner", "max_iter", "dim_space",
                                   "log_iterations", "contract_mode",
                                   "ring_mesh", "ring_axis", "layout"))
def ccd_solve_jit(t_fock_pq, blocks: CCDBlocks, no, t_T0_abij,
                  level_shift=0.0, delta_e=1e-8, max_iter=50,
                  is_dcd=False, is_diis=True, is_dr_ccd=False,
                  is_bruekner=False, dim_space=6, log_iterations=False,
                  contract_mode="xla", ring_mesh=None, ring_axis="a",
                  layout="abij", abcd_presliced=None):
    """Fully on-device CCD fixed point: ``lax.while_loop`` over Jacobi + DIIS.

    ``layout="ijab"`` carries T2 occupied-leading inside the loop
    (see :class:`CCDBlocksIJ`) — bit-identical math,
    returned amplitudes are transposed back to ``abij``.  Only the dense
    ``abcd`` path supports it (ladder plans and the ring path are
    abij-native).

    Returns (e_corr, T_abij, eps_i, eps_a, dE, n_iter).
    """
    no = int(no)
    eps_i0 = jnp.diagonal(t_fock_pq)[:no]
    eps_a0 = jnp.diagonal(t_fock_pq)[no:]
    f_ab = t_fock_pq[no:, no:]
    f_ij = t_fock_pq[:no, :no]
    nv = eps_a0.shape[0]

    ij = layout == "ijab"
    if ij and (is_dr_ccd
               or (blocks.abcd is None and blocks.ladder is None)):
        raise ValueError("layout='ijab' requires the dense-abcd, "
                         "matrix-free-ladder or ring path")

    # Ozaki mode: slice the loop-invariant nv^4 ladder block once, outside
    # the while_loop, so each iteration only slices the amplitudes.
    # Callers that solve repeatedly should pass ``abcd_presliced``
    # (:func:`preslice_abcd`) so the slicing doesn't re-run per solve call.
    if (abcd_presliced is None
            and ring_mesh is None and blocks.ladder is None
            and _ct.parse_mode(contract_mode) is not None
            and blocks.abcd is not None
            and blocks.abcd.dtype == jnp.float64):
        n_slices = _ct.parse_mode(contract_mode)[0]
        abcd_presliced = preslice_abcd(blocks.abcd, n_slices, layout)

    if ij:
        V_ij = blocks_ij_from(blocks)
        if abcd_presliced is not None:
            V_ij = V_ij._replace(abcd=None)  # keep only the sliced form
        if (blocks.ladder is not None
                and _ct.parse_mode(contract_mode) is not None):
            from pymes_jax.ops.ueg_ladder import (BlockLadder,
                                                  preslice_block_ladder)
            if (isinstance(blocks.ladder, BlockLadder)
                    and blocks.ladder.presliced is None):
                # plan built without slices: put the loop-invariant
                # sector blocks onto Ozaki slice products here
                V_ij = V_ij._replace(ladder_presliced=preslice_block_ladder(
                    blocks.ladder, _ct.parse_mode(contract_mode)[0]))
        if (_ct.parse_mode(contract_mode) is not None
                and no * nv >= _SLICED_MIN_OV
                and blocks.ijab.dtype == jnp.float64):
            # ring blocks are loop-invariant: slice once per solve
            V_ij = V_ij._replace(sliced=preslice_ring_blocks(
                V_ij, _ct.parse_mode(contract_mode)[0]))
        t_T0 = jnp.transpose(t_T0_abij, (2, 3, 0, 1))
        e0_dir, e0_exc = ccd_energy_ij(t_T0, V_ij.ijab, V_ij.ijab_x)
    else:
        t_T0 = t_T0_abij
        e0_dir, e0_exc = ccd_energy(t_T0_abij, blocks.ijab)
    e0 = jnp.real(e0_dir + e0_exc)

    n_flat = nv * nv * no * no
    carry0 = CCDCarry(
        T=t_T0,
        eps_i=eps_i0, eps_a=eps_a0,
        diis=diis.init_state(dim_space, n_flat, t_T0_abij.dtype),
        e_last=e0,
        dE=jnp.abs(e0) + 1.0,
        it=jnp.zeros((), jnp.int32),
        e_hist=jnp.full((max_iter + 1,), jnp.nan, dtype=jnp.real(e0).dtype),
    )

    def cond(c: CCDCarry):
        return (jnp.abs(c.dE) > delta_e) & (c.it <= max_iter)

    def body(c: CCDCarry):
        if is_dr_ccd:
            from pymes_jax.solver import drccd
            R = drccd.residual(c.eps_i, c.eps_a, c.T, blocks.abij,
                               blocks.iabj, blocks.ijab)
        elif ij:
            R = doubles_residual_ij(f_ab, f_ij, c.T, V_ij,
                                    is_dcd=is_dcd, is_bruekner=is_bruekner,
                                    contract_mode=contract_mode,
                                    abcd_presliced=abcd_presliced,
                                    ring_mesh=ring_mesh,
                                    ring_axis=ring_axis)
        else:
            R = doubles_residual(f_ab, f_ij, c.T, blocks,
                                 is_dcd=is_dcd, is_bruekner=is_bruekner,
                                 contract_mode=contract_mode,
                                 abcd_presliced=abcd_presliced,
                                 ring_mesh=ring_mesh, ring_axis=ring_axis)

        eps_i, eps_a = c.eps_i, c.eps_a
        if is_bruekner:
            # quasi-particle energies from the CURRENT amplitudes on top of
            # the canonical ε₀ (the reference compounds the correction onto
            # the already-shifted ε every iteration, ccd.py:110-115, which
            # diverges — hole energies reach ±10³ Ha on LiH)
            if ij:
                tilde_T = 2.0 * c.T - jnp.transpose(c.T, (0, 1, 3, 2))
                eps_i = eps_i0 + 0.5 * jnp.einsum(
                    "ilcd,ilcd->i", blocks.ijab, tilde_T)
                eps_a = eps_a0 - 0.5 * jnp.einsum(
                    "klad,klad->a", blocks.ijab, tilde_T)
            else:
                tilde_T = 2.0 * c.T - jnp.einsum("baij->abij", c.T)
                eps_i = eps_i0 + 0.5 * jnp.einsum(
                    "ilcd,cdil->i", blocks.ijab, tilde_T)
                eps_a = eps_a0 - 0.5 * jnp.einsum(
                    "klad,adkl->a", blocks.ijab, tilde_T)

        if ij:
            D = (eps_i[:, None, None, None] + eps_i[None, :, None, None]
                 - eps_a[None, None, :, None] - eps_a[None, None, None, :])
        else:
            D = (eps_i[None, None, :, None] + eps_i[None, None, None, :]
                 - eps_a[:, None, None, None] - eps_a[None, :, None, None])
        dT = R / (D + level_shift)
        T = c.T + dT

        diis_state = c.diis
        if is_diis:
            diis_state, mixed = diis.mix(diis_state, dT.ravel(), T.ravel())
            T = mixed.reshape(T.shape)

        if ij:
            e_dir, e_exc = ccd_energy_ij(T, V_ij.ijab, V_ij.ijab_x)
        else:
            e_dir, e_exc = ccd_energy(T, blocks.ijab)
        if is_dr_ccd:
            # drCCD/dRPA energy is direct-ring only (the reference wires the
            # CCD dir+exchange energy here, ccd.py:129-132 — with it, the
            # converged energy does not equal the dRPA plasmon formula; the
            # amplitudes themselves solve the dRPA Riccati equation exactly)
            e = jnp.real(e_dir)
        else:
            e = jnp.real(e_dir + e_exc)
        dE = e - c.e_last
        if log_iterations:
            jax.debug.print(
                "    CCD it {it}: E = {e:.12f}  dE = {de:.3e}",
                it=c.it + 1, e=e, de=dE)
        e_hist = c.e_hist.at[jnp.minimum(c.it, max_iter)].set(e)
        return CCDCarry(T=T, eps_i=eps_i, eps_a=eps_a, diis=diis_state,
                        e_last=e, dE=dE, it=c.it + 1, e_hist=e_hist)

    out = jax.lax.while_loop(cond, body, carry0)
    T_out = jnp.transpose(out.T, (2, 3, 0, 1)) if ij else out.T
    return out.e_last, T_out, out.eps_i, out.eps_a, out.dE, out.it, \
        out.e_hist


class CCD:
    """Reference-API CCD/DCD solver (``pymes/solver/ccd.py:10``).

    ``solve(t_fock_pq, t_V_pqrs, level_shift=0, amps=None, **kwargs)`` returns
    ``{"ccd e", "t2 amp", "hole e", "particle e", "dE"}``.
    """

    def __init__(self, no, delta_e=1e-8, is_dcd=False, is_diis=True,
                 is_dr_ccd=False, is_bruekner=False):
        self.no = int(no)
        self.delta_e = delta_e
        self.is_dcd = is_dcd
        self.is_diis = is_diis
        self.is_dr_ccd = is_dr_ccd
        self.is_bruekner = is_bruekner
        self.max_iter = 50
        self.dim_space = 6
        self.log_iterations = False

    def solve(self, t_fock_pq, t_V_pqrs, level_shift=0.0, sp=0, amps=None,
              mixed_precision=False, contract_mode=None, ring_mesh=None,
              ring_axis="a", layout=None, **kwargs):
        """Solve the doubles equations.

        ``mixed_precision=True`` runs the bulk of the fixed point in f32
        (full-f32 dots, never TF32) to |dE| < 1e-5 and polishes to ``delta_e`` in
        f64 — the energies match the all-f64 path to the convergence
        tolerance because the fixed point is self-correcting under the
        final-precision residuals.

        ``contract_mode`` ("xla" | "ozaki" | "ozaki:S:T") selects the
        matmul backend for the residual contractions; "ozaki:7:6" runs the
        whole f64 fixed point on bf16 slice products with ~1e-9 residual
        accuracy — ample for ``delta_e`` ≥ 1e-8 (defaults to the
        module-wide :func:`pymes_jax.ops.contract.get_mode`).
        """
        algo_name = "ccd.solve"
        max_iter = int(kwargs.get("max_iter", self.max_iter))
        delta_e = float(kwargs.get("delta_e", self.delta_e))
        if contract_mode is None:
            contract_mode = _ct.get_mode()

        no = self.no
        t_fock_pq = jnp.asarray(t_fock_pq)
        if isinstance(t_V_pqrs, dict):
            blocks = blocks_from_dict(t_V_pqrs)
        elif isinstance(t_V_pqrs, CCDBlocks):
            blocks = t_V_pqrs
        else:
            blocks = blocks_from_full(no, jnp.asarray(t_V_pqrs))

        if layout is None:  # occupied-leading loop layout when eligible
            eligible = (not self.is_dr_ccd and ring_mesh is None
                        and (blocks.abcd is not None
                             or blocks.ladder is not None))
            layout = "ijab" if eligible else "abij"

        eps_i = jnp.diagonal(t_fock_pq)[:no]
        eps_a = jnp.diagonal(t_fock_pq)[no:]

        print_logging_info(algo_name)
        print_logging_info("Using DCD: ", self.is_dcd, level=1)
        print_logging_info("Using dr-CCD: ", self.is_dr_ccd, level=1)
        print_logging_info("Using DIIS mixer: ", self.is_diis, level=1)
        print_logging_info("Using Brueckner: ", self.is_bruekner, level=1)

        e_mp2, t_T_abij = mp2.solve(eps_i, eps_a, blocks.ijab, blocks.abij,
                                    level_shift)
        print_logging_info("MP2 energy = {:.12f}".format(float(jnp.real(e_mp2))),
                           level=1)
        if amps is not None:
            t_T_abij = jnp.asarray(amps)

        it32 = 0
        if mixed_precision and t_T_abij.dtype == jnp.float64:
            f32 = jnp.float32
            # cast only f64 leaves: ladder plans carry int32 gather
            # indices / int8 ozaki slices / python-float weights
            blocks32 = jax.tree_util.tree_map(
                lambda x: x.astype(f32)
                if (hasattr(x, "dtype") and x.dtype == jnp.float64)
                else x, blocks)
            # full-f32 dots: the default precision lets GPUs run f32
            # matmuls in TF32 (10-bit mantissa)
            with jax.default_matmul_precision("float32"):
                _, T32, _, _, _, it32, _ = ccd_solve_jit(
                    t_fock_pq.astype(f32), blocks32, int(no),
                    t_T_abij.astype(f32), level_shift=level_shift,
                    delta_e=max(1e-5, delta_e), max_iter=max_iter,
                    is_dcd=self.is_dcd, is_diis=self.is_diis,
                    is_dr_ccd=self.is_dr_ccd, is_bruekner=self.is_bruekner,
                    dim_space=self.dim_space, layout=layout)
            it32 = int(it32)
            print_logging_info(
                "mixed precision: {} f32 iterations".format(it32), level=1)
            t_T_abij = T32.astype(jnp.float64)

        abcd_presliced = None
        if (ring_mesh is None and blocks.ladder is None
                and _ct.parse_mode(contract_mode) is not None
                and blocks.abcd is not None
                and blocks.abcd.dtype == jnp.float64):
            abcd_presliced = preslice_abcd(
                blocks.abcd, _ct.parse_mode(contract_mode)[0], layout)

        e, T, eps_i, eps_a, dE, n_iter, e_hist = ccd_solve_jit(
            t_fock_pq, blocks, int(no), t_T_abij,
            level_shift=level_shift, delta_e=delta_e, max_iter=max_iter,
            is_dcd=self.is_dcd, is_diis=self.is_diis,
            is_dr_ccd=self.is_dr_ccd, is_bruekner=self.is_bruekner,
            dim_space=self.dim_space, log_iterations=self.log_iterations,
            contract_mode=contract_mode, ring_mesh=ring_mesh,
            ring_axis=ring_axis, layout=layout,
            abcd_presliced=abcd_presliced)

        n_iter = int(n_iter)
        if n_iter > max_iter:
            print_logging_info("A converged solution is not found!", level=1)
        print_logging_info(
            "CCD correlation energy = {:.12f} ({} iterations)".format(
                float(e), n_iter), level=1)
        e_hist = np.asarray(e_hist)[:n_iter]
        return {"ccd e": float(np.real(np.asarray(e))), "t2 amp": T,
                "hole e": eps_i, "particle e": eps_a,
                "dE": float(np.real(np.asarray(dE))),
                "e history": e_hist, "f32 iterations": it32}

    # expose the pure residual with the reference's method signature
    def get_residual(self, t_fock_pq, t_T_abij, t_V_klij, t_V_ijab,
                     t_V_abij, t_V_iajb, t_V_iabj, t_V_abcd):
        no = self.no
        blocks = CCDBlocks(klij=t_V_klij, ijab=t_V_ijab, abij=t_V_abij,
                           iajb=t_V_iajb, iabj=t_V_iabj, abcd=t_V_abcd)
        return doubles_residual(t_fock_pq[no:, no:], t_fock_pq[:no, :no],
                                t_T_abij, blocks, is_dcd=self.is_dcd,
                                is_bruekner=self.is_bruekner)

    def get_energy(self, t_T_abij, t_V_ijab):
        return ccd_energy(t_T_abij, t_V_ijab)
