"""Occupied-leading (ijab) loop layout == reference abij layout.

The ijab path keeps the large virtual axes trailing (abij-layout tensors
end in two occupied axes of size no≈7) and re-indexes every contraction of
the doubles residual (reference diagrams at ``pymes/solver/ccd.py:164``).
These tests pin element-exact agreement between the two layouts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pymes_jax.solver import ccd, mp2


def _random_blocks(no, nv, seed=0, herm=True):
    rng = np.random.default_rng(seed)
    n = no + nv

    def r(*s):
        return rng.standard_normal(s) * 0.05

    V = r(n, n, n, n)
    V = V + V.transpose(1, 0, 3, 2)  # particle exchange
    if herm:
        V = V + V.transpose(2, 3, 0, 1)
    return ccd.blocks_from_full(no, jnp.asarray(V)), V


@pytest.mark.parametrize("is_dcd", [False, True])
def test_residual_ij_matches_abij(is_dcd):
    no, nv = 3, 7
    blocks, _ = _random_blocks(no, nv, seed=1)
    rng = np.random.default_rng(2)
    T = jnp.asarray(rng.standard_normal((nv, nv, no, no)) * 0.02)
    f_ab = jnp.asarray(np.diag(rng.uniform(1.0, 2.0, nv)))
    f_ij = jnp.asarray(np.diag(rng.uniform(-2.0, -1.0, no)))

    R = ccd.doubles_residual(f_ab, f_ij, T, blocks, is_dcd=is_dcd)
    Vij = ccd.blocks_ij_from(blocks)
    Rij = ccd.doubles_residual_ij(f_ab, f_ij,
                                  jnp.transpose(T, (2, 3, 0, 1)), Vij,
                                  is_dcd=is_dcd)
    np.testing.assert_allclose(np.asarray(R),
                               np.asarray(Rij).transpose(2, 3, 0, 1),
                               rtol=0, atol=1e-13)


def test_energy_ij_matches():
    no, nv = 3, 7
    rng = np.random.default_rng(3)
    T = jnp.asarray(rng.standard_normal((nv, nv, no, no)))
    Vijab = jnp.asarray(rng.standard_normal((no, no, nv, nv)))
    ed, ex = ccd.ccd_energy(T, Vijab)
    edi, exi = ccd.ccd_energy_ij(jnp.transpose(T, (2, 3, 0, 1)), Vijab,
                                 jnp.transpose(Vijab, (0, 1, 3, 2)))
    assert abs(float(ed) - float(edi)) < 1e-12
    assert abs(float(ex) - float(exi)) < 1e-12


@pytest.mark.parametrize("contract_mode", ["xla", "ozaki:7:6"])
def test_full_solve_layouts_agree(contract_mode):
    no, nv = 3, 9
    blocks, V = _random_blocks(no, nv, seed=4)
    eps = np.concatenate([np.linspace(-2.0, -1.0, no),
                          np.linspace(1.0, 3.0, nv)])
    fock = jnp.asarray(np.diag(eps))
    _, T0 = mp2.solve(jnp.asarray(eps[:no]), jnp.asarray(eps[no:]),
                      blocks.ijab, blocks.abij, 0.0)

    outs = {}
    for layout in ("abij", "ijab"):
        e, T, *_ = ccd.ccd_solve_jit(fock, blocks, no, T0, delta_e=1e-11,
                                     max_iter=80,
                                     contract_mode=contract_mode,
                                     layout=layout)
        outs[layout] = (float(e), np.asarray(T))
    assert abs(outs["abij"][0] - outs["ijab"][0]) < 1e-10
    np.testing.assert_allclose(outs["abij"][1], outs["ijab"][1], atol=1e-9)


def test_matrix_free_ladder_ij_layout():
    """ij-layout gather-ladder == abij gather-ladder == dense, and the
    full matrix-free CCD solve agrees across layouts."""
    from pymes_jax.models import ueg
    from pymes_jax.mean_field import hf
    from pymes_jax.ops.ueg_ladder import (build_ueg_ladder,
                                          ueg_ladder_apply,
                                          ueg_ladder_apply_ij)

    u = ueg.UEG(14, 7, 7, 1.0)
    u.init_single_basis(2)
    V = np.asarray(u.eval_2b_integrals())
    no = 7
    nv = u.n_spatial - no
    rng = np.random.default_rng(7)
    T = rng.standard_normal((nv, nv, no, no))
    lad = build_ueg_ladder(u)

    R_ab = np.asarray(ueg_ladder_apply(lad, T))
    R_ij = np.asarray(ueg_ladder_apply_ij(lad, T.transpose(2, 3, 0, 1)))
    np.testing.assert_allclose(R_ab, R_ij.transpose(2, 3, 0, 1), atol=1e-13)
    # all-bra plan too (vv corner)
    lad_all = build_ueg_ladder(u, bra="all")
    W_ab = np.asarray(ueg_ladder_apply(lad_all, T))
    W_ij = np.asarray(ueg_ladder_apply_ij(lad_all, T.transpose(2, 3, 0, 1)))
    np.testing.assert_allclose(W_ab, W_ij.transpose(2, 3, 0, 1), atol=1e-13)

    # full matrix-free solve: ij layout == abij layout
    kin = jnp.asarray(u.kinetic_energies())
    Vj = jnp.asarray(V)
    eps_i = hf.calcOccupiedOrbE(kin, Vj[:no, :no, :no, :no], no)
    eps_a = hf.calcVirtualOrbE(kin, Vj[no:, :no, no:, :no],
                               Vj[no:, :no, :no, no:], no, nv)
    fock = jnp.diag(jnp.concatenate([eps_i, eps_a]))
    blocks = ccd.CCDBlocks(
        klij=Vj[:no, :no, :no, :no], ijab=Vj[:no, :no, no:, no:],
        abij=Vj[no:, no:, :no, :no], iajb=Vj[:no, no:, :no, no:],
        iabj=Vj[:no, no:, no:, :no], abcd=None, ladder=lad)
    _, T0 = mp2.solve(eps_i, eps_a, blocks.ijab, blocks.abij, -1.0)
    outs = {}
    for layout in ("abij", "ijab"):
        e, Tmf, *_ = ccd.ccd_solve_jit(fock, blocks, no, T0,
                                       level_shift=-1.0, delta_e=1e-10,
                                       max_iter=80, layout=layout)
        outs[layout] = (float(e), np.asarray(Tmf))
    assert abs(outs["abij"][0] - outs["ijab"][0]) < 1e-10
    np.testing.assert_allclose(outs["abij"][1], outs["ijab"][1], atol=1e-9)


def test_ccsd_layouts_agree_dense_and_matrix_free():
    """CCSD fixed point: ijab loop layout == abij, dense LiH-style random
    blocks AND the UEG matrix-free (T1-dressed gather ladder) path."""
    from pymes_jax.solver import ccsd
    from pymes_jax.models import ueg
    from pymes_jax.mean_field import hf
    from pymes_jax.integral.partition import part_2_body_int
    from pymes_jax.ops.ueg_ladder import build_ueg_ladder

    # dense path on a random Hermitian V
    no, nv = 2, 6
    _, V = _random_blocks(no, nv, seed=11)
    eps = np.concatenate([np.linspace(-2.0, -1.0, no),
                          np.linspace(1.0, 3.0, nv)])
    fock = jnp.asarray(np.diag(eps))
    outs = {}
    for layout in ("abij", "ijab"):
        r = ccsd.CCSD(no, delta_e=1e-10).solve(fock, jnp.asarray(V),
                                               layout=layout)
        outs[layout] = r
    assert abs(outs["abij"]["ccsd e"] - outs["ijab"]["ccsd e"]) < 1e-9
    np.testing.assert_allclose(np.asarray(outs["abij"]["t2"]),
                               np.asarray(outs["ijab"]["t2"]), atol=1e-8)
    np.testing.assert_allclose(np.asarray(outs["abij"]["t1"]),
                               np.asarray(outs["ijab"]["t1"]), atol=1e-8)

    # matrix-free UEG with off-diagonal Fock noise so T1 is genuinely
    # nonzero (clean Γ-point momentum conservation forces T1 ≡ 0, which
    # would mask dressed-ladder layout defects)
    u = ueg.UEG(14, 7, 7, 1.0)
    u.init_single_basis(2)
    no = 7
    Vu = np.asarray(u.eval_2b_integrals())
    fu = np.asarray(hf.construct_hf_matrix(
        no, np.diag(u.kinetic_energies()), jnp.asarray(Vu)))
    rng = np.random.default_rng(5)
    noise = rng.standard_normal(fu.shape) * 0.02
    fu = jnp.asarray(fu + noise + noise.T)
    dv = {k: v for k, v in part_2_body_int(no, jnp.asarray(Vu)).items()
          if k not in ("abcd", "abci")}
    lad_all = build_ueg_ladder(u, bra="all")
    outs = {}
    for layout in ("abij", "ijab"):
        r = ccsd.CCSD(no, delta_e=1e-10).solve(fu, dv, ladder=lad_all,
                                               max_iter=200, layout=layout)
        outs[layout] = r
    assert abs(outs["abij"]["ccsd e"] - outs["ijab"]["ccsd e"]) < 1e-9
    assert float(jnp.abs(outs["ijab"]["t1"]).max()) > 1e-3  # T1 nonzero
    np.testing.assert_allclose(np.asarray(outs["abij"]["t2"]),
                               np.asarray(outs["ijab"]["t2"]), atol=1e-7)
    np.testing.assert_allclose(np.asarray(outs["abij"]["t1"]),
                               np.asarray(outs["ijab"]["t1"]), atol=1e-7)


def test_solver_api_defaults_to_ij_layout_and_oracle():
    # CCD.solve auto-selects the ijab loop layout on the dense path and
    # still hits the same fixed point as the abij layout
    no, nv = 3, 8
    blocks, V = _random_blocks(no, nv, seed=5)
    eps = np.concatenate([np.linspace(-2.0, -1.0, no),
                          np.linspace(1.0, 3.0, nv)])
    fock = jnp.asarray(np.diag(eps))
    solver = ccd.CCD(no, delta_e=1e-10)
    res_auto = solver.solve(fock, V)
    res_abij = solver.solve(fock, V, layout="abij")
    assert abs(res_auto["ccd e"] - res_abij["ccd e"]) < 1e-9
    np.testing.assert_allclose(np.asarray(res_auto["t2 amp"]),
                               np.asarray(res_abij["t2 amp"]), atol=1e-8)


def test_singles_residual_ij_matches_abij():
    """singles_residual_ij (no abij-layout temporary) is element-exact vs
    the abij-layout form, with a dense ovvv block present."""
    from pymes_jax.solver import ccsd
    no, nv = 3, 7
    n = no + nv
    rng = np.random.default_rng(21)
    V = rng.standard_normal((n, n, n, n)) * 0.05
    V = V + V.transpose(1, 0, 3, 2)
    dv = {"ijab": jnp.asarray(V[:no, :no, no:, no:]),
          "ijka": jnp.asarray(V[:no, :no, :no, no:]),
          "aibc": jnp.asarray(V[no:, :no, no:, no:])}
    fd = jnp.asarray(rng.standard_normal((n, n)) * 0.1)
    T1 = jnp.asarray(rng.standard_normal((nv, no)) * 0.03)
    T2 = jnp.asarray(rng.standard_normal((nv, nv, no, no)) * 0.02)
    R_ab = ccsd.singles_residual(fd, T1, T2, dv)
    R_ij = ccsd.singles_residual_ij(fd, T1, jnp.transpose(T2, (2, 3, 0, 1)),
                                    dv)
    np.testing.assert_allclose(np.asarray(R_ab), np.asarray(R_ij),
                               rtol=0, atol=1e-13)


def test_dressed_block_out_perm_and_skip_identity():
    """out_perm permutes the dressed output; skip_identity drops exactly
    the T1-free term (so hoisted-base + corrections == full dressing)."""
    from pymes_jax.solver import ccsd
    no, nv = 3, 6
    n = no + nv
    rng = np.random.default_rng(22)
    V = rng.standard_normal((n, n, n, n)) * 0.05
    from pymes_jax.integral.partition import part_2_body_int
    dv = dict(part_2_body_int(no, jnp.asarray(V)))
    T1 = jnp.asarray(rng.standard_normal((nv, no)) * 0.04)
    full = ccsd.dressed_block("abij", dv, T1)
    perm = ccsd.dressed_block("abij", dv, T1, out_perm=(2, 3, 0, 1))
    np.testing.assert_allclose(np.asarray(full).transpose(2, 3, 0, 1),
                               np.asarray(perm), rtol=0, atol=1e-14)
    corr = ccsd.dressed_block("abij", dv, T1, out_perm=(2, 3, 0, 1),
                              skip_identity=True)
    base = jnp.transpose(dv["abij"], (2, 3, 0, 1))
    np.testing.assert_allclose(np.asarray(base + corr), np.asarray(perm),
                               rtol=0, atol=1e-14)
