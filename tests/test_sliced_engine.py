"""Shared-slice ring/sigma engine vs the plain XLA path.

The engine only engages above ``ccd._SLICED_MIN_OV`` (production sizes);
here the gate is lowered so the UEG cutoff-5 system (no·nv = 350)
exercises the sliced code paths on CPU, where f64 einsum is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pymes_jax.mean_field import hf
from pymes_jax.models import ueg
from pymes_jax.ops import ozaki
from pymes_jax.ops.ueg_ladder import build_block_ladder, build_ovvv_plans
from pymes_jax.solver import ccd, eom_ccsd

NEED = ('klij', 'ijab', 'abij', 'iajb', 'iabj', 'aibj', 'aijb',
        'ijka', 'ijak', 'iajk')


@pytest.fixture(scope="module")
def ueg_c5():
    u = ueg.UEG(14, 7, 7, 0.5)
    u.init_single_basis(5)
    no, n_p = 7, u.n_spatial
    idx, vals = u.eval_2b_integrals(sp=2)
    d = ueg.sparse_to_blocks(idx, vals, n_p, no, names=NEED,
                             dtype=jnp.float64)
    kin = jnp.asarray(u.kinetic_energies())
    eps_i = hf.calcOccupiedOrbE(kin, d['klij'], no)
    eps_a = hf.calcVirtualOrbE(kin, d['aibj'], d['aijb'], no, n_p - no)
    fock = jnp.diag(jnp.concatenate([eps_i, eps_a]))
    return u, d, fock, no, n_p - no


@pytest.fixture()
def low_gate(monkeypatch):
    monkeypatch.setattr(ccd, "_SLICED_MIN_OV", 64)
    jax.clear_caches()   # the gate is read at trace time
    yield
    jax.clear_caches()


def test_slice_tensor_roundtrip():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((5, 9, 4))
                    * np.exp(rng.uniform(-8, 8, (5, 9, 4))))
    s, e = ozaki.slice_tensor(x, 9)
    rec = sum(s[k].astype(jnp.float64) * 2.0 ** (-6 * (k + 1))
              for k in range(9)) * ozaki._pow2(e)
    assert float(jnp.max(jnp.abs(rec - x))) < 1e-13 * float(
        jnp.max(jnp.abs(x)))


def test_einsum2_sliced_mixed_operands():
    rng = np.random.default_rng(1)
    A = jnp.asarray(rng.standard_normal((6, 7, 8, 9)))
    B = jnp.asarray(rng.standard_normal((8, 5, 9, 7)))
    spec = "klcd,cxdl->kx"
    ref = jnp.einsum(spec, A, B)
    As, Bs = ozaki.slice_tensor(A, 9), ozaki.slice_tensor(B, 9)
    for a_in, b_in in [(As, Bs), (As, B), (A, Bs), (A, B)]:
        out = ozaki.einsum2_sliced(spec, a_in, b_in, n_slices=9, t_cutoff=9)
        assert float(jnp.max(jnp.abs(out - ref))) < 1e-12


def test_doubles_residual_sliced_matches_xla(ueg_c5, low_gate):
    u, d, fock, no, nv = ueg_c5
    blocks = ccd.CCDBlocks(klij=d['klij'], ijab=d['ijab'], abij=d['abij'],
                           iajb=d['iajb'], iabj=d['iabj'], abcd=None,
                           ladder=build_block_ladder(u))
    V_ij = ccd.blocks_ij_from(blocks)
    rng = np.random.default_rng(2)
    T = jnp.asarray(rng.standard_normal((no, no, nv, nv)) * 1e-2)
    f_ab, f_ij = fock[no:, no:], fock[:no, :no]
    R_x = ccd.doubles_residual_ij(f_ab, f_ij, T, V_ij, contract_mode="xla")
    V_s = V_ij._replace(sliced=ccd.preslice_ring_blocks(V_ij, 9))
    R_o = ccd.doubles_residual_ij(f_ab, f_ij, T, V_s,
                                  contract_mode="ozaki:9:9")
    scale = float(jnp.max(jnp.abs(R_x)))
    assert float(jnp.max(jnp.abs(R_o - R_x))) < 1e-11 * scale
    # in-residual slicing (no presliced blocks) takes the same path
    R_o2 = ccd.doubles_residual_ij(f_ab, f_ij, T, V_ij,
                                   contract_mode="ozaki:7:6")
    assert float(jnp.max(jnp.abs(R_o2 - R_x))) < 1e-7 * scale


def test_sigma_doubles_sliced_matches_xla(ueg_c5, low_gate):
    u, d, fock, no, nv = ueg_c5
    dict_V = dict(d)
    dict_V["_ovvv_plans"] = build_ovvv_plans(u)
    dict_V["abcd_ladder"] = build_block_ladder(u, bra="all")
    rng = np.random.default_rng(3)
    T = jnp.asarray(rng.standard_normal((nv, nv, no, no)) * 1e-2)
    u1 = jnp.asarray(rng.standard_normal((nv, no)) * 1e-1)
    u2 = jnp.asarray(rng.standard_normal((nv, nv, no, no)) * 1e-1)
    hb_x = eom_ccsd.build_hbar(fock, dict_V, T, contract_mode="xla")
    w_x = eom_ccsd.sigma_doubles_hbar(fock, dict_V, hb_x, u1, u2, T,
                                      contract_mode="xla")
    sl = eom_ccsd.preslice_sigma_hbar(dict_V, hb_x, T, "ozaki:9:9")
    assert sl is not None
    w_o = eom_ccsd.sigma_doubles_hbar(fock, dict_V, hb_x, u1, u2, T,
                                      contract_mode="ozaki:9:9", sliced=sl)
    scale = float(jnp.max(jnp.abs(w_x)))
    assert float(jnp.max(jnp.abs(w_o - w_x))) < 1e-11 * scale
