"""Transcorrelated UEG with twist averaging (the reference's
``test_ta_ueg`` workflow): gaskell correlator, 3-body mean-field
corrections, TC-MP2 per irreducible twist, weight-averaged.

    python examples/ueg_tc_twist_average.py [mesh=3]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from pymes_jax.mean_field import hf
from pymes_jax.models import ueg
from pymes_jax.solver import mp2
from pymes_jax.util.kpoints import gen_ir_ks


def tc_mp2(shift):
    nel, rs = 14, 1.0
    k_f = 0.5 * (3 * nel / np.pi) ** (1.0 / 3)
    no = nel // 2
    u = ueg.UEG(nel, no, no, rs)
    u.init_single_basis((k_f * 1.2) ** 2, list(shift))
    u.gamma, u.k_cutoff = None, 1.0

    V = u.eval_2b_integrals(correlator=u.gaskell, is_only_2b=True)
    fock = np.asarray(hf.construct_hf_matrix(
        no, np.diag(u.kinetic_energies()), V))
    hf_e = float(hf.calc_hf_e(no, 0.0, np.diag(u.kinetic_energies()), V))

    eps = fock.diagonal().copy()
    eps += np.asarray(u.double_contractions_in_3_body())
    e3 = float(u.triple_contractions_in_3_body())

    V = V + u.eval_2b_integrals(correlator=u.gaskell, is_rpa_approx=True)
    e_mp2, _ = mp2.solve(eps[:no], eps[no:], V[:no, :no, no:, no:],
                         V[no:, no:, :no, :no])
    return hf_e, e3, float(np.real(e_mp2))


def main(mesh=3):
    ir_ks, weights = gen_ir_ks(mesh)
    print(f"{mesh}^3 Monkhorst mesh -> {len(ir_ks)} irreducible twists")
    total = np.zeros(3)
    for ks, w in zip(ir_ks, weights):
        hf_e, e3, e_mp2 = tc_mp2(ks)
        total += w * np.array([hf_e, e3, e_mp2])
        print(f"  twist {np.round(ks, 3)} (w={w:.4f}): "
              f"HF={hf_e:.8f}  3-body={e3:.8f}  MP2={e_mp2:.8f}")
    print(f"twist-averaged: HF={total[0]:.8f}  3-body={total[1]:.8f}  "
          f"MP2={total[2]:.8f}  total={total.sum():.8f}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 3)
