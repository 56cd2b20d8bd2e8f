"""FCIDUMP → HF → CCSD → EOM-CCSD excitation energies.

The canonical molecular workflow (the reference documents it through
``pymes/test/test_ccsd``/``test_eom_ccsd``).  Runs on whatever backend jax
selects; the whole CCSD solve is one device dispatch.

    python examples/molecular_ccsd_eom.py [FCIDUMP]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pymes_jax.integral.partition import part_2_body_int
from pymes_jax.mean_field import hf
from pymes_jax.solver import ccsd, eom_ccsd
from pymes_jax.util import checkpoint, fcidump


def main(fcidump_file):
    n_elec, n_orb, e_core, eps, h, V = fcidump.read(fcidump_file)
    no = n_elec // 2
    print(f"{n_elec} electrons in {n_orb} orbitals")

    hf_e = float(hf.calc_hf_e(no, e_core, h, V))
    print(f"HF total energy      = {hf_e:.12f}")

    fock = hf.construct_hf_matrix(no, h, V)
    cc = ccsd.CCSD(no)
    cc.delta_e = 1e-10
    result = cc.solve(fock, V)
    print(f"CCSD correlation E   = {result['ccsd e']:.12f} "
          f"({len(result['e history'])} iterations)")

    # persist amplitudes for warm starts / later analysis
    checkpoint.save("/tmp/ccsd_ckpt", checkpoint.from_result(result))

    dict_V = part_2_body_int(no, V)
    f_dressed = cc.get_T1_dressed_fock(fock, result["t1"], dict_V)
    V_dressed = cc.get_T1_dressed_V(result["t1"], dict_V)

    eom = eom_ccsd.EOM_CCSD(no, n_excit=2)
    excitations = eom.solve(f_dressed, V_dressed, result["t2"])
    for i, e in enumerate(excitations):
        print(f"EOM-CCSD root {i}: {e:.10f} Ha = {e * 27.2114:.4f} eV")


if __name__ == "__main__":
    default = os.path.join(os.path.dirname(__file__), "..", "tests",
                           "data", "FCIDUMP.LiH.321g")
    main(sys.argv[1] if len(sys.argv) > 1 else default)
