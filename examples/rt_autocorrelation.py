"""CIF real-time EOM-CCSD dynamics: propagate a state and record the
autocorrelation c(t) = <u(0), u(t)> (the reference's ``test_rt`` driver,
which Fourier-analyses c(t) for excitation spectra).

    python examples/rt_autocorrelation.py [nt=50] [dt=0.1]

Writes ct.npy with columns (t, Re c, Im c).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from pymes_jax.integral.partition import part_2_body_int
from pymes_jax.mean_field import hf
from pymes_jax.solver import ccsd
from pymes_jax.solver.rt_eom_ccsd import RT_EOM_CCSD
from pymes_jax.util import fcidump


def main(nt=50, dt=0.1):
    dump = os.path.join(os.path.dirname(__file__), "..", "tests", "data",
                        "FCIDUMP.H2.sto6g")
    n_elec, n_orb, e_core, eps, h, V = fcidump.read(dump)
    no = n_elec // 2

    fock = hf.construct_hf_matrix(no, h, V)
    cc = ccsd.CCSD(no)
    result = cc.solve(fock, V, delta_e=1e-12, max_iter=100)
    dict_V = part_2_body_int(no, V)
    fd = cc.get_T1_dressed_fock(fock, result["t1"], dict_V)
    Vd = cc.get_T1_dressed_V(result["t1"], dict_V)
    T2 = result["t2"]
    nv = T2.shape[0]

    rng = np.random.default_rng(0)
    u1_0 = rng.random((nv, no)) - 0.5
    u2_0 = np.zeros((nv, nv, no, no))
    norm = np.sqrt(np.sum(u1_0 ** 2))
    u1_0 /= norm

    rt = RT_EOM_CCSD(no, e_c=0.5, e_r=0.6, n_quad=32)
    rt.ls_max_iter = 100

    t = np.arange(1, nt + 1) * dt
    c_t = np.zeros(nt, dtype=complex)
    u1, u2 = u1_0.astype(complex), u2_0.astype(complex)
    for n in range(nt):
        u1, u2 = rt.solve(fd, Vd, T2, dt=dt, u_singles=u1, u_doubles=u2)
        c_t[n] = (np.tensordot(u1_0, u1, axes=2)
                  + np.tensordot(u2_0, u2, axes=4))
        print(f"t = {t[n]:6.2f}   c(t) = {c_t[n]:.6f}")
    np.save("ct.npy", np.column_stack((t, c_t.real, c_t.imag)))
    print("wrote ct.npy")


if __name__ == "__main__":
    nt = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    dt = float(sys.argv[2]) if len(sys.argv) > 2 else 0.1
    main(nt, dt)
