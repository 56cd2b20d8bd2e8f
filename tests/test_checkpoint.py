"""Checkpoint/resume: save a converged CCD run, warm-start DCD from it."""

import numpy as np

from pymes_jax.mean_field import hf
from pymes_jax.solver import ccd
from pymes_jax.util import checkpoint, fcidump

import os

DATA = os.path.join(os.path.dirname(__file__), "data")


def test_checkpoint_roundtrip_and_warm_start(tmp_path):
    n_elec, nb, e_core, e_orb, h_pq, V_pqrs = fcidump.read(
        os.path.join(DATA, "FCIDUMP.LiH.321g"))
    no = n_elec // 2
    fock = hf.construct_hf_matrix(no, h_pq, V_pqrs)

    res = ccd.CCD(no).solve(fock, V_pqrs)
    ck = checkpoint.from_result(res, meta={"system": "LiH"})
    path = tmp_path / "ccd_ckpt"
    checkpoint.save(str(path), ck)

    ck2 = checkpoint.load(str(path))
    assert np.allclose(ck2.t2, np.asarray(res["t2 amp"]))
    assert ck2.meta["system"] == "LiH"
    assert abs(ck2.energy - res["ccd e"]) < 1e-14

    # warm start converges immediately (few iterations, same energy)
    res2 = ccd.CCD(no).solve(fock, V_pqrs, amps=ck2.amps)
    assert abs(res2["ccd e"] - res["ccd e"]) < 5e-8
