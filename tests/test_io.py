"""FCIDUMP/TCDUMP I/O hardening (VERDICT r1 task 5; ADVICE medium).

Mirrors the reference's reader property tests
(``pymes/test/test_util/test_fcidump_reader.py:10-63``): the TC symmetry
contract (pqrs↔qpsr present, all Hermitian images absent), a write→read
round trip, plus the native-parser validation (Fortran D-exponents, loud
failure on partial parses) and the new blocks-only / HDF5 ingestion paths.
"""

import os

import numpy as np
import pytest

from pymes_jax.util import fcidump

DATA = os.path.join(os.path.dirname(__file__), "data")
LIH_TC = os.path.join(DATA, "FCIDUMP.LiH.tc")
LIH = os.path.join(DATA, "FCIDUMP.LiH.321g")


def test_tc_fcidump_symmetry_contract():
    _, _, _, _, _, V = fcidump.read(LIH_TC, is_tc=True)
    # particle exchange must hold exactly
    assert np.abs(np.einsum("pqrs->qpsr", V) - V).sum() < 1e-12
    # none of the Hermitian / real-orbital images may have been restored
    for perm in ("rqps", "sqrp", "prqs", "pqsr", "psrq"):
        assert np.abs(np.einsum(f"pqrs->{perm}", V) - V).sum() > 1e-12, perm


def test_hermitian_fcidump_symmetries_restored():
    _, _, _, _, _, V = fcidump.read(LIH)
    for perm in ("rqps", "rspq", "psrq", "qpsr"):
        assert np.abs(np.einsum(f"pqrs->{perm}", V) - V).max() < 1e-12, perm


def test_fcidump_write_read_round_trip(tmp_path):
    n_elec, n_orb, e_core, eps, h, V = fcidump.read(LIH_TC, is_tc=True)
    out = str(tmp_path / "fcidump.w")
    fcidump.write(V, h, n_elec // 2, e_core, file=out)
    n_elec_r, n_orb_r, e_core_r, eps_r, h_r, V_r = fcidump.read(
        out, is_tc=True)
    assert (n_elec_r, n_orb_r) == (n_elec, n_orb)
    assert e_core_r == e_core
    assert np.array_equal(h_r, h)
    assert np.array_equal(V_r, V)


def test_fcidump_h5_round_trip(tmp_path):
    pytest.importorskip("h5py")
    n_elec, n_orb, e_core, _, h, V = fcidump.read(LIH_TC, is_tc=True)
    out = str(tmp_path / "fcidump.h5")
    fcidump.write_h5(out, V, h, n_elec // 2, e_core)
    n_elec_r, n_orb_r, e_core_r, _, h_r, V_r = fcidump.read_h5(
        out, is_tc=True)
    assert (n_elec_r, n_orb_r, e_core_r) == (n_elec, n_orb, e_core)
    assert np.array_equal(h_r, h)
    assert np.array_equal(V_r, V)


def test_read_blocks_matches_dense():
    n_elec, n_orb, e_core, eps, h, V = fcidump.read(LIH)
    no = n_elec // 2
    names = ("klij", "ijab", "abij", "iajb", "iabj", "abcd", "iabc")
    ne2, nb2, ec2, eps2, h2, blocks = fcidump.read_blocks(LIH, no,
                                                          names=names)
    assert (ne2, nb2, ec2) == (n_elec, n_orb, e_core)
    assert np.array_equal(h2, h)
    o, v = slice(None, no), slice(no, None)
    dense = {"klij": V[o, o, o, o], "ijab": V[o, o, v, v],
             "abij": V[v, v, o, o], "iajb": V[o, v, o, v],
             "iabj": V[o, v, v, o], "abcd": V[v, v, v, v],
             "iabc": V[o, v, v, v]}
    for name in names:
        assert np.array_equal(blocks[name], dense[name]), name


def test_read_blocks_tc_matches_dense():
    n_elec, _, _, _, _, V = fcidump.read(LIH_TC, is_tc=True)
    no = n_elec // 2
    _, _, _, _, _, blocks = fcidump.read_blocks(
        LIH_TC, no, names=("ijab", "abij"), is_tc=True)
    o, v = slice(None, no), slice(no, None)
    assert np.array_equal(blocks["ijab"], V[o, o, v, v])
    assert np.array_equal(blocks["abij"], V[v, v, o, o])


def test_native_parser_d_exponents_and_validation():
    _native = pytest.importorskip("pymes_jax._native")
    v, i = _native.parse_integral_lines(
        "1.5D-03 1 2 3 4\n-2.0d+01 4 3 2 1\n")
    assert np.allclose(v, [1.5e-3, -20.0])
    assert (i == [[1, 2, 3, 4], [4, 3, 2, 1]]).all()
    with pytest.raises(ValueError):  # malformed token mid-body
        _native.parse_integral_lines("1.0 1 2 3 4\nBANANA 1 2 3 4\n")
    with pytest.raises(ValueError):  # token count not a record multiple
        _native.parse_integral_lines("1.0 1 2 3\n")


def test_reader_survives_d_exponent_dump(tmp_path):
    f = tmp_path / "FCIDUMP.dexp"
    f.write_text("&FCI\n NORB=2,\n NELEC=2,\n MS2=0,\n/\n"
                 " 5.0D-01 1 1 1 1\n 1.0d+00 1 1 0 0\n 0.25 0 0 0 0\n")
    n_elec, n_orb, e_core, eps, h, V = fcidump.read(str(f))
    assert n_orb == 2 and n_elec == 2
    assert e_core == 0.25
    assert h[0, 0] == 1.0
    assert V[0, 0, 0, 0] == 0.5
