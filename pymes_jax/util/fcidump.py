"""FCIDUMP reader/writer.

File-format compatible with the reference (``pymes/util/fcidump.py:8,59``):
a Fortran-namelist header (NORB/NELEC/MS2/ORBSYM/ISYM) followed by integral
lines ``value p r q s`` (chemists' file order; stored in physicists' order
``V[p,q,r,s] = <pq|rs>``).  For Hermitian dumps the 4 real-orbital symmetry
images are restored; for transcorrelated dumps only the particle-exchange
symmetry ``pqrs ↔ qpsr`` holds (TC Hamiltonians are non-Hermitian).

The line parsing is vectorized with numpy (the reference parses line-by-line
in Python); an optional C++ fast path lives in ``pymes_jax._native``.
"""

import os

import numpy as np

from pymes_jax.log import print_logging_info

try:  # optional native fast parser (csrc/io_native.cpp)
    from pymes_jax import _native
except Exception:  # pragma: no cover - fallback exercised when lib missing
    _native = None


def _parse_header(reader):
    line = reader.readline().strip()
    while not ("/" in line or "end" in line.lower()):
        line += reader.readline().strip()
    header = {"norb": 0, "nelec": 0, "ms2": 0}
    for attr in line.replace("&FCI", "").split(","):
        if "=" not in attr:
            continue
        key, _, val = attr.partition("=")
        key = key.strip().lower()
        val = val.strip().rstrip(",")
        if key in header and val.lstrip("-").isdigit():
            header[key] = int(val)
    return header


def read(fcidump_file="FCIDUMP", is_tc=False):
    """Read integrals from an FCIDUMP file.

    Returns ``(n_elec, n_orb, e_core, epsilon_p, h_pq, V_pqrs)`` with
    ``V_pqrs`` in physicists' notation, matching the reference reader
    (``pymes/util/fcidump.py:59``).
    """
    if not os.path.exists(fcidump_file):
        raise FileNotFoundError(fcidump_file)

    print_logging_info("Reading " + fcidump_file + "...", level=1)
    print_logging_info("Using TC integrals: ", is_tc, level=2)

    with open(fcidump_file) as reader:
        header = _parse_header(reader)
        n_elec, n_orb = header["nelec"], header["norb"]
        body = reader.read()

    vals = None
    if _native is not None:
        try:
            vals, idx = _native.parse_integral_lines(body)
        except ValueError:  # partial/odd body: retry with the loud path
            vals = None
    if vals is None:
        rows = np.array(body.replace("D", "E").replace("d", "e").split(),
                        dtype=object)
        rows = rows.reshape(-1, 5)
        vals = rows[:, 0].astype(np.float64)
        idx = rows[:, 1:].astype(np.int64)

    e_core = 0.0
    epsilon_p = np.zeros(n_orb)
    h_pq = np.zeros([n_orb, n_orb])
    V_pqrs = np.zeros([n_orb, n_orb, n_orb, n_orb])

    p, r, q, s = idx[:, 0], idx[:, 1], idx[:, 2], idx[:, 3]
    keep = np.abs(vals) >= 1e-19

    two_body = keep & (p != 0) & (q != 0) & (r != 0) & (s != 0)
    pi, qi, ri, si = p[two_body] - 1, q[two_body] - 1, r[two_body] - 1, s[two_body] - 1
    v = vals[two_body]
    if not is_tc:
        # real-orbital Hermitian dump: restore the 4 symmetry images written
        # by the reference reader (pqrs, rqps, rsps->..., see fcidump.py:141)
        V_pqrs[pi, qi, ri, si] = v
        V_pqrs[ri, qi, pi, si] = v
        V_pqrs[ri, si, pi, qi] = v
        V_pqrs[pi, si, ri, qi] = v
    else:
        # TC: only particle-exchange symmetry <pq|rs> = <qp|sr>
        V_pqrs[qi, pi, si, ri] = v
        V_pqrs[pi, qi, ri, si] = v

    core = (p == 0) & (q == 0) & (r == 0) & (s == 0)
    if np.any(core):
        e_core = float(vals[core][-1])

    orb_e = (p != 0) & (q == 0) & (r == 0) & (s == 0)
    epsilon_p[p[orb_e] - 1] = vals[orb_e]

    one_body = keep & (p != 0) & (r != 0) & (q == 0) & (s == 0)
    h_pq[r[one_body] - 1, p[one_body] - 1] = vals[one_body]
    h_pq[p[one_body] - 1, r[one_body] - 1] = vals[one_body]

    return n_elec, n_orb, e_core, epsilon_p, h_pq, V_pqrs


def _symmetry_images(pi, qi, ri, si, v, is_tc):
    """All index images implied by the dump's symmetry class.

    Hermitian (real-orbital) dumps: the 4 images the reference reader
    restores (``pymes/util/fcidump.py:141-150``); TC dumps: only the
    particle-exchange pair ``pqrs ↔ qpsr``.
    """
    if is_tc:
        images = [(pi, qi, ri, si), (qi, pi, si, ri)]
    else:
        images = [(pi, qi, ri, si), (ri, qi, pi, si),
                  (ri, si, pi, qi), (pi, si, ri, qi)]
    P = np.concatenate([im[0] for im in images])
    Q = np.concatenate([im[1] for im in images])
    R = np.concatenate([im[2] for im in images])
    S = np.concatenate([im[3] for im in images])
    return P, Q, R, S, np.tile(v, len(images))


def read_blocks(fcidump_file, no, names=("klij", "ijab", "abij", "iajb",
                                         "iabj", "abcd"), is_tc=False):
    """Stream an FCIDUMP straight into named occ/vir blocks.

    Returns ``(n_elec, n_orb, e_core, epsilon_p, h_pq, dict_of_blocks)``
    without ever materializing the dense nb⁴ ``V_pqrs`` on the host —
    peak memory is the nonzero list plus the requested blocks (the
    molecular counterpart of ``models/ueg.py sparse_to_blocks``; the
    reference leaned on CTF parallel I/O here, ``pymes/util/fcidump.py:25``).

    Block names use the reference's convention: letters i–l map to the
    occupied range ``[0, no)``, a–d to the virtual range ``[no, n_orb)``,
    in the physicists'-order ``V[p,q,r,s]`` axes.
    """
    if not os.path.exists(fcidump_file):
        raise FileNotFoundError(fcidump_file)
    with open(fcidump_file) as reader:
        header = _parse_header(reader)
        n_elec, n_orb = header["nelec"], header["norb"]
        body = reader.read()
    if _native is not None:
        vals, idx = _native.parse_integral_lines(body)
    else:
        rows = np.array(body.replace("D", "E").replace("d", "e").split(),
                        dtype=object).reshape(-1, 5)
        vals = rows[:, 0].astype(np.float64)
        idx = rows[:, 1:].astype(np.int64)

    p, r, q, s = idx[:, 0], idx[:, 1], idx[:, 2], idx[:, 3]
    keep = np.abs(vals) >= 1e-19
    two_body = keep & (p != 0) & (q != 0) & (r != 0) & (s != 0)
    P, Q, R, S, v = _symmetry_images(p[two_body] - 1, q[two_body] - 1,
                                     r[two_body] - 1, s[two_body] - 1,
                                     vals[two_body], is_tc)

    no = int(no)
    nv = n_orb - no
    blocks = {}
    for name in names:
        occ = [c in "ijkl" for c in name]
        shape = [no if o else nv for o in occ]
        block = np.zeros(shape)
        mask = np.ones(len(v), dtype=bool)
        for ax, (ind, o) in enumerate(zip((P, Q, R, S), occ)):
            mask &= (ind < no) if o else (ind >= no)
        sel = [ind[mask] - (0 if o else no)
               for ind, o in zip((P, Q, R, S), occ)]
        block[tuple(sel)] = v[mask]
        blocks[name] = block

    e_core = 0.0
    core = (p == 0) & (q == 0) & (r == 0) & (s == 0)
    if np.any(core):
        e_core = float(vals[core][-1])
    epsilon_p = np.zeros(n_orb)
    orb_e = (p != 0) & (q == 0) & (r == 0) & (s == 0)
    epsilon_p[p[orb_e] - 1] = vals[orb_e]
    h_pq = np.zeros([n_orb, n_orb])
    one_body = keep & (p != 0) & (r != 0) & (q == 0) & (s == 0)
    h_pq[r[one_body] - 1, p[one_body] - 1] = vals[one_body]
    h_pq[p[one_body] - 1, r[one_body] - 1] = vals[one_body]
    return n_elec, n_orb, e_core, epsilon_p, h_pq, blocks


def write(integrals, h, no, e_nuc=0.0, ms2=1, orbsym=1, isym=1, dtype="r",
          file="FCIDUMP"):
    """Write integrals to an FCIDUMP file (dense-array-native rewrite of
    ``pymes/util/fcidump.py:8``, whose CTF ``read_all_nnz`` path is broken
    post-CTF-migration)."""
    n_p = integrals.shape[0]
    with open(file, "w") as f:
        f.write("&FCI\n")
        f.write(" NORB=%i,\n" % n_p)
        f.write(" NELEC=%i,\n" % (no * 2))
        f.write(" MS2=%i,\n" % ms2)
        f.write(" ORBSYM=" + str([orbsym] * n_p).strip("[]") + ",\n")
        f.write(" ISYM=%i,\n" % isym)
        f.write("/\n")

        pi, qi, ri, si = np.nonzero(integrals)
        v = integrals[pi, qi, ri, si]
        for n in range(len(v)):
            f.write("  " + str(v[n]) + "  " + str(pi[n] + 1) + "  "
                    + str(ri[n] + 1) + "  " + str(qi[n] + 1) + "  "
                    + str(si[n] + 1) + "\n")

        hi, hj = np.nonzero(np.abs(h) > 1e-10)
        for n in range(len(hi)):
            f.write("  " + str(h[hi[n], hj[n]]) + "  " + str(hi[n] + 1)
                    + "  " + str(hj[n] + 1) + "  0  0\n")
        f.write(str(e_nuc) + " 0  0  0  0")


def write_h5(file, integrals, h, no, e_nuc=0.0, ms2=1):
    """Binary FCIDUMP: the same nonzero records as :func:`write` but as
    HDF5 datasets (vals float64, idx int64 in file order ``p r q s``) —
    no text parsing on read, and mmap-friendly for large dumps."""
    import h5py
    n_p = integrals.shape[0]
    pi, qi, ri, si = np.nonzero(integrals)
    v2 = integrals[pi, qi, ri, si]
    idx2 = np.stack([pi + 1, ri + 1, qi + 1, si + 1], axis=1)
    hi, hj = np.nonzero(np.abs(h) > 1e-10)
    v1 = h[hi, hj]
    idx1 = np.stack([hi + 1, hj + 1], axis=1)
    with h5py.File(file, "w") as f:
        f.attrs["norb"] = n_p
        f.attrs["nelec"] = no * 2
        f.attrs["ms2"] = ms2
        f.attrs["e_core"] = float(e_nuc)
        f.create_dataset("vals2", data=np.asarray(v2, dtype=np.float64))
        f.create_dataset("idx2", data=idx2.astype(np.int64))
        f.create_dataset("vals1", data=np.asarray(v1, dtype=np.float64))
        f.create_dataset("idx1", data=idx1.astype(np.int64))


def read_h5(file, is_tc=False):
    """Read an HDF5 FCIDUMP written by :func:`write_h5`.

    Returns the same tuple as :func:`read`.
    """
    import h5py
    with h5py.File(file, "r") as f:
        n_orb = int(f.attrs["norb"])
        n_elec = int(f.attrs["nelec"])
        e_core = float(f.attrs["e_core"])
        vals2 = f["vals2"][...]
        idx2 = f["idx2"][...]
        vals1 = f["vals1"][...]
        idx1 = f["idx1"][...]
    V_pqrs = np.zeros([n_orb] * 4)
    pi, ri, qi, si = (idx2[:, k] - 1 for k in range(4))
    P, Q, R, S, v = _symmetry_images(pi, qi, ri, si, vals2, is_tc)
    V_pqrs[P, Q, R, S] = v
    h_pq = np.zeros([n_orb, n_orb])
    h_pq[idx1[:, 0] - 1, idx1[:, 1] - 1] = vals1
    h_pq[idx1[:, 1] - 1, idx1[:, 0] - 1] = vals1
    epsilon_p = np.zeros(n_orb)
    return n_elec, n_orb, e_core, epsilon_p, h_pq, V_pqrs
