"""TCDUMP (transcorrelated 3-body integral) reader/writer.

Format-compatible with the reference (``pymes/util/tcdump.py:6,30``): text
dumps hold ``norb`` on the first line then ``value o p q r s t`` records
(1-based, physicists' notation <opq|rst>) storing a unique triangle of the
6-fold electron-permutation symmetry; values carry the NECI/Molpro ``−1/3``
factor, so the in-memory tensor is ``−3×`` the file values.  HDF5 dumps store
``tcdump/values`` + ``tcdump/indices`` with the same convention.

Storage layout: like the reference, the dense tensor interleaves electron
pairs — axes are (o, r, p, s, q, t), i.e. chemists' pair-adjacent order
(electron pairs (o,r), (p,s), (q,t)).  The 3-body contraction engine
(:mod:`pymes_jax.integral.contraction`) assumes this layout.

The 6-fold symmetry restore is a vectorized scatter over the 6 joint
permutations of the three (ket, bra) pairs instead of the reference's
per-line Python loop.
"""

import itertools
from typing import NamedTuple

import numpy as np

from pymes_jax.log import print_logging_info


class SparseL(NamedTuple):
    """6-index L tensor as its deduplicated nonzero list.

    ``idx`` is (n, 6) int64 in the dense tensor's axis order
    ``(o, r, p, s, q, t)`` (chemists' pair-interleaved), 0-based, with all
    6-fold electron-permutation images expanded; ``vals`` carries the −3×
    in-memory convention.  This is the scalable form of the 3-body
    integrals: nb = 50 would need a 125 GB dense tensor
    (SURVEY §7 'contract on-the-fly from the symmetric nonzero list').
    """

    idx: np.ndarray
    vals: np.ndarray
    nb: int


def _expand_6_fold(idx, vals):
    """All 6 electron-permutation images of physicists' records, dedup'd.

    ``idx`` is (n, 6) 0-based physicists' (o, p, q, r, s, t); rows come
    back in the dense axis order (o, r, p, s, q, t).  Records whose orbit
    is smaller than 6 (coincident pairs) produce duplicate images — they
    are dropped, exactly like the dense scatter's idempotent overwrite.
    """
    ket = [idx[:, 0], idx[:, 1], idx[:, 2]]
    bra = [idx[:, 3], idx[:, 4], idx[:, 5]]
    rows, val_list = [], []
    for per in itertools.permutations(range(3)):
        rows.append(np.stack([ket[per[0]], bra[per[0]],
                              ket[per[1]], bra[per[1]],
                              ket[per[2]], bra[per[2]]], axis=1))
        val_list.append(vals)
    rows = np.concatenate(rows, axis=0)
    allv = np.concatenate(val_list)
    uniq, first = np.unique(rows, axis=0, return_index=True)
    return uniq, allv[first]


def read_sparse(file_name="TCDUMP"):
    """Read a TCDUMP into a :class:`SparseL` nonzero list (no nb⁶ array).

    The sparse counterpart of :func:`read`; consumed directly by the
    contraction engine (``pymes_jax.integral.contraction``).
    """
    print_logging_info("Reading in TCDUMP (sparse)", level=1)
    if "h5" in file_name or "hdf5" in file_name:
        vals, idx, nb = _read_hdf5(file_name)
    else:
        vals, idx, nb = _read_txt(file_name)
    rows, v = _expand_6_fold(idx, vals)
    return SparseL(idx=rows, vals=v, nb=nb)


def sparse_to_dense(sL):
    """Debug path: materialize the dense (nb,)*6 tensor from a SparseL."""
    t_L = np.zeros([sL.nb] * 6)
    o, r, p, s, q, t = sL.idx.T
    t_L[o, r, p, s, q, t] = sL.vals
    return t_L


def _scatter_6_fold(t_L, idx, vals):
    """Scatter values into all 6 electron-permutation images.

    ``idx`` is (n, 6) int array of 0-based physicists' (o, p, q, r, s, t);
    each permutation π of the three electrons maps the record to
    ``L[ket[π0], bra[π0], ket[π1], bra[π1], ket[π2], bra[π2]] = val``.
    """
    ket = [idx[:, 0], idx[:, 1], idx[:, 2]]
    bra = [idx[:, 3], idx[:, 4], idx[:, 5]]
    for per in itertools.permutations(range(3)):
        t_L[ket[per[0]], bra[per[0]],
            ket[per[1]], bra[per[1]],
            ket[per[2]], bra[per[2]]] = vals
    return t_L


def read(file_name="TCDUMP", sym=True, sp=1):
    """Read a TCDUMP into a dense (nb,)*6 array ``L[o,r,p,s,q,t]``
    (chemists' pair-interleaved layout, −3× file values, 6-fold symmetry
    restored; matches ``pymes/util/tcdump.py:30``)."""
    print_logging_info("Reading in TCDUMP", level=1)
    if "h5" in file_name or "hdf5" in file_name:
        print_logging_info("Integral file in hdf5 format.", level=1)
        vals, idx, nb = _read_hdf5(file_name)
    else:
        print_logging_info("Assuming integral file in txt format.", level=1)
        vals, idx, nb = _read_txt(file_name)

    t_L = np.zeros([nb] * 6)
    return _scatter_6_fold(t_L, idx, vals)


def _read_txt(file_name):
    with open(file_name) as reader:
        nb = int(reader.readline().strip())
        body = reader.read()
    try:
        from pymes_jax import _native
        vals, idx = _native.parse_integral_lines(body, ints_per_rec=6)
        vals = -3.0 * vals
        idx = idx - 1
    except Exception:
        rows = np.array(body.split(), dtype=object).reshape(-1, 7)
        vals = -3.0 * rows[:, 0].astype(np.float64)
        idx = rows[:, 1:].astype(np.int64) - 1
    return vals, idx, nb


def _read_hdf5(file_name):
    import h5py

    with h5py.File(file_name, "r") as f:
        vals = -3.0 * np.asarray(f["tcdump"]["values"]).reshape(-1)
        idx = np.asarray(f["tcdump"]["indices"], dtype=np.int64) - 1
        nb = int(f["tcdump"].attrs["nOrbs"])
    return vals, idx, nb


def unique_index(p, q):
    return int(min(p, q) + (max(p, q) - 1) * max(p, q) / 2)


def write(t_L_orpsqt, file_name="TCDUMP", sym=True, type="r", sp=1):
    """Write one canonical representative per 6-fold permutation orbit of a
    dense 6-index L tensor (inverse of :func:`read`; values stored as
    ``−L/3``).

    The canonical entry is the lexicographically smallest (o,p,q,r,s,t)
    under the 6 joint pair permutations.  (The reference writer,
    ``pymes/util/tcdump.py:23``, filters on ``o<=p<=q`` AND an ordering of
    pair indices — conditions that can be jointly unsatisfiable for every
    permutation of an orbit, silently dropping integrals: 87 of 532 nonzero
    entries of the shipped LiH_FNO dump fail its round trip.)
    """
    import itertools

    nb = t_L_orpsqt.shape[0]
    o, r, p, s, q, t = np.nonzero(np.abs(t_L_orpsqt) > 1e-10)
    vals = t_L_orpsqt[o, r, p, s, q, t]
    phys = np.stack([o, p, q, r, s, t], axis=1)   # physicists' (opq|rst)

    # canonical representative: lexicographic min over the 6 permutations
    kets = phys[:, :3]
    bras = phys[:, 3:]
    best = None
    for per in itertools.permutations(range(3)):
        cand = np.concatenate([kets[:, per], bras[:, per]], axis=1)
        if best is None:
            best = cand
            continue
        smaller = np.zeros(len(cand), dtype=bool)
        decided = np.zeros(len(cand), dtype=bool)
        for col in range(6):
            lt = (cand[:, col] < best[:, col]) & ~decided
            gt = (cand[:, col] > best[:, col]) & ~decided
            smaller |= lt
            decided |= lt | gt
        best = np.where(smaller[:, None], cand, best)
    is_canon = np.all(phys == best, axis=1)

    with open(file_name, "w") as f:
        f.write(str(nb) + "\n")
        for n in np.nonzero(is_canon)[0]:
            on, pn, qn, rn, sn, tn = phys[n]
            f.write(str(-vals[n] / 3.0) + " " + str(on + 1) + " "
                    + str(pn + 1) + " " + str(qn + 1) + " " + str(rn + 1)
                    + " " + str(sn + 1) + " " + str(tn + 1) + "\n")
