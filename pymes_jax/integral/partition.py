"""Occupied/virtual partition of the two-body integral tensor.

Produces the same 16 named blocks as the reference
(``pymes/integral/partition.py:4``).  Blocks are plain (jnp or numpy) array
views/slices; in sharded mode the virtual axes of the large blocks (``abcd``,
``abij``, ``ijab``, …) carry sharding constraints applied by
:mod:`pymes_jax.parallel`.

Index convention (physicists'): ``V[p,q,r,s] = <pq|rs>``; letters i..l are
occupied, a..d virtual.  Block name "iabj" means V[o, v, v, o] etc.
TC Hamiltonians are non-Hermitian, so e.g. ``ijab`` and ``abij`` are
independent blocks — never derived from one another.
"""

BLOCK_NAMES = (
    "abci", "iabj", "iajk", "aijk", "klij", "aibj", "ijak", "abic",
    "iajb", "abcd", "iabc", "aijb", "ijka", "aibc", "ijab", "abij",
)

OCC_LETTERS = set("ijkl")

_SLICE = {"o": lambda no: slice(None, no), "v": lambda no: slice(no, None)}


def _block_slices(name, no):
    kinds = ["o" if c in "ijkl" else "v" for c in name]
    return tuple(_SLICE[k](no) for k in kinds)


def part_2_body_int(no, t_V_pqrs):
    """Slice V_pqrs into the dict of 16 named o/v blocks."""
    return {name: t_V_pqrs[_block_slices(name, no)] for name in BLOCK_NAMES}
