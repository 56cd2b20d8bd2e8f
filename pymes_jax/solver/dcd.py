"""DCD — distinguishable cluster doubles (CCD with ``is_dcd=True``).

Parity with ``pymes/solver/dcd.py:7`` (minus its stale CTF import).
"""

from pymes_jax.solver.ccd import CCD


class DCD(CCD):
    def __init__(self, no, **kwargs):
        kwargs.pop("is_dcd", None)
        super().__init__(no, is_dcd=True, **kwargs)
