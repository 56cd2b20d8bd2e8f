"""Alias package: reference-compatible import path ``pymes_jax.model.ueg``
(the array-native implementation lives in ``pymes_jax.models``)."""

from pymes_jax.models import ueg  # noqa: F401
