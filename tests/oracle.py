"""Test-suite aliases for the package's f64 audit engine
(weightedld.core.reference_impl) — the executable reference spec."""

from weightedld.core.reference_impl import (
    reference_henikoff as oracle_henikoff,
    reference_ld as oracle_ld,
    reference_pair as oracle_pair,
    reference_variable_sites as oracle_variable_sites,
)

__all__ = ["oracle_henikoff", "oracle_ld", "oracle_pair",
           "oracle_variable_sites"]
