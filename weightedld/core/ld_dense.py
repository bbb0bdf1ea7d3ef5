"""Single-shot dense all-pairs LD (small/medium S).

Computes the full ``[S, S]`` pair-statistics tensor in one XLA program.
This is the reference execution path used for parity tests and small inputs;
the tiled/streaming driver (``weightedld.runtime.driver``) and its integer
tile engine (``weightedld.core.tile_engine``) cover large S.

Reference behaviour being reproduced: the doubly-nested loop in
``WeightedLD.py:177-284`` over the strict upper triangle of retained sites.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .paircore import PairStats, ld_pair_tile


class LdRecords(NamedTuple):
    """Flat, host-side LD output records (upper triangle, surviving pairs)."""

    pos_a: np.ndarray   # int64 site positions (via site_map)
    pos_b: np.ndarray
    d: np.ndarray
    d_prime: np.ndarray
    r2: np.ndarray

    def __len__(self) -> int:
        return len(self.pos_a)


@jax.jit
def ld_all_pairs_dense(alignment: jnp.ndarray, weights: jnp.ndarray) -> PairStats:
    """All-pairs LD statistics.

    Args:
        alignment: ``[N, S]`` int8 code matrix (LD-masked sites only).
        weights: ``[N]`` per-sequence weights.
    Returns:
        :class:`PairStats` with ``[S, S]`` arrays (full matrix; callers take
        the strict upper triangle).
    """
    return ld_pair_tile(alignment, alignment, weights)


def extract_records(
    stats: PairStats,
    site_map: np.ndarray,
    r2_threshold: float | None = None,
) -> LdRecords:
    """Strict-upper-triangle surviving pairs as flat host arrays.

    ``r2_threshold``: if set, keep only pairs with ``r2 > threshold`` (strict
    ``>``, matching the Rust reference ``lib.rs:659-667``; the Python
    reference prints every surviving pair — pass ``None`` for that).
    """
    d = np.asarray(stats.d)
    dp = np.asarray(stats.d_prime)
    r2 = np.asarray(stats.r2)
    keep = np.asarray(stats.keep)

    s = d.shape[0]
    iu = np.triu_indices(s, k=1)
    mask = keep[iu]
    if r2_threshold is not None:
        mask = mask & (r2[iu] > r2_threshold)

    ia, ib = iu[0][mask], iu[1][mask]
    site_map = np.asarray(site_map)
    # Index the survivors directly: d[iu][mask] would materialize a full
    # S(S-1)/2 temporary per stat before masking.
    return LdRecords(
        pos_a=site_map[ia],
        pos_b=site_map[ib],
        d=d[ia, ib],
        d_prime=dp[ia, ib],
        r2=r2[ia, ib],
    )
