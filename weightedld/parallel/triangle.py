"""Site-pair upper-triangle tiling and device striping.

The scale-out axis of this framework is the upper triangle of the S x S
site-pair matrix (S kept sites -> S(S-1)/2 pairs).  Like the reference's Rust
driver (``lib.rs:589-679``) we split it into square tiles of side ``tile``;
unlike the reference (rayon work-stealing over a linear tile index,
``lib.rs:623-637``) we *pre-enumerate* the tile list host-side (it is tiny:
~S^2 / 2T^2 entries) and stripe it across chips, which gives deterministic,
near-perfectly-balanced static sharding that XLA/pjit can compile against.

Diagonal tiles are half-populated (the reference notes the same,
``lib.rs:650-653``); striping interleaves them across shards so every shard
gets the same mix of full and half tiles.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class TilePlan:
    """Static plan for one all-pairs run."""

    n_sites: int          # S: number of (kept) sites
    tile: int             # tile side T
    s_pad: int            # S padded to a multiple of T
    grid: int             # number of tile rows/cols = s_pad // T
    tile_i: np.ndarray    # [n_tiles] int32 tile-row indices (i <= j)
    tile_j: np.ndarray    # [n_tiles] int32 tile-col indices

    @property
    def n_tiles(self) -> int:
        return len(self.tile_i)

    @property
    def n_pairs(self) -> int:
        """True number of site pairs S(S-1)/2."""
        return self.n_sites * (self.n_sites - 1) // 2


def plan_tiles(n_sites: int, tile: int = 128,
               max_site_distance: int | None = None,
               max_bp_distance: int | None = None,
               site_map=None,
               cross_split: int | None = None) -> TilePlan:
    """Enumerate upper-triangle tiles (including diagonal tiles) row-major.

    Row-major order keeps each tile-row's A-block hot across consecutive
    tiles of a batch (the cache-locality argument of ``lib.rs:589-611``).

    ``max_site_distance``: windowed-LD mode — drop tiles whose nearest pair
    is farther apart than this many sites (the in-tile remainder is masked by
    the engine), turning the O(S^2) triangle into an O(S*W) band.

    ``max_bp_distance`` (with ``site_map``, non-decreasing): the same band
    pruning in SITE_MAP units (base pairs for VCF input — PLINK-style
    ``--ld-window-kb`` semantics; original column indices for FASTA),
    dropping tiles whose NEAREST pair spans more than this: tile (i, j>i)'s
    closest pair is (last site of row-tile i, first site of col-tile j).
    Composes with ``max_site_distance`` (intersection).

    ``cross_split``: rectangular (inter-region) mode — keep only tiles that
    can contain a pair (a < split <= b), i.e. whose row tile intersects
    block A ([0, split)) and whose column tile intersects block B
    ([split, S)); the in-tile remainder is masked by the engine.  The
    triangle's O(S^2/2) becomes O(|A|*|B|).
    """
    if n_sites < 2:
        raise ValueError("need at least 2 sites")
    s_pad = cdiv(n_sites, tile) * tile
    grid = s_pad // tile
    ti, tj = np.triu_indices(grid)
    if max_site_distance is not None:
        # Closest pair of tile (i, j>i): site distance (j-i-1)*T + 1.
        near = (tj - ti - 1) * tile < max_site_distance
        ti, tj = ti[near], tj[near]
    if max_bp_distance is not None:
        sm = np.asarray(site_map)
        if sm.shape[0] != n_sites:
            raise ValueError("site_map length must equal n_sites")
        g = np.arange(grid)
        # Clamp to true sites: tiles fully in padding never contain kept
        # pairs, their positions only need to be finite.
        row_end = sm[np.minimum((g + 1) * tile, n_sites) - 1]
        col_start = sm[np.minimum(g * tile, n_sites - 1)]
        near = (ti == tj) | (col_start[tj] - row_end[ti] <= max_bp_distance)
        ti, tj = ti[near], tj[near]
    if cross_split is not None:
        if not 0 < cross_split < n_sites:
            raise ValueError(
                f"cross_split must be in 1..{n_sites - 1}, got {cross_split}")
        hit = (ti * tile < cross_split) & ((tj + 1) * tile > cross_split)
        ti, tj = ti[hit], tj[hit]
    return TilePlan(
        n_sites=n_sites,
        tile=tile,
        s_pad=s_pad,
        grid=grid,
        tile_i=ti.astype(np.int32),
        tile_j=tj.astype(np.int32),
    )


def _per_tile_minmax(vals: np.ndarray, n_sites: int, tile: int,
                     grid: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-tile (min, max) of a per-site value array under padding: pad
    sites get +inf/-inf sentinels so pad-only tiles match no interval."""
    v = np.asarray(vals, dtype=np.int64)
    lo = np.full(grid * tile, np.iinfo(np.int64).max // 2, dtype=np.int64)
    hi = np.full(grid * tile, np.iinfo(np.int64).min // 2, dtype=np.int64)
    lo[:n_sites] = v
    hi[:n_sites] = v
    return (lo.reshape(grid, tile).min(axis=1),
            hi.reshape(grid, tile).max(axis=1))


def plan_tiles_permuted(n_sites: int, tile: int,
                        max_site_distance: int | None = None,
                        max_bp_distance: int | None = None,
                        orig_idx=None, site_map=None) -> TilePlan:
    """Windowed tile plan for a PERMUTED site layout (unsafe-site packing
    under windowed LD — driver round 5).

    :func:`plan_tiles`'s band pruning assumes layout order == genomic
    order (nearest pair of tile (i, j) sits at the facing corners).  After
    a packing permutation that no longer holds, but tile-level pruning
    still does: a tile pair can only contain an in-window pair if the two
    tiles' ORIGINAL-position intervals come within the window.  This
    builds the plan from per-tile [min, max] intervals of ``orig_idx``
    (site-index windows) and/or ``site_map`` (bp windows) — a superset of
    the needed pairs (the engine's exact per-pair lookup mask trims the
    rest), and exactly the band plan when the permutation is identity.

    With the class-split packing permutation (clean sites in original
    order, then dirty sites in original order) the clean block's intervals
    are contiguous and ascending, so clean x clean tile pairs reproduce a
    band at most as wide as the unpermuted one; dirty tiles (scattered
    positions -> wide intervals) pair with every block they genuinely
    window against."""
    if n_sites < 2:
        raise ValueError("need at least 2 sites")
    s_pad = cdiv(n_sites, tile) * tile
    grid = s_pad // tile
    ti, tj = np.triu_indices(grid)
    near = np.ones(len(ti), dtype=bool)
    if max_site_distance is not None:
        if orig_idx is None:
            raise ValueError("site-index window on a permuted layout "
                             "needs orig_idx")
        lo, hi = _per_tile_minmax(orig_idx, n_sites, tile, grid)
        near &= ((lo[tj] - hi[ti] <= max_site_distance)
                 & (lo[ti] - hi[tj] <= max_site_distance))
    if max_bp_distance is not None:
        sm = np.asarray(site_map)
        if sm.shape[0] != n_sites:
            raise ValueError("site_map length must equal n_sites")
        lo, hi = _per_tile_minmax(sm, n_sites, tile, grid)
        near &= ((lo[tj] - hi[ti] <= max_bp_distance)
                 & (lo[ti] - hi[tj] <= max_bp_distance))
    ti, tj = ti[near], tj[near]
    return TilePlan(
        n_sites=n_sites,
        tile=tile,
        s_pad=s_pad,
        grid=grid,
        tile_i=ti.astype(np.int32),
        tile_j=tj.astype(np.int32),
    )


def tile_pair_counts(plan: TilePlan) -> np.ndarray:
    """True (in-triangle, padding-excluded) pair count of every tile.

    Off-diagonal tiles carry ``h * w`` pairs (their row range is entirely
    below their col range), diagonal tiles ``h (h - 1) / 2`` — the
    reference notes the same half-full diagonal tiles, ``lib.rs:650-653``.
    For windowed plans this counts the tile's full in-triangle pairs (the
    engine's in-tile window mask is not subtracted)."""
    t = plan.tile
    s = plan.n_sites
    i0 = plan.tile_i.astype(np.int64) * t
    j0 = plan.tile_j.astype(np.int64) * t
    h = np.clip(s - i0, 0, t)
    w = np.clip(s - j0, 0, t)
    return np.where(plan.tile_i == plan.tile_j, h * (h - 1) // 2, h * w)


def pairs_per_shard(plan: TilePlan, n_shards: int) -> np.ndarray:
    """Exact true-pair count each shard evaluates under :func:`stripe` —
    the static load-balance table of PERF.md, recomputed live (used by
    ``bench.py --pod``).  For an all-pairs plan the shard counts sum to
    ``plan.n_pairs`` exactly."""
    counts = tile_pair_counts(plan)
    n = plan.n_tiles
    per_shard = cdiv(n, n_shards)
    out = np.zeros(n_shards, dtype=np.int64)
    for d in range(n_shards):
        src = d + np.arange(per_shard) * n_shards
        out[d] = counts[src[src < n]].sum()
    return out


def stripe(plan: TilePlan, n_shards: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stripe tiles across shards: shard d owns tiles d, d+n, d+2n, ...

    Returns ``(tile_i, tile_j, emit)`` arrays of shape
    ``[n_shards * per_shard]`` laid out shard-major (shard d's tiles are the
    contiguous block ``[d*per_shard, (d+1)*per_shard)``), padded with
    non-emitting duplicate tiles so every shard has equal work.
    """
    n = plan.n_tiles
    per_shard = cdiv(n, n_shards)
    total = per_shard * n_shards
    idx = np.arange(total)
    # shard-major layout: position p of shard d holds global tile d + p*n_shards
    shard = idx // per_shard
    pos = idx % per_shard
    src = shard + pos * n_shards
    emit = src < n
    src = np.minimum(src, n - 1)
    return (
        plan.tile_i[src].astype(np.int32),
        plan.tile_j[src].astype(np.int32),
        emit,
    )
