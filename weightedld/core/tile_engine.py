"""The tiled pair engine: integer contractions plus a branch-free finalize.

Evaluates a batch of K site-tile pairs ``(tile_i[k], tile_j[k])`` over the
padded SITE-MAJOR code matrix (``[S_pad, N_pad]`` int8, UNKNOWN-padded on
both axes — :func:`weightedld.core.majmin.pad_alignment_site_major`)
and returns :class:`~weightedld.core.paircore.PairStats` of ``[K, T,
T]`` arrays: D, D', r2 and the keep mask (every skip rule, the strict
upper triangle, the true-site bound and the batch's emit flags folded in).

Two forms share one finalize algebra (:func:`pair_algebra`, reference
semantics ``WeightedLD.py:183-284``):

* :func:`tile_stats_majmin` — the FACTORIZED form.  When the reference's
  per-pair allele recomputation provably degenerates to per-site major /
  dominant-minor alleles (no UNKNOWN anywhere, or count margins that
  absorb every per-pair removal — ``core.majmin``), the four weighted
  {maj,dmin} x {maj,dmin} haplotype cells of a tile pair are ONE
  ``(2T x N) @ (N x 2T)`` contraction per weight level, independent of the
  alphabet.
* :func:`tile_stats_general` — the per-pair form: one-hot planes over the
  present alleles, the weighted ``(pT x pT)`` joint, the per-pair
  post-filter allele counts as two contractions against the other site's
  validity plane (``#{A==s, B valid}`` is exactly the reference's
  ``np.unique`` recount, ``WeightedLD.py:194-211``), and the per-pair
  major/dominant-minor selection.

Weight arithmetic (static): the default ``wquant="int8x3"`` cascade
``w ~= sum_l a_l q_l`` (``core.majmin.pad_weights_int8``) runs every level
as ONE int8 x int8 -> int32 contraction — the levels are stacked along the
row axis of one operand, so a batch is a single integer GEMM — with exact
integer accumulation; only the per-level scale-combine rounds (f32).
``"int8"`` is the lossy 2-level cascade.  ``""`` is the split-bf16 pair
``w = bf16(w) + bf16(w - bf16(w))`` with f32 accumulation;
``exact_weights`` (bf16-representable weights) drops its residual pass and
``unit_weights`` drops the weights entirely (one int8 count contraction).
No float32 matrix product runs anywhere, so no TF32 demotion can occur.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .encode import N_ALLELES
from .majmin import ALL_PLANES
from .paircore import PairStats


def _gather_tiles(codes_sm: jnp.ndarray, tiles: jnp.ndarray,
                  tile: int) -> jnp.ndarray:
    """``[S_pad, N_pad]`` -> ``[K, T, N_pad]``: the rows of each tile."""
    s_pad, n_pad = codes_sm.shape
    return codes_sm.reshape(s_pad // tile, tile, n_pad)[tiles]


def _bdot(x: jnp.ndarray, y: jnp.ndarray, out_dtype) -> jnp.ndarray:
    """Batched ``[K, R, N] x [K, C, N] -> [K, R, C]`` contraction over N."""
    return jax.lax.dot_general(
        x, y, (((2,), (2,)), ((0,), (0,))), preferred_element_type=out_dtype)


def n_weight_levels(exact_weights: bool, unit_weights: bool,
                    wquant: str) -> int:
    """Rows of the batch's stacked weighted operand per indicator row."""
    if unit_weights:
        return 1
    if wquant in ("int8", "int8x3") and not exact_weights:
        return 2 if wquant == "int8" else 3
    return 1 if exact_weights else 2


def weighted_joint(x8: jnp.ndarray, y8: jnp.ndarray,
                   weights_row: jnp.ndarray, *, exact_weights: bool,
                   unit_weights: bool, wquant: str) -> jnp.ndarray:
    """``sum_n w_n x[k, r, n] y[k, c, n]`` for {0,1} int8 indicators
    ``x8 [K, R, N]`` and ``y8 [K, C, N]`` -> ``[K, R, C]`` f32.

    ``weights_row`` layout follows the mode: ``[1, N]`` f32 weights for
    the unit/bf16 modes, ``[2L, N]`` (q rows, then scale rows) for the
    int8 cascades (``pad_weights_int8``)."""
    k, r, n = x8.shape
    f32 = jnp.float32
    if unit_weights:
        return _bdot(x8, y8, jnp.int32).astype(f32)
    nlev = n_weight_levels(exact_weights, unit_weights, wquant)
    if wquant in ("int8", "int8x3") and not exact_weights:
        q = weights_row[:nlev].astype(jnp.int8)                  # [L, N]
        # indicator * q fits int8 exactly (|q| <= 127).
        xq = (x8[:, None] * q[None, :, None, :]).reshape(k, nlev * r, n)
        cells = _bdot(xq, y8, jnp.int32).reshape(k, nlev, r, -1)
        acc = weights_row[nlev, 0] * cells[:, 0].astype(f32)
        for lv in range(1, nlev):
            acc = acc + weights_row[nlev + lv, 0] * cells[:, lv].astype(f32)
        return acc
    w = weights_row[0]
    w_hi = w.astype(jnp.bfloat16)
    passes = [w_hi]
    if not exact_weights:
        passes.append((w - w_hi.astype(f32)).astype(jnp.bfloat16))
    wp = jnp.stack(passes)                                       # [P, N]
    xw = (x8.astype(jnp.bfloat16)[:, None] * wp[None, :, None, :]).reshape(
        k, nlev * r, n)
    cells = _bdot(xw, y8.astype(jnp.bfloat16), f32).reshape(k, nlev, r, -1)
    acc = cells[:, 0]
    for lv in range(1, nlev):
        acc = acc + cells[:, lv]
    return acc


def pair_algebra(n_mm, n_md, n_dm, n_dd, keep):
    """Branch-free D/D'/r2 from the four weighted {maj,dmin} x {maj,dmin}
    haplotype cells, plus the reference's frequency-based skip rules —
    element-wise over a pair block (reference semantics
    ``WeightedLD.py:227-284``; see ``paircore.finalize_pair_tile`` for
    the rule derivations).

    Every sum and product is grouped so that swapping the pair's sites
    (``n_md <-> n_dm``, A <-> B) gives bit-identical results: the site
    permutations of the driver (unsafe-site packing) then change no
    output bit."""
    total_w = (n_mm + n_dd) + (n_md + n_dm)
    keep = keep & (total_w > 0)
    safe_w = jnp.where(total_w > 0, total_w, 1.0)
    inv_w = 1.0 / safe_w

    pa_major = (n_mm + n_md) * inv_w
    pb_major = (n_mm + n_dm) * inv_w
    pa_minor = (n_dm + n_dd) * inv_w
    pb_minor = (n_md + n_dd) * inv_w
    # round(P,1)==1.0 <=> P >= double(0.95) (np.float64.__round__ scales
    # by 10 and half-evens UP at the boundary — see paircore).
    keep = keep & (pa_major < 0.95) & (pb_major < 0.95)
    # Zero-major-weight pairs: the reference crashes there (masked PA /
    # PB at WeightedLD.py:227-235), so they are skipped.
    keep = keep & (n_mm + n_md > 0) & (n_mm + n_dm > 0)

    obs_mm = n_mm * inv_w
    obs_md = n_md * inv_w
    obs_dm = n_dm * inv_w
    obs_dd = n_dd * inv_w

    # The reference's D is the mean of four estimates pa*pb - p_mm, ...
    # (WeightedLD.py:260-266), each of which equals p_md*p_dm - p_mm*p_dd
    # once the four cells sum to one.  That product form is evaluated
    # here: in f32 the estimates cancel O(1) terms down to a small D and
    # lose up to ~1e-6 of r2 at rare alleles, the products do not.
    d = (n_md * n_dm - n_mm * n_dd) * (inv_w * inv_w)

    neg = jnp.maximum(-obs_dd, -obs_mm)
    neg = jnp.where(neg == 0, jnp.minimum(-obs_dd, -obs_mm), neg)
    pos = jnp.minimum(obs_dm, obs_md)
    pos = jnp.where(pos == 0, jnp.maximum(obs_dm, obs_md), pos)
    denom = jnp.where(d < 0, neg, pos)
    d_prime = d / denom

    r2 = d * d / ((pa_major * pa_minor) * (pb_major * pb_minor))
    return d, d_prime, r2, keep


def _valid_pairs(tile_i, tile_j, emit, tile: int, n_sites: int):
    """``[K, T, T]`` strict-upper-triangle / true-site / emit mask."""
    li = jnp.arange(tile, dtype=jnp.int32)
    gi = tile_i[:, None, None] * tile + li[None, :, None]
    gj = tile_j[:, None, None] * tile + li[None, None, :]
    return (gi < gj) & (gj < n_sites) & (emit != 0)[:, None, None]


@partial(jax.jit, static_argnames=("tile", "n_sites", "exact_weights",
                                   "unit_weights", "wquant"))
def tile_stats_majmin(
    codes_sm: jnp.ndarray,     # [S_pad, N_pad] int8 site-major codes
    weights_row: jnp.ndarray,  # mode-dependent layout (weighted_joint)
    aux: jnp.ndarray,          # [S_pad, 3] int32 (major, dmin, distinct)
    tile_i: jnp.ndarray,       # [K] int32
    tile_j: jnp.ndarray,       # [K] int32
    emit: jnp.ndarray,         # [K] int32 (0/1)
    *,
    tile: int,
    n_sites: int,
    exact_weights: bool = False,
    unit_weights: bool = False,
    wquant: str = "",
) -> PairStats:
    """Factorized major/dmin form (see the module docstring).
    Precondition: per-site major/dmin/distinct (``aux``, from
    ``core.majmin.majmin_site_aux``) equal every dispatched pair's
    per-pair values — no UNKNOWN anywhere, or the margin proofs of
    ``core.majmin`` hold for every dispatched tile pair."""
    t = tile
    a = _gather_tiles(codes_sm, tile_i, t)                  # [K, T, N]
    b = _gather_tiles(codes_sm, tile_j, t)
    aux3 = aux.reshape(-1, t, 3)
    aa, ab = aux3[tile_i], aux3[tile_j]                     # [K, T, 3]

    def select(c, ax):
        # Rows [0, T): major-allele indicator; [T, 2T): dominant minor.
        ax8 = ax.astype(jnp.int8)
        return jnp.concatenate([
            (c == ax8[..., 0:1]).astype(jnp.int8),
            (c == ax8[..., 1:2]).astype(jnp.int8),
        ], axis=1)                                          # [K, 2T, N]

    cells = weighted_joint(select(a, aa), select(b, ab), weights_row,
                           exact_weights=exact_weights,
                           unit_weights=unit_weights, wquant=wquant)
    n_mm, n_md = cells[:, :t, :t], cells[:, :t, t:]
    n_dm, n_dd = cells[:, t:, :t], cells[:, t:, t:]
    # Monomorphic-pair skip (WeightedLD.py:196-201), per site under the
    # precondition; padded sites carry distinct == 0.
    keep = (aa[:, :, 2:3] > 1) & (ab[:, None, :, 2] > 1)
    d, d_prime, r2, keep = pair_algebra(n_mm, n_md, n_dm, n_dd, keep)
    keep = keep & _valid_pairs(tile_i, tile_j, emit, t, n_sites)
    return PairStats(d=d, d_prime=d_prime, r2=r2, keep=keep)


@partial(jax.jit, static_argnames=("tile", "n_sites", "planes",
                                   "exact_weights", "unit_weights", "wquant"))
def tile_stats_general(
    codes_sm: jnp.ndarray,     # [S_pad, N_pad] int8 site-major codes
    weights_row: jnp.ndarray,  # mode-dependent layout (weighted_joint)
    tile_i: jnp.ndarray,       # [K] int32
    tile_j: jnp.ndarray,       # [K] int32
    emit: jnp.ndarray,         # [K] int32 (0/1)
    *,
    tile: int,
    n_sites: int,
    planes: tuple = ALL_PLANES,
    exact_weights: bool = False,
    unit_weights: bool = False,
    wquant: str = "",
) -> PairStats:
    """General per-pair form (see the module docstring): valid for any
    input, including UNKNOWN cells that change a pair's alleles.

    ``planes`` restricts the alphabet to the codes present (binary SNP
    data: 3 or 2 planes instead of 5); validity is the union of the
    planes, so out-of-plane codes are excluded from the per-pair counts
    exactly like UNKNOWN."""
    t = tile
    p = len(planes)
    a = _gather_tiles(codes_sm, tile_i, t)                  # [K, T, N]
    b = _gather_tiles(codes_sm, tile_j, t)
    k = a.shape[0]

    def onehot(c):
        return jnp.concatenate(
            [(c == s).astype(jnp.int8) for s in planes], axis=1)  # [K,pT,N]

    def valid(c):
        v = c == planes[0]
        for s in planes[1:]:
            v = v | (c == s)
        return v.astype(jnp.int8)                           # [K, T, N]

    xa, yb = onehot(a), onehot(b)
    jw = weighted_joint(xa, yb, weights_row, exact_weights=exact_weights,
                        unit_weights=unit_weights, wquant=wquant)
    jw = jw.reshape(k, p, t, p, t)
    # Per-pair post-filter allele counts: cnt_a[s] = #{A==s, B valid},
    # cnt_b[u] = #{A valid, B==u} (WeightedLD.py:194-211), exact int32.
    cnt_a = _bdot(xa, valid(b), jnp.int32).reshape(k, p, t, t)
    cnt_b = _bdot(valid(a), yb, jnp.int32).reshape(k, t, p, t)
    cnt_a = [cnt_a[:, s] for s in range(p)]                 # [K, T, T]
    cnt_b = [cnt_b[:, :, u] for u in range(p)]

    def major_dmin(cnt):
        # Integer score 8*count + (5 - code): ties -> lower code
        # (WeightedLD.py:203-209).
        scores = [c * 8 + (N_ALLELES - planes[s]) for s, c in enumerate(cnt)]
        best = jnp.full(scores[0].shape, -1, jnp.int32)
        best_idx = jnp.zeros(scores[0].shape, jnp.int32)
        for s, sc in enumerate(scores):
            better = sc > best
            best = jnp.where(better, sc, best)
            best_idx = jnp.where(better, s, best_idx)
        second = jnp.full(scores[0].shape, -1, jnp.int32)
        second_idx = jnp.zeros(scores[0].shape, jnp.int32)
        for s, sc in enumerate(scores):
            better = (sc > second) & (best_idx != s)
            second = jnp.where(better, sc, second)
            second_idx = jnp.where(better, s, second_idx)
        return best_idx, second_idx

    maj_a, dmin_a = major_dmin(cnt_a)
    maj_b, dmin_b = major_dmin(cnt_b)
    distinct_a = sum((c > 0).astype(jnp.int32) for c in cnt_a)
    distinct_b = sum((c > 0).astype(jnp.int32) for c in cnt_b)
    keep = (distinct_a > 1) & (distinct_b > 1)      # WeightedLD.py:196-201

    # Select the four {maj,dmin} x {maj,dmin} cells of the weighted joint.
    zero = jnp.zeros((k, t, t), jnp.float32)
    row_maj, row_dmin = [], []
    for u in range(p):
        rm = rd = zero
        for s in range(p):
            cell = jw[:, s, :, u, :]
            rm = rm + jnp.where(maj_a == s, cell, 0.0)
            rd = rd + jnp.where(dmin_a == s, cell, 0.0)
        row_maj.append(rm)
        row_dmin.append(rd)
    n_mm = n_md = n_dm = n_dd = zero
    for u in range(p):
        sel_m, sel_d = maj_b == u, dmin_b == u
        n_mm = n_mm + jnp.where(sel_m, row_maj[u], 0.0)
        n_md = n_md + jnp.where(sel_d, row_maj[u], 0.0)
        n_dm = n_dm + jnp.where(sel_m, row_dmin[u], 0.0)
        n_dd = n_dd + jnp.where(sel_d, row_dmin[u], 0.0)

    d, d_prime, r2, keep = pair_algebra(n_mm, n_md, n_dm, n_dd, keep)
    keep = keep & _valid_pairs(tile_i, tile_j, emit, t, n_sites)
    return PairStats(d=d, d_prime=d_prime, r2=r2, keep=keep)
