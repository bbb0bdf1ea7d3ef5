"""Tiled LD evaluation over explicit tile lists (XLA path).

Evaluates :func:`weightedld.core.paircore.ld_pair_tile` for a batch of
(tile_i, tile_j) site-tile coordinates via ``vmap`` + ``dynamic_slice``.  This
is the f32 reference path of the streaming driver (``engine="xla"``);
:mod:`weightedld.core.tile_engine` is the integer engine with the same
contract.

Padding convention: the alignment is padded along sites to a multiple of the
tile size with code 5 (unknown) columns — padded sites produce all-zero
joint tables and are additionally masked out via the global pair-validity
mask (i < j < S).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .encode import UNKNOWN
from .paircore import PairStats, ld_pair_tile


def pad_alignment(alignment: np.ndarray, tile: int) -> np.ndarray:
    """Pad ``[N, S]`` codes to ``[N, S_pad]`` with UNKNOWN columns."""
    n, s = alignment.shape
    s_pad = -(-s // tile) * tile
    if s_pad == s:
        return alignment
    out = np.full((n, s_pad), UNKNOWN, dtype=alignment.dtype)
    out[:, :s] = alignment
    return out


@partial(jax.jit, static_argnames=("tile", "n_sites"))
def tile_stats_batch(
    codes_pad: jnp.ndarray,
    weights: jnp.ndarray,
    tile_i: jnp.ndarray,
    tile_j: jnp.ndarray,
    emit: jnp.ndarray,
    *,
    tile: int,
    n_sites: int,
) -> PairStats:
    """LD statistics for a batch of site-pair tiles.

    Args:
        codes_pad: ``[N, S_pad]`` int8 codes (site-padded with code 5).
        weights: ``[N]`` per-sequence weights.
        tile_i / tile_j: ``[K]`` int32 tile coordinates (tile_i <= tile_j).
        emit: ``[K]`` bool — False for padding tiles (their pairs are dropped).
        tile: tile side T (static).
        n_sites: true S before padding (static).
    Returns:
        :class:`PairStats` of ``[K, T, T]`` arrays; ``keep`` already includes
        the strict-upper-triangle and in-range masks.
    """
    n = codes_pad.shape[0]

    def one(ti, tj, em):
        a = jax.lax.dynamic_slice(codes_pad, (0, ti * tile), (n, tile))
        b = jax.lax.dynamic_slice(codes_pad, (0, tj * tile), (n, tile))
        st = ld_pair_tile(a, b, weights)
        gi = ti * tile + jnp.arange(tile, dtype=jnp.int32)[:, None]
        gj = tj * tile + jnp.arange(tile, dtype=jnp.int32)[None, :]
        valid = (gi < gj) & (gj < n_sites) & em
        return PairStats(st.d, st.d_prime, st.r2, st.keep & valid)

    return jax.vmap(one)(tile_i, tile_j, emit)


# Slot-driven compaction intermediate budget (bytes); above this (and above
# the mask domain's own footprint) the sort-based path wins.  Module-level
# so tests can force the fallback at small shapes.
_SLOT_BYTES_CAP = 1 << 28


def round_fixed_exact(x: jnp.ndarray, scale: int,
                      neg_zero_sentinel: bool = False) -> jnp.ndarray:
    """Correctly-rounded ``round_half_even(x * scale)`` of the REAL product,
    in pure f32 — int32 result.

    ``scale = 10^d`` (d <= 4) is exactly representable, and the f64
    promotion of an f32 ``x`` times ``10^d`` is EXACT (24 + 14 mantissa
    bits < 53), so CPython's ``round(float(x), d)`` — correctly-rounded
    decimal rounding of that f64, ties half-even — picks the integer
    nearest the real number ``x * scale``.  This function computes the
    same integer in f32 on the device: a Dekker two-product
    recovers the exact f32-multiply residual ``e``, the residual-corrected
    remainder decides the boundary cases, and exact .5 remainders tie to
    even.  Misclassification is impossible: near any half-integer
    boundary (|y| >= 0.49) the true product lies on a grid of spacing
    >= scale * 2^-24 * |x| >> the f32 comparison noise, so it is either
    exactly ON the boundary or far from it.  The transported fixed-point
    value therefore formats byte-identically to the f32 path's
    ``repr(round(x, d))``.

    ``neg_zero_sentinel``: return -32768 for q == 0 with a negative ``x``
    (e.g. D = -3e-5 at d=4) so the decoder can restore ``-0.0`` — Python
    prints ``-0.0`` for those — without colliding with real quanta
    (|q| <= 32767 by the caller's range guarantee |x| * scale < 2^15-1).
    Off for never-negative stats (r2), whose 16 bits decode unsigned."""
    s = jnp.float32(scale)
    y = x * s
    split = jnp.float32((1 << 12) + 1)  # Dekker 12-bit split constant
    cx = x * split
    xh = cx - (cx - x)
    xl = x - xh
    cs = s * split
    sh = cs - (cs - s)
    sl = s - sh
    e = ((xh * sh - y) + xh * sl + xl * sh) + xl * sl  # y + e == x*s exactly
    q0 = jnp.round(y)
    frac = y - q0             # exact: y and q0 are both multiples of ulp(q0)
    # True remainder R = frac + e must be compared against +-0.5, but that
    # ADDITION can round exactly ONTO 0.5 and fake a tie (e.g. f32(-0.055)
    # at scale 100: y lands exactly on -5.5, e = +3e-8, and -0.5 + e
    # rounds back to -0.5).  Compare exactly instead: R > 0.5 <=>
    # (frac - 0.5) > -e, with frac -+ 0.5 exact whenever |frac| is near
    # 0.5 (both operands are multiples of ulp >= 2^-25 there).
    a_hi = frac - 0.5
    a_lo = frac + 0.5
    qi = q0.astype(jnp.int32)
    odd = (qi & 1) == 1
    inc = (a_hi > -e) | ((a_hi == -e) & odd)
    dec = (a_lo < -e) | ((a_lo == -e) & odd)
    q = qi + inc.astype(jnp.int32) - dec.astype(jnp.int32)
    if neg_zero_sentinel:
        q = jnp.where((q == 0) & jnp.signbit(x), jnp.int32(-(1 << 15)), q)
    return q


@partial(jax.jit, static_argnames=("tile", "capacity", "wire_scale"))
def compact_tile_stats(
    stats: PairStats,
    tile_i: jnp.ndarray,
    tile_j: jnp.ndarray,
    r2_threshold: float,
    *,
    tile: int,
    capacity: int,
    wire_scale: int | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray] | tuple[jnp.ndarray,
                                                          jnp.ndarray]:
    """Device-side record compaction (the PairStore idea, ``lib.rs:523-576``,
    under XLA static shapes).

    Flattens a batch of tiles, filters ``keep & (r2 > threshold)``, and packs
    surviving records into a fixed-capacity buffer.

    Returns (``wire_scale=None``):
        count: scalar int32 — true number of surviving records (may exceed
            ``capacity``; caller must detect overflow and retry bigger).
        sites: ``[capacity, 2]`` int32 global site indices (i, j).
        values: ``[capacity, 3]`` float32 (D, D', r2).
        Slots past ``count`` hold garbage; caller trims.

    ``wire_scale = 10^d`` (d <= 4) selects the COMPRESSED 12-byte wire
    format for d-decimal text output — 40% fewer transport bytes than the
    20-byte sites+f32 block, byte-identical formatted output (the
    quantizer is :func:`round_fixed_exact`, exactly Python's
    ``round(x, d)``; D' rides as raw f32 bits because its zero-denominator
    fallback values are unbounded/NaN).  Returns ``(count,
    packed [capacity, 3] int32)``:

    * word 0: ``tile_in_batch << 18 | i_local << 9 | j_local`` — requires
      ``tile <= 512`` and ``len(tile_i) <= 2^14`` (caller-gated).
    * word 1: low 16 bits D quantum (int16; -32768 encodes ``-0.0``),
      high 16 bits r2 quantum (uint16 — r2 >= +0 always).
    * word 2: D' f32 bit pattern.
    """
    t = tile
    # Strict > threshold (Rust lib.rs:661); pass -inf for "emit everything"
    # (kept pairs have all four marginal frequencies strictly positive —
    # paircore keep rules — so their r2 is non-NaN and nothing is lost).
    mask = stats.keep & (stats.r2 > r2_threshold)

    # Compaction WITHOUT jnp.nonzero when capacity is moderate:
    # nonzero(size=) sorts the full K*T^2 domain.  Instead: the mask rows
    # are BIT-PACKED into [K*T, T/16] 16-bit groups BY A DOT (row @
    # powers-of-two pattern matrix — bf16 products are exact powers of
    # two, the f32 accumulator holds sums < 2^16 exactly), and only the
    # ``capacity`` OUTPUT SLOTS do real work — each slot binary-searches
    # its source row in the exclusive row-offset table, gathers that
    # row's T/16 mask GROUPS (16x fewer gathered bytes than a [cap, T]
    # row gather), and selects its survivor's bit by popcount prefix + an
    # in-group 4-step binary search.  (Whether this beats a plain
    # nonzero/cumsum compaction on the GPU is an open measurement,
    # ROADMAP S5.)  Record order stays (tile, row, col) — identical to the
    # original prefix-sum formulation.
    #
    # The [capacity, T/16] intermediates keep the slot path O(cap*T/16)
    # memory; the sort fallback remains for capacities approaching the
    # domain size (a no-threshold stream buckets capacity up to ~2x the
    # batch's pair count — extraction is inherently O(domain) there).
    slot_bytes = capacity * (t // 16) * 4
    use_slots = (t % 16 == 0
                 and slot_bytes <= max(_SLOT_BYTES_CAP, 4 * mask.size))
    slot = jnp.arange(capacity, dtype=jnp.int32)
    if use_slots:
        ng = t // 16
        rows8 = mask.reshape(-1, t).astype(jnp.bfloat16)     # [K*T, T]
        cc = jnp.arange(t, dtype=jnp.int32)
        pat = jnp.where(
            (cc[:, None] // 16) == jnp.arange(ng, dtype=jnp.int32)[None, :],
            jnp.exp2((cc % 16).astype(jnp.float32))[:, None], 0.0,
        ).astype(jnp.bfloat16)                               # [T, T/16]
        groups = jax.lax.dot_general(
            rows8, pat, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        ).astype(jnp.int32)                                  # [K*T, T/16]
        ones = jnp.ones((t, 1), jnp.bfloat16)
        row_counts = jax.lax.dot_general(
            rows8, ones, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )[:, 0].astype(jnp.int32)                            # [K*T]
        offs = jnp.cumsum(row_counts) - row_counts           # exclusive
        count = row_counts.sum().astype(jnp.int32)

        rr = jnp.searchsorted(offs, slot, side="right").astype(jnp.int32) - 1
        rr = jnp.clip(rr, 0, groups.shape[0] - 1)
        rank = slot - offs[rr]                               # rank in row
        groups_r = groups[rr]                                # [cap, T/16]
        pp = jnp.cumsum(
            jax.lax.population_count(groups_r).astype(jnp.int32), axis=1)
        g_i = jnp.sum((pp <= rank[:, None]).astype(jnp.int32), axis=1)
        g_i = jnp.clip(g_i, 0, ng - 1)
        prev = jnp.where(
            g_i > 0,
            jnp.take_along_axis(pp, jnp.maximum(g_i - 1, 0)[:, None],
                                axis=1)[:, 0],
            0,
        )
        grp = jnp.take_along_axis(groups_r, g_i[:, None], axis=1)[:, 0]
        r_in = rank - prev                                   # rank in group
        # 4-step binary search for the (r_in+1)-th set bit: q = largest
        # prefix length with popcount(grp & low_mask(q)) <= r_in.
        q = jnp.zeros_like(r_in)
        for step in (8, 4, 2, 1):
            low = (jnp.int32(1) << (q + step)) - 1           # q+step <= 15
            p = jax.lax.population_count(grp & low).astype(jnp.int32)
            q = jnp.where(p <= r_in, q + step, q)
        col = jnp.clip(g_i * 16 + q, 0, t - 1)

        kt = rr // t                                         # tile in batch
        i_loc = rr % t
        j_loc = col
        src = rr * t + col
    else:
        flat = mask.reshape(-1)
        count = flat.sum().astype(jnp.int32)
        (src,) = jnp.nonzero(flat, size=capacity, fill_value=0)
        src = src.astype(jnp.int32)
        kt = src // (t * t)
        within = src % (t * t)
        i_loc = within // t
        j_loc = within % t

    if use_slots:
        # Gather whole ROWS (contiguous loads) rather than single
        # elements (flat[src]), and select
        # the column with a vectorized one-hot sum over the [cap, T]
        # block.  The sum runs on the int32 BIT PATTERNS, not the floats:
        # a float masked-sum would turn an exactly -0.0 stat into +0.0
        # (-0.0 + 0.0 == +0.0), silently bypassing the wire's
        # neg_zero_sentinel; summing one nonzero int32 word against
        # zeros reproduces the selected element bit-for-bit (and a
        # NaN/inf elsewhere in the row is zeroed before the sum).
        jl = j_loc[:, None]
        lane = jnp.arange(t, dtype=jnp.int32)[None, :]

        def take(x):
            rows = x.reshape(-1, t)[rr]                      # [cap, T]
            bits = jax.lax.bitcast_convert_type(
                rows.astype(jnp.float32), jnp.int32)
            sel = jnp.where(lane == jl, bits, 0).sum(axis=1)
            return jax.lax.bitcast_convert_type(sel, jnp.float32)
    else:
        take = lambda x: x.reshape(-1)[src]
    live = slot < count                  # zero dead slots: determinism
    if wire_scale is not None:
        w0 = (kt << 18) | (i_loc << 9) | j_loc
        qd = round_fixed_exact(take(stats.d).astype(jnp.float32),
                               wire_scale, neg_zero_sentinel=True)
        qr = round_fixed_exact(take(stats.r2).astype(jnp.float32),
                               wire_scale)
        w1 = (qd & 0xFFFF) | (qr << 16)
        w2 = jax.lax.bitcast_convert_type(
            take(stats.d_prime).astype(jnp.float32), jnp.int32)
        packed = jnp.stack([w0, w1, w2], axis=1)
        return count, jnp.where(live[:, None], packed, 0)
    gi = tile_i[kt] * t + i_loc
    gj = tile_j[kt] * t + j_loc
    sites = jnp.stack([gi, gj], axis=1)
    values = jnp.stack(
        [take(stats.d), take(stats.d_prime), take(stats.r2)], axis=1
    ).astype(jnp.float32)
    sites = jnp.where(live[:, None], sites, -1)
    values = jnp.where(live[:, None], values, 0.0)
    return count, sites, values
