"""Host-side preparation for the tiled pair engine.

Engine-neutral numpy helpers shared by the session driver, the streamed
ingest and the tests:

* layout: :func:`pad_alignment_site_major` (``[N, S]`` -> padded
  ``[S_pad, N_pad]`` site-major int8, the layout the engine uploads) and
  the weight packers (:func:`pad_weights`, :func:`pad_weights_int8`);
* alphabet: :func:`detect_planes_unknown` (the allele planes present, and
  whether any UNKNOWN cell exists);
* the factorized major/dominant-minor form: :func:`majmin_site_aux`
  (per-site major / dominant minor / distinct count) and the exactness
  proofs that decide where it applies (:func:`majmin_safe_with_unknown`,
  :func:`majmin_site_margins`, :func:`majmin_tile_margins`).
"""

from __future__ import annotations

import numpy as np

from .encode import N_ALLELES, N_CODES, UNKNOWN

# Sequence-axis padding multiple of the site-major layout: N_pad is a
# multiple of it, which keeps the integer contraction's depth aligned.
DEFAULT_SEQ_CHUNK = 128

ALL_PLANES = (0, 1, 2, 3, 4)


def pad_alignment_site_major(alignment: np.ndarray, tile: int,
                             seq_chunk: int = DEFAULT_SEQ_CHUNK) -> np.ndarray:
    """``[N, S]`` sequence-major codes -> ``[S_pad, N_pad]`` site-major,
    padded with UNKNOWN (code 5) on both axes.

    Large matrices route through the native blocked OpenMP transpose
    (``wldio_transpose_pad_i8``), which is several times faster than
    numpy's strided ``out[:s, :n] = a.T`` on GB-scale inputs.  The numpy
    path below doubles as the parity oracle (tests/test_native_io.py)."""
    n, s = alignment.shape
    s_pad = -(-s // tile) * tile
    n_pad = -(-n // seq_chunk) * seq_chunk
    if alignment.size >= (1 << 24) and alignment.dtype == np.int8:
        from ..io import native

        if native.available():
            return native.transpose_pad_i8(alignment, s_pad, n_pad, UNKNOWN)
    out = np.full((s_pad, n_pad), UNKNOWN, dtype=np.int8)
    out[:s, :n] = alignment.T
    return out


def pad_weights(weights: np.ndarray,
                seq_chunk: int = DEFAULT_SEQ_CHUNK) -> np.ndarray:
    """``[N]`` weights -> ``[1, N_pad]`` f32, zero-padded."""
    n = weights.shape[0]
    n_pad = -(-n // seq_chunk) * seq_chunk
    out = np.zeros((1, n_pad), dtype=np.float32)
    out[0, :n] = weights
    return out


def pad_weights_int8(
    weights: np.ndarray, seq_chunk: int = DEFAULT_SEQ_CHUNK,
    levels: int = 2,
) -> np.ndarray:
    """Weights packed for the integer weight passes: ``[2*levels, N_pad]``
    f32 with rows q1..qL (integers in [-127, 127]) then a1..aL (the scales,
    broadcast), where ``w ~= sum_l a_l * q_l``.

    Cascaded int8 quantization: ``a1 = max|w|/127``, ``q1 = round(w/a1)``;
    each residual ``r_l = r_{l-1} - a_l*q_l`` (``|r_l| <= a_l/2``) is
    re-quantized at the next level.  Per-weight ABSOLUTE error bounds for
    max-normalized weights:

    - ``levels=2`` (``wquant="int8"``): ``<= max|w|/64516 ~= 1.6e-5``.
      When weights span orders of magnitude (VCF Henikoff weights
      0.001..1.0) small weights lose relative accuracy (~1.6% at w=0.001)
      and 4-dp outputs can shift by one rounding ulp.
    - ``levels=3`` (``wquant="int8x3"``, the default): ``<= max|w| *
      2^-23.97 ~= 6.1e-8`` — one f32 ulp of the max weight, i.e. at the
      f32 representation error of the weights themselves.  The integer
      joints accumulate exactly; only the per-level scale-combine rounds.
    """
    n = weights.shape[0]
    n_pad = -(-n // seq_chunk) * seq_chunk
    w32 = np.zeros(n_pad, dtype=np.float32)
    w32[:n] = np.asarray(weights, dtype=np.float32)
    out = np.zeros((2 * levels, n_pad), dtype=np.float32)
    r = w32.astype(np.float64)  # exact residual cascade
    for lv in range(levels):
        s = float(np.abs(r).max())
        if s <= 0.0:
            break
        # The engine recombines with the f32-rounded scale: cascade the
        # residual against THAT value so the bound holds end-to-end.
        a = np.float32(s / 127.0)
        q = np.round(r / float(a)).clip(-127, 127)
        out[lv] = q
        out[levels + lv] = a
        r = r - float(a) * q
    return out


def weights_bf16_exact(weights: np.ndarray) -> bool:
    """True when every weight is exactly representable in bf16 (simple
    fractions): one bf16 weight pass is then exact."""
    import ml_dtypes

    w = np.asarray(weights, dtype=np.float32)
    return bool((w.astype(ml_dtypes.bfloat16).astype(np.float32) == w).all())


def detect_planes_unknown(alignment: np.ndarray) -> tuple:
    """``(planes, has_unknown)``: the allele planes actually present (codes
    0..4) and whether any UNKNOWN (code 5) cell exists.

    SNP matrices from VCFs are usually {0, 1, 4}: dropping absent planes
    shrinks the general contraction quadratically (3 planes = 36% of the
    5-plane work) with bit-identical results, since absent alleles have
    zero counts everywhere and can never be selected as major/dominant-
    minor.

    ``has_unknown`` gates the factorized major/dmin form
    (:func:`weightedld.core.tile_engine.tile_stats_majmin`): with no
    UNKNOWN anywhere, the reference's per-pair allele recomputation
    (``WeightedLD.py:183-211``) degenerates to per-site quantities.
    """
    # Presence scan, chunked with early exit once every code is seen
    # (np.bincount expands int8 to int64 and np.unique sorts: both are
    # much slower on GB-scale matrices).
    n_rows = alignment.shape[0]
    row_bytes = max(1, alignment.shape[1] if alignment.ndim > 1 else 1)
    step = max(1, (1 << 24) // row_bytes)          # ~16 MB row chunks
    found = [False] * N_CODES
    for lo in range(0, n_rows, step):
        chunk = alignment[lo:lo + step]
        for c in range(N_CODES):
            if not found[c] and (chunk == c).any():
                found[c] = True
        if all(found):
            break
    planes = tuple(c for c in range(N_ALLELES) if found[c])
    if len(planes) < 2:
        planes = ALL_PLANES  # degenerate input; keep the general form
    return planes, found[UNKNOWN]


def detect_planes(alignment: np.ndarray) -> tuple:
    """Allele planes actually present (codes 0..4) — see
    :func:`detect_planes_unknown`."""
    return detect_planes_unknown(alignment)[0]


def majmin_safe_with_unknown(alignment: np.ndarray | None,
                             counts: np.ndarray | None = None,
                             n_seqs: int | None = None) -> bool:
    """True when the factorized form is exact DESPITE UNKNOWN cells.

    For a pair (i, j) the reference drops sequences with UNKNOWN at either
    site before recomputing major/dmin (``WeightedLD.py:183-211``).  Site
    i's per-pair counts therefore differ from its global counts by at most
    ``U_max = max_j #UNKNOWN(site j)`` decrements spread over its codes.
    The per-site major/dmin identities — and the distinct>1 verdict — are
    stable under ANY such removal when, per site, with descending counts
    ``c1 >= c2 >= c3`` over codes 0..4:

    * ``c2 == 0``: the site is monomorphic and every pair touching it is
      skipped either way (removals cannot create new alleles); or
    * ``c1 - c2 > U_max`` (major cannot be overtaken, nor tie) and
      ``c2 - c3 > U_max`` (the dominant minor cannot be overtaken; it also
      keeps ``c2' > 0``, preserving distinct > 1).

    The weighted {maj,dmin} cells are exact automatically: the maj/dmin
    indicator of a site already excludes that site's UNKNOWNs, and a
    sequence UNKNOWN at the other site fails that side's indicator — so
    given stable maj/dmin the factorized cells equal the general form's
    selected cells.
    """
    from .sites import site_histogram_host

    if counts is None:
        counts = site_histogram_host(alignment)
    counts = counts.astype(np.int64)
    if n_seqs is None:
        n_seqs = alignment.shape[0]  # counts-only callers pass it explicitly
    u_max = int((n_seqs - counts.sum(axis=1)).max())
    if u_max == 0:
        return True  # no UNKNOWN anywhere: nothing is ever removed
    top = np.sort(counts, axis=1)[:, ::-1]                      # desc
    c1, c2, c3 = top[:, 0], top[:, 1], top[:, 2]
    safe = (c2 == 0) | ((c1 - c2 > u_max) & (c2 - c3 > u_max))
    return bool(safe.all())


def majmin_site_aux(alignment: np.ndarray | None, s_pad: int,
                    counts: np.ndarray | None = None) -> np.ndarray:
    """Per-site ``[s_pad, 3]`` int32 (major, dominant-minor, distinct) for
    the factorized form, from the host alignment or its ``[S, 5]`` counts.

    Semantics are exactly the general form's per-pair ``major_dmin`` rule:
    integer score ``8 * count + (5 - code)`` over codes 0..4, argmax for
    major, argmax excluding it for the dominant minor — count ties break
    to the SMALLER code (the deterministic rule of this framework; the
    reference's per-pair pick at ties is unspecified, SURVEY §2.4.11).
    Padded sites carry distinct == 0, so every pair touching them is
    dropped."""
    if counts is None:
        from .sites import site_histogram_host

        counts = site_histogram_host(alignment)
    counts = counts.astype(np.int64)                            # [S, 5]
    s = counts.shape[0]
    score = counts * 8 + (N_ALLELES - np.arange(N_ALLELES))[None, :]
    maj = score.argmax(axis=1)
    score[np.arange(s), maj] = -1
    dmin = score.argmax(axis=1)
    aux = np.zeros((s_pad, 3), dtype=np.int32)
    aux[:s, 0] = maj
    aux[:s, 1] = dmin
    aux[:s, 2] = (counts > 0).sum(axis=1)
    return aux


_MARGIN_INF = np.int64(1) << 62


def majmin_tile_margins(counts: np.ndarray, n_seqs: int, tile: int,
                        grid: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-site-TILE ``(stability_margin, unknown_max)`` for the hybrid
    safe/unsafe tile-pair partition (the per-tile refinement of
    :func:`majmin_safe_with_unknown`).

    For a pair (a, b) the reference drops sequences UNKNOWN at either site
    before recomputing major/dmin (``WeightedLD.py:183-211``), so site a's
    per-pair counts differ from its global counts by at most ``u(b)``
    decrements (``u(x)`` = UNKNOWN count at site x) — NOT the global
    ``U_max``.  Site a's maj/dmin identities and its distinct>1 verdict are
    stable under any ``m`` removals when ``c2 == 0`` (monomorphic: every
    pair touching it is skipped either way) or
    ``min(c1-c2, c2-c3) > m`` with descending counts; and trivially exact
    when ``m == 0`` (nothing is removed — even count TIES are fine, both
    forms then see identical counts).

    Tile granularity makes this a cheap static test the plan can consume:
    with ``stab(T) = min`` site margin and ``umax(T) = max`` site u over a
    tile's real sites, the tile pair (Ti, Tj) is factorized-exact iff

        (umax(Tj) == 0  or  stab(Ti) > umax(Tj)) and
        (umax(Ti) == 0  or  stab(Tj) > umax(Ti))

    — in particular clean x clean tile pairs (no UNKNOWN on either side,
    the overwhelming majority for real FASTA with sparse ambiguity codes)
    are ALWAYS exact.  Padded tail sites carry margin = +inf / u = 0 (their
    pairs are dropped via distinct == 0 anyway).

    Returns ``(stab [grid] int64, umax [grid] int64)``; monomorphic and
    padded sites contribute margin ``_MARGIN_INF``.
    """
    margin, u = majmin_site_margins(counts, n_seqs)
    s = counts.shape[0]
    s_pad = grid * tile
    mpad = np.full(s_pad, _MARGIN_INF, dtype=np.int64)
    mpad[:s] = margin
    upad = np.zeros(s_pad, dtype=np.int64)
    upad[:s] = u
    return (mpad.reshape(grid, tile).min(axis=1),
            upad.reshape(grid, tile).max(axis=1))


def majmin_site_margins(counts: np.ndarray, n_seqs: int,
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Per-SITE ``(stability_margin, unknown_count)`` — the site-granular
    quantities :func:`majmin_tile_margins` folds per tile, exposed for the
    driver's unsafe-site PACKING permutation: sites with ``u > 0`` are the
    only ones that can poison a partner tile, so grouping them into the
    trailing tiles makes every clean x clean tile pair (the bulk of the
    triangle) trivially factorized-exact regardless of margins."""
    counts = counts.astype(np.int64)
    u = n_seqs - counts.sum(axis=1)
    top = np.sort(counts, axis=1)[:, ::-1]
    c1, c2, c3 = top[:, 0], top[:, 1], top[:, 2]
    margin = np.where(c2 == 0, _MARGIN_INF, np.minimum(c1 - c2, c2 - c3))
    return margin, u
