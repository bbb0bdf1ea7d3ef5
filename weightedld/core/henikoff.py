"""Henikoff position-based sequence weighting (vectorized XLA ops).

Parity contract — reference ``WeightedLD.py:101-151`` (``henikoff_weighting``),
including its verified quirk: the reference's ``unique_base``
(``WeightedLD.py:132``) is ``len(np.unique(count_base[:5, :], axis=0))`` — the
number of *unique rows* of the 5 x n_sites count matrix, a single global
scalar (<= 5), NOT the per-site distinct-symbol count from the Henikoff 1994
paper (that per-site variant is what the reference's Rust port implements,
``lib.rs:363-368``, and the two genuinely diverge — see SURVEY.md §2.4.1).
Because the scalar cancels under max-normalization, the effective Python
formula is ``contribution ∝ 1 / count[own symbol]``.  We reproduce the Python
behaviour exactly, scalar included, so that un-normalized intermediate values
also match.

Ambiguous cells (code 5) are imputed with the site mean contribution
``sum(contrib at site) / n_concrete_alleles_at_site`` (``WeightedLD.py:141-145``
— denominator is the count of codes 0..4, not the distinct-symbol count).

The final weights are max-normalized so the largest weight is exactly 1.0
(``WeightedLD.py:151``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .encode import N_ALLELES, N_CODES, UNKNOWN


def _unique_row_count(rows: jnp.ndarray) -> jnp.ndarray:
    """Number of distinct rows of a small ``[k, S]`` matrix (k = 5 here).

    A row is counted if no earlier row equals it — exactly what
    ``len(np.unique(x, axis=0))`` returns.
    """
    eq = (rows[:, None, :] == rows[None, :, :]).all(axis=-1)   # [k, k]
    k = rows.shape[0]
    earlier = jnp.tril(jnp.ones((k, k), dtype=bool), k=-1)
    is_dup = (eq & earlier).any(axis=1)
    return (~is_dup).sum()


def _counts_and_own(alignment: jnp.ndarray, dtype):
    """Shared stanza of the sequence-major weighting variants: per-site
    code histogram ``[6, S]`` plus each cell's own-symbol count ``[N, S]``.

    ``own`` uses one-hot selects, not take_along_axis: six vectorized
    compare-and-multiply passes fuse into one elementwise kernel, where an
    [N, S]-indexed gather is a data-dependent load per cell.
    """
    counts = jnp.stack(
        [
            (alignment == alignment.dtype.type(s)).sum(axis=0)
            for s in range(N_CODES)
        ],
        axis=0,
    ).astype(dtype)                                                   # [6, S]
    own = sum(
        counts[c][None, :] * (alignment == alignment.dtype.type(c))
        for c in range(N_CODES)
    )                                                                 # [N, S]
    return counts, own



def henikoff_weights_host(alignment) -> "np.ndarray":
    """Float64 host (NumPy) twin of :func:`henikoff_weights` — the ingest
    default for host-visible alignments (mirroring the host-f64 / device-f32
    split that ``core/sites.py`` uses for the masks).

    Bit-equal to the executed reference's ``henikoff_weighting``
    (``WeightedLD.py:101-151``): every arithmetic step runs in float64 with
    the reference's operand grouping — the per-cell denominator is the
    single product ``unique_base * own_count`` before the reciprocal, the
    imputation mean divides the pre-imputation site total by the concrete
    count, and the row/column reductions are whole-array ``np.sum`` calls
    (NumPy pairwise summation), so the results carry identical bits, which
    makes weights-TSV parity unconditional instead of empirically-f32-
    tested.  One deliberate divergence (shared with every variant here): a
    site with ZERO concrete alleles imputes 0 instead of the reference's
    0/0 NaN, which would otherwise poison all weights through the final
    max-normalization (reachable only via the unmasked VCF path).

    The device variants stay the serving path (f32, on-device); this twin
    needs O(N*S) float64 host memory, so pod-scale ingests use
    :func:`henikoff_weights_large` instead (see ``pipeline._weights_for``).
    """
    import numpy as np

    aln = np.asarray(alignment)
    n_sites = aln.shape[1]
    counts = np.stack(
        [(aln == s).sum(axis=0) for s in range(N_CODES)]
    ).astype(np.float64)                                       # [6, S]
    # The reference's verified quirk: ONE global scalar = the number of
    # unique rows of the 0..4 count matrix (module docstring).  It cancels
    # under max-normalization but participates in each f64 rounding, so
    # bit-parity requires keeping it.
    unique_base = float(len(np.unique(counts[:N_ALLELES], axis=0)))
    ok = aln != UNKNOWN
    own = counts[aln, np.arange(n_sites)[None, :]]             # [N, S]
    contrib = np.zeros(aln.shape, dtype=np.float64)
    np.divide(1.0, unique_base * own, out=contrib, where=ok)
    concrete_total = counts[:N_ALLELES].sum(axis=0)            # [S]
    site_avg = np.zeros(n_sites, dtype=np.float64)
    np.divide(contrib.sum(axis=0), concrete_total, out=site_avg,
              where=concrete_total > 0)
    contrib = np.where(ok, contrib, site_avg[None, :])
    weights = contrib.sum(axis=1)
    # Degenerate zero-site / all-ambiguous inputs have max == 0: keep the
    # reference's 0/0 NaN result (callers gate on < 2 sites before use),
    # just without numpy's warning — the f32 device paths are silent too.
    with np.errstate(invalid="ignore"):
        return weights / weights.max()


@partial(jax.jit, static_argnames=("dtype",))
def henikoff_weights(alignment: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    """Per-sequence Henikoff weights, max-normalized to 1.0.

    Args:
        alignment: ``[n_seqs, n_sites]`` int8 code matrix (only sites of
            interest should be included; the caller applies the HK/LD mask).
    Returns:
        ``[n_seqs]`` weights in ``dtype``.
    """
    counts, own = _counts_and_own(alignment, dtype)
    unique_base = _unique_row_count(counts[:N_ALLELES]).astype(dtype)

    ok = alignment != UNKNOWN
    # 1 / (unique_base * count[own]); ambiguous cells contribute 0 for now.
    # (own >= 1 wherever ok; the maximum() guard only protects the masked
    # lanes from generating inf that the where() would discard anyway.)
    contrib = jnp.where(ok, 1.0 / (unique_base * jnp.maximum(own, 1.0)), 0.0)

    # Mean imputation for ambiguous cells: site total over the number of
    # concrete (codes 0..4) alleles at that site.  Guarded: a site with
    # zero concrete alleles would otherwise impute 0/0 = NaN into EVERY
    # sequence via max-normalization (the reference NaN-poisons here —
    # possible only on the unmasked VCF path; we contribute 0 instead).
    concrete_total = counts[:N_ALLELES].sum(axis=0)                         # [S]
    site_avg = contrib.sum(axis=0) / jnp.maximum(concrete_total, 1.0)
    contrib = jnp.where(ok, contrib, site_avg[None, :])

    weights = contrib.sum(axis=1)
    return weights / weights.max()


@partial(jax.jit, static_argnames=("dtype",))
def henikoff_weights_paper(alignment: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    """The Henikoff 1994 *paper* formula — the reference's Rust variant
    (``lib.rs:340-380``): per-site contribution ``1/(distinct_known *
    count[own symbol])`` with per-site distinct-symbol counts, and unknown
    cells imputed with ``site_total / distinct_known`` (NOT the mean over
    concrete sequences — a verified Rust deviation, SURVEY.md §2.4.1).
    Offered as an alternative weighting; the default is Python parity.
    """
    weights = _henikoff_partial_sums(alignment, dtype=dtype, variant="paper")
    return weights / weights.max()


@partial(jax.jit, static_argnames=("dtype", "variant"))
def _henikoff_partial_sums(alignment: jnp.ndarray, dtype=jnp.float32,
                           variant: str = "python"):
    """Un-normalized per-sequence contribution sums for one site chunk.

    Both formulas are per-site additive, so chunking over sites is exact:
    ``python`` omits the global ``unique_base`` scalar (it cancels under the
    final max-normalization — see module docstring); ``paper`` is the
    per-site Rust formula of :func:`henikoff_weights_paper`."""
    counts, own = _counts_and_own(alignment, dtype)
    ok = alignment != UNKNOWN
    if variant == "paper":
        distinct = (counts[:N_ALLELES] > 0).sum(axis=0).astype(dtype)
        contrib = jnp.where(ok, 1.0 / jnp.maximum(distinct * own, 1.0), 0.0)
        imputed = contrib.sum(axis=0) / jnp.maximum(distinct, 1.0)
        contrib = jnp.where(ok, contrib, imputed[None, :])
        return contrib.sum(axis=1)
    contrib = jnp.where(ok, 1.0 / jnp.maximum(own, 1.0), 0.0)
    concrete_total = counts[:N_ALLELES].sum(axis=0)
    # Guarded like henikoff_weights: a zero-concrete site contributes 0
    # instead of NaN-poisoning every weight.
    site_avg = contrib.sum(axis=0) / jnp.maximum(concrete_total, 1.0)
    contrib = jnp.where(ok, contrib, site_avg[None, :])
    return contrib.sum(axis=1)


@partial(jax.jit, static_argnames=("n_seqs", "dtype"))
def henikoff_weights_site_major(
    codes_sm: jnp.ndarray, n_seqs: int, dtype=jnp.float32
) -> jnp.ndarray:
    """Python-formula Henikoff weights from the kernel's site-major layout.

    Runs directly on the ``[S_pad, N_pad]`` int8 device buffer an
    :class:`~weightedld.runtime.driver.LdSession` already uploaded
    (padding = UNKNOWN on both axes), so pod-scale sessions can weight
    on-device without a second host->device pass of the alignment.

    Padding interacts with the reference's mean imputation
    (``WeightedLD.py:141-145``): UNKNOWN cells are imputed with the site
    mean, which would hand padded *sequences* nonzero weights — so rows
    ``>= n_seqs`` are explicitly zeroed before max-normalization.  Padded
    *sites* are all-UNKNOWN: their concrete count is 0 and the guarded
    mean is 0, contributing nothing.  Matches :func:`henikoff_weights` on
    the unpadded matrix exactly (same ops, scalar ``unique_base`` omitted
    as it cancels — module docstring).
    """
    counts = jnp.stack(
        [
            (codes_sm == codes_sm.dtype.type(s)).sum(axis=1)
            for s in range(N_CODES)
        ],
        axis=1,
    ).astype(dtype)                                            # [S_pad, 6]
    own = sum(  # one-hot select instead of a per-cell gather
        counts[:, c:c + 1] * (codes_sm == codes_sm.dtype.type(c))
        for c in range(N_CODES)
    )
    ok = codes_sm != UNKNOWN
    contrib = jnp.where(ok, 1.0 / jnp.maximum(own, 1.0), 0.0)  # [S_pad, N_pad]
    concrete_total = counts[:, :N_ALLELES].sum(axis=1)         # [S_pad]
    site_avg = contrib.sum(axis=1) / jnp.maximum(concrete_total, 1.0)
    contrib = jnp.where(ok, contrib, site_avg[:, None])
    weights = contrib.sum(axis=0)                              # [N_pad]
    weights = jnp.where(jnp.arange(weights.shape[0]) < n_seqs, weights, 0.0)
    return weights / weights.max()


def henikoff_weights_host_site_major(
    codes_sm, n_sites: int, n_seqs: int, row_chunk: int = 4096
) -> "np.ndarray":
    """Float64 host Henikoff weights (Python formula,
    ``WeightedLD.py:101-151``) from a SITE-MAJOR (possibly padded) buffer —
    the weighting stage of the streaming VCF ingest
    (:func:`weightedld.runtime.ingest.session_from_vcf`).

    Column ``k`` of the buffer is alignment row ``k`` (the readers'
    contract, ``io/vcf.py:read_vcf_site_major``), so the returned weights
    index exactly like :func:`henikoff_weights_host`'s.

    Same per-cell arithmetic as the host twin — f64, the reference's
    global ``unique_base`` scalar included, the same operand grouping —
    but per-sequence totals accumulate over ``row_chunk``-site chunks
    (bounded peak memory: one ``[row_chunk, N]`` f64 block) instead of one
    whole-array ``np.sum``, so the result can differ from the twin's in
    the last ~1-2 f64 ulps per weight (summation-order only; tested to
    <= 1e-12 relative and identical at the 6-dp weights-TSV floor).
    """
    import numpy as np

    from .sites import site_histogram_host_site_major

    codes_sm = np.asarray(codes_sm)
    # Pass 1 (cheap, integer): full per-site histogram for the reference's
    # global unique_base scalar (unique rows of the [5, S] count matrix in
    # its f64 form — henikoff_weights_host and module docstring).
    counts_all = site_histogram_host_site_major(
        codes_sm, n_sites, n_seqs, row_chunk=row_chunk
    )                                                          # [S, 5]
    unique_base = float(
        len(np.unique(counts_all.T.astype(np.float64), axis=0))
    )

    total = np.zeros(n_seqs, dtype=np.float64)
    for lo in range(0, n_sites, row_chunk):
        hi = min(lo + row_chunk, n_sites)
        blk = codes_sm[lo:hi, :n_seqs]                         # [B, N] int8
        b = hi - lo
        cnt = np.stack(
            [(blk == c).sum(axis=1) for c in range(N_CODES)], axis=1
        ).astype(np.float64)                                   # [B, 6]
        ok = blk != UNKNOWN
        own = cnt[np.arange(b)[:, None], blk]                  # [B, N]
        contrib = np.zeros(blk.shape, dtype=np.float64)
        np.divide(1.0, unique_base * own, out=contrib, where=ok)
        concrete = cnt[:, :N_ALLELES].sum(axis=1)              # [B]
        site_avg = np.zeros(b, dtype=np.float64)
        np.divide(contrib.sum(axis=1), concrete, out=site_avg,
                  where=concrete > 0)
        contrib = np.where(ok, contrib, site_avg[:, None])
        total += contrib.sum(axis=0)
    with np.errstate(invalid="ignore"):
        return total / total.max()


def henikoff_weights_large(
    alignment, site_chunk: int = 16384, dtype=jnp.float32,
    variant: str = "python",
) -> jnp.ndarray:
    """Chunked Henikoff weighting for pod-scale alignments.

    Accumulates per-sequence contribution sums over site chunks (bounded
    device memory), then max-normalizes.  The normalized result equals
    :func:`henikoff_weights` (or :func:`henikoff_weights_paper` for
    ``variant="paper"``) because per-site contributions are additive and
    the reference's global scalar cancels.
    """
    n, s = alignment.shape
    total = jnp.zeros(n, dtype=dtype)
    for lo in range(0, s, site_chunk):
        chunk = jnp.asarray(alignment[:, lo : lo + site_chunk])
        total = total + _henikoff_partial_sums(chunk, dtype=dtype,
                                               variant=variant)
    return total / total.max()
