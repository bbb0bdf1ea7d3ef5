"""Streaming VCF -> device session ingest (bounded host memory).

The reference reads the WHOLE file (and, via gzip text mode, inflates the
whole stream) into memory before parsing (``WeightedLD.py:311-379``), then
builds the ``[S, N]`` matrix and rotates it — about three matrices' worth
of peak host RAM plus the full decompressed text.  Chromosome-scale
``.vcf.gz`` (tens of GB decompressed) cannot ingest that way.

This module chains the streaming pieces end-to-end so peak host memory is
ONE padded site-major matrix (the buffer the engine uploads):

* :func:`weightedld.io.vcf.scan_vcf` — pass 1, learns ``(n_haps,
  site_map)`` from an incremental line iterator (chunked gzip inflate);
* :meth:`LdSession.required_padding` — resolves the engine's tile /
  seq-chunk padding before any genotype is decoded;
* :func:`weightedld.io.vcf.read_vcf_site_major` — pass 2, decodes each
  record straight into its padded row (no ``[S, N]`` + transpose double
  materialization);
* :func:`weightedld.core.henikoff.henikoff_weights_host_site_major` —
  f64 host weights, chunked over site rows (the VCF path applies no site
  mask, reference parity — ``WeightedLD.py:385-388``);
* :class:`LdSession` with a :class:`SiteMajorCodes` input — zero-copy
  upload of the buffer we just filled.

Record semantics are identical to the row-list reader (same trailing-line
quirk, same codes, same rot90 haplotype order) — verified bit-identical in
``tests/test_ingest.py``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..io.vcf import read_vcf_site_major, scan_vcf
from .driver import DriverConfig, LdSession, SiteMajorCodes


def prepare_vcf_streamed(
    path: str | Path,
    chrom: str | None = None,
    cfg: DriverConfig | None = None,
    pos_range: tuple[int, int] | None = None,
    keep_samples: tuple[str, ...] | None = None,
    exclude_samples: tuple[str, ...] | None = None,
) -> tuple[SiteMajorCodes, np.ndarray]:
    """Two-pass streaming ingest sized for ``cfg``'s resolved padding:
    ``(SiteMajorCodes, site_map)`` ready for a zero-copy
    :class:`LdSession` built with the same config
    (:func:`session_from_vcf` does both halves consistently).
    ``pos_range`` is the ``--region`` POS window (1-based inclusive,
    ``io.vcf.parse_region``)."""
    n_haps, site_map = scan_vcf(path, chrom, pos_range)
    row_mask = None
    if keep_samples is not None or exclude_samples is not None:
        # Sample subsetting while decoding (round 5): resolve the boolean
        # alignment-row mask from the header samples up front (typo-safe,
        # rot90-aware — pipeline semantics), size the buffer for the KEPT
        # rows, and let pass 2 drop the rest column-wise.
        from ..pipeline import _sample_row_mask, _vcf_row_names

        row_mask = _sample_row_mask(_vcf_row_names(path, n_haps),
                                    keep_samples, exclude_samples)
    n_kept = n_haps if row_mask is None else int(row_mask.sum())
    s_pad, n_pad = LdSession.required_padding(n_kept, len(site_map), cfg)
    codes, site_map, n_kept = read_vcf_site_major(
        path, chrom=chrom, s_pad=s_pad, n_pad=n_pad,
        scan=(n_haps, site_map), pos_range=pos_range, row_mask=row_mask,
    )
    return SiteMajorCodes(codes=codes, n_seqs=n_kept,
                          n_sites=len(site_map)), site_map


def session_from_vcf(
    path: str | Path,
    chrom: str | None = None,
    cfg: DriverConfig | None = None,
    mesh=None,
    unweighted: bool = False,
    weights: np.ndarray | None = None,
    weight_precision: str = "f64",
    pos_range: tuple[int, int] | None = None,
    keep_samples: tuple[str, ...] | None = None,
    exclude_samples: tuple[str, ...] | None = None,
) -> LdSession:
    """Build a device session from a (possibly gzipped) VCF with bounded
    host memory — the streaming twin of ``prepare_vcf`` + ``LdSession``.

    Weighting matches the VCF pipeline (Henikoff on the full unmasked
    haplotype matrix, ``pipeline.prepare_vcf``): ``weight_precision="f64"``
    (default) runs the chunked f64 host formula
    (:func:`henikoff_weights_host_site_major` — equal to the ingest
    default's f64 twin up to chunked-summation order, ~1 ulp);
    ``"f32"`` defers to the session's on-device site-major weighting (one
    fewer host pass — the pod-scale choice).  Explicit ``weights`` or
    ``unweighted=True`` skip weighting entirely.
    """
    sm, site_map = prepare_vcf_streamed(path, chrom=chrom, cfg=cfg,
                                        pos_range=pos_range,
                                        keep_samples=keep_samples,
                                        exclude_samples=exclude_samples)
    if unweighted:
        weights = np.ones(sm.n_seqs, dtype=np.float32)
    elif weights is None and weight_precision == "f64":
        from ..core.henikoff import henikoff_weights_host_site_major

        weights = henikoff_weights_host_site_major(
            sm.codes, sm.n_sites, sm.n_seqs
        )
    elif weights is None and weight_precision != "f32":
        raise ValueError(
            f"weight_precision must be 'f64' or 'f32', got "
            f"{weight_precision!r}"
        )
    return LdSession(sm, weights, site_map, cfg=cfg, mesh=mesh)


def prepare_fasta_streamed(
    path: str | Path,
    min_acgt: float = 0.8,
    min_variability: float = 0.02,
    max_minor: float = 1.0,
    cfg: DriverConfig | None = None,
    keep_samples: tuple[str, ...] | None = None,
    exclude_samples: tuple[str, ...] | None = None,
) -> tuple[SiteMajorCodes, np.ndarray, np.ndarray, np.ndarray]:
    """Two-pass streaming FASTA ingest (the FASTA twin of
    :func:`prepare_vcf_streamed`): ``(SiteMajorCodes, site_map, hk_mask,
    ld_mask)`` with peak host memory = ONE padded site-major matrix of the
    LD-KEPT sites (plus a row block and the [S, 5] histogram) — the
    reference's BioPython path (``WeightedLD.py:21-41``) materializes the
    text, the row list, and the [N, S] matrix.

    Pass 1 (:func:`io.fasta.scan_fasta`) streams per-site histograms;
    the reference's Python masks (``compute_variable_sites_from_counts``,
    f64 host semantics) come straight from the counts; pass 2
    (:func:`io.fasta.read_fasta_site_major`) decodes each record into its
    buffer column, already trimmed to the LD mask — matching the CLI
    pipeline's "trim then weight" semantics (``WeightedLD.py:303,397``;
    weights on this buffer via ``henikoff_weights_host_site_major`` are
    the pipeline weights up to chunked-summation order, ~1 ulp).

    Framing is the Python/BioPython semantics only (wrapped records
    concatenated); the Rust line-based variant is not streamed.
    """
    from ..core.sites import compute_variable_sites_from_counts
    from ..io.fasta import read_fasta_site_major, scan_fasta

    # Sample subsetting is decided per record DURING pass 1 (no extra file
    # pass; typo-safe like the batch pipeline — scan_fasta docstring);
    # subsetting happens BEFORE masking and weighting, matching pipeline
    # semantics, and the returned row_mask drives pass 2.
    n_seqs, n_sites, counts, row_mask = scan_fasta(
        path, keep_samples=keep_samples, exclude_samples=exclude_samples)
    hk_mask, ld_mask = compute_variable_sites_from_counts(
        counts, n_seqs, min_acgt, min_variability, max_minor)
    site_map = np.flatnonzero(ld_mask).astype(np.int64)
    s_kept = len(site_map)
    # s_kept == 0 (fully conserved input): callers handle the empty result
    # before any session is built (the CLI's "fewer than 2 sites" path),
    # matching the batch pipeline.
    s_pad, n_pad = LdSession.required_padding(n_seqs, max(s_kept, 1), cfg)
    codes = read_fasta_site_major(
        path, ld_mask, s_pad=s_pad, n_pad=n_pad, scan=(n_seqs, n_sites),
        row_mask=row_mask)
    return (SiteMajorCodes(codes=codes, n_seqs=n_seqs, n_sites=s_kept),
            site_map, hk_mask, ld_mask)


def session_from_fasta(
    path: str | Path,
    cfg: DriverConfig | None = None,
    mesh=None,
    min_acgt: float = 0.8,
    min_variability: float = 0.02,
    max_minor: float = 1.0,
    unweighted: bool = False,
    weights: np.ndarray | None = None,
    keep_samples: tuple[str, ...] | None = None,
    exclude_samples: tuple[str, ...] | None = None,
) -> LdSession:
    """Build a device session from a (possibly gzipped) FASTA with bounded
    host memory — the FASTA twin of :func:`session_from_vcf`.  Masking and
    weighting follow the reference CLI convention (LD-mask trim, Henikoff
    f64 on the trimmed sites, ``WeightedLD.py:303,397``)."""
    sm, site_map, _hk, _ld = prepare_fasta_streamed(
        path, min_acgt=min_acgt, min_variability=min_variability,
        max_minor=max_minor, cfg=cfg,
        keep_samples=keep_samples, exclude_samples=exclude_samples)
    if unweighted:
        weights = np.ones(sm.n_seqs, dtype=np.float32)
    elif weights is None:
        from ..core.henikoff import henikoff_weights_host_site_major

        weights = henikoff_weights_host_site_major(
            sm.codes, sm.n_sites, sm.n_seqs)
    return LdSession(sm, weights, site_map, cfg=cfg, mesh=mesh)
