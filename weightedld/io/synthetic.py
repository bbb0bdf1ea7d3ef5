"""Seeded synthetic inputs at the shapes real LD users run.

Nothing is downloaded: every input is generated from a seed, in bulk with
numpy, so tests, the smoke run and benchmarks share one definition.

* :func:`write_synthetic_vcf` — a phased multi-sample VCF (CHROM, POS, ID,
  REF/ALT, ``a|b`` genotypes) whose haplotypes are mosaics of a few founder
  haplotypes per LD block, so sites within a block are in strong LD and
  sites in different blocks are nearly independent.
* :func:`synthetic_alignment_fasta` — a pathogen-style alignment (one
  reference genome, lineages carrying variants at a few thousand columns,
  scattered gaps and IUPAC ambiguity codes).
* :func:`criterion_alignment` — the reference's criterion-bench
  distribution (60% major / 30% minor / 10% missing).
"""

from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np


def synthetic_haplotypes(rng: np.random.Generator, n_haps: int, n_sites: int,
                         block_len: int = 32, n_founders: int = 6,
                         noise: float = 0.01) -> np.ndarray:
    """``[n_haps, n_sites]`` uint8 0/1 haplotypes with block LD.

    Each block of ``block_len`` sites has ``n_founders`` founder
    haplotypes (allele 1 drawn per founder and site with a site-specific
    frequency, so minor-allele frequencies spread over (0, 0.5]); each
    haplotype copies one founder per block (founder popularity is skewed)
    and then flips a ``noise`` fraction of its alleles."""
    haps = np.empty((n_haps, n_sites), dtype=np.uint8)
    for lo in range(0, n_sites, block_len):
        hi = min(lo + block_len, n_sites)
        freq = rng.uniform(0.05, 0.5, size=hi - lo)
        founders = (rng.random((n_founders, hi - lo)) < freq).astype(np.uint8)
        pop = rng.dirichlet(np.full(n_founders, 0.8))
        pick = rng.choice(n_founders, size=n_haps, p=pop)
        haps[:, lo:hi] = founders[pick]
    n_flip = int(noise * n_haps * n_sites)
    if n_flip:
        r = rng.integers(0, n_haps, size=n_flip)
        c = rng.integers(0, n_sites, size=n_flip)
        haps[r, c] ^= 1
    return haps


def write_synthetic_vcf(path: str | Path, n_samples: int, n_sites: int,
                        seed: int, *, chrom: str = "19",
                        pos_start: int = 44890000, pos_step: int = 50,
                        block_len: int = 32, missing: float = 0.0,
                        chroms: tuple[str, ...] | None = None) -> Path:
    """Write a phased diploid VCF of ``n_samples`` samples (``2 *
    n_samples`` haplotypes) x ``n_sites`` biallelic sites; gzipped when
    ``path`` ends in ``.gz``.  Returns the path.

    POS starts at ``pos_start`` and advances by a seeded step in
    ``[1, 2 * pos_step)``; IDs are ``rs<k>``.  ``chroms`` splits the
    records into equal consecutive runs on those chromosomes (positions
    restart per chromosome) instead of one ``chrom``.  ``missing`` turns
    that fraction of genotype fields into ``.|.``.  The file ends with a
    newline, so the reference's trailing-line drop removes no record."""
    rng = np.random.default_rng(seed)
    haps = synthetic_haplotypes(rng, 2 * n_samples, n_sites,
                                block_len=block_len)
    # Site-major genotype text: every field is exactly 4 bytes "a|b\t".
    gt = np.empty((n_sites, n_samples, 4), dtype=np.uint8)
    gt[:, :, 0] = haps[0::2].T + ord("0")
    gt[:, :, 1] = ord("|")
    gt[:, :, 2] = haps[1::2].T + ord("0")
    gt[:, :, 3] = ord("\t")
    if missing > 0:
        miss = rng.random((n_sites, n_samples)) < missing
        gt[miss, 0] = ord(".")
        gt[miss, 2] = ord(".")
    gt[:, -1, 3] = ord("\n")
    gt = gt.reshape(n_sites, -1)
    names = chroms or (chrom,)
    run = -(-n_sites // len(names))
    steps = rng.integers(1, 2 * pos_step, size=n_sites)
    path = Path(path)
    opener = (lambda p: gzip.open(p, "wb", compresslevel=1)) \
        if path.suffix == ".gz" else (lambda p: open(p, "wb"))
    with opener(path) as fh:
        fh.write(b"##fileformat=VCFv4.2\n")
        for c in names:
            fh.write(f"##contig=<ID={c}>\n".encode())
        fh.write(("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                  + "\t".join(f"S{i:05d}" for i in range(n_samples))
                  + "\n").encode())
        for ci, c in enumerate(names):
            lo, hi = ci * run, min((ci + 1) * run, n_sites)
            pos = pos_start + np.cumsum(steps[lo:hi])
            for k in range(lo, hi):
                fh.write(f"{c}\t{pos[k - lo]}\trs{k}\tA\tG\t.\tPASS\t.\tGT\t"
                         .encode())
                fh.write(gt[k].tobytes())
    return path


_IUPAC = np.frombuffer(b"RYSWKMN", dtype=np.uint8)


def synthetic_alignment_fasta(rng: np.random.Generator, n_seqs: int,
                              n_cols: int, n_variable: int, *,
                              n_lineages: int = 64, gap: float = 0.005,
                              ambiguous: float = 0.001,
                              n_balanced: int = 8) -> np.ndarray:
    """``[n_seqs, n_cols]`` ASCII bytes of a pathogen-style alignment.

    A random reference genome; ``n_variable`` columns carry a minor base in
    a random subset of the ``n_lineages`` lineages (minor frequency spread
    over ~[0.03, 0.45]); each sequence belongs to one lineage.  Then
    ``gap`` of all cells become '-' and ``ambiguous`` become IUPAC
    ambiguity codes (encoded UNKNOWN).  ``n_balanced`` of the variable
    columns split the sequences exactly in half, so their allele counts
    tie up to the scattered gaps/ambiguity codes — sites whose per-pair
    major allele depends on which sequences a partner site drops."""
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = rng.integers(0, 4, size=n_cols)
    out = np.broadcast_to(acgt[ref], (n_seqs, n_cols)).copy()
    cols = np.sort(rng.choice(n_cols, size=n_variable, replace=False))
    lineage = rng.choice(n_lineages, size=n_seqs,
                         p=rng.dirichlet(np.full(n_lineages, 2.0)))
    share = np.bincount(lineage, minlength=n_lineages) / n_seqs
    for c in cols:
        alt = acgt[(ref[c] + rng.integers(1, 4)) % 4]
        target = rng.uniform(0.03, 0.45)
        order = rng.permutation(n_lineages)
        carriers = order[: max(1, int(np.searchsorted(
            np.cumsum(share[order]), target)) + 1)]
        out[np.isin(lineage, carriers), c] = alt
    for c in cols[rng.choice(n_variable, size=min(n_balanced, n_variable),
                             replace=False)]:
        alt = acgt[(ref[c] + 1) % 4]
        half = rng.permutation(n_seqs)[: n_seqs // 2]
        out[:, c] = acgt[ref[c]]
        out[half, c] = alt
    n_cells = n_seqs * n_cols
    for frac, sym in ((gap, None), (ambiguous, _IUPAC)):
        k = int(frac * n_cells)
        r = rng.integers(0, n_seqs, size=k)
        c = rng.integers(0, n_cols, size=k)
        out[r, c] = ord("-") if sym is None else sym[rng.integers(
            0, len(sym), size=k)]
    return out


def write_fasta_bytes(path: str | Path, seqs: np.ndarray) -> Path:
    """Write ``[n_seqs, n_cols]`` ASCII rows as ``>seq<i>`` FASTA records
    (one line per sequence; gzipped when ``path`` ends in ``.gz``)."""
    path = Path(path)
    opener = (lambda p: gzip.open(p, "wb", compresslevel=1)) \
        if path.suffix == ".gz" else (lambda p: open(p, "wb"))
    with opener(path) as fh:
        for i, row in enumerate(seqs):
            fh.write(b">seq%d\n" % i)
            fh.write(row.tobytes())
            fh.write(b"\n")
    return path


def criterion_alignment(rng: np.random.Generator, n_seqs: int,
                        n_sites: int) -> np.ndarray:
    """60% major allele / 30% minor / 10% missing codes — the reference's
    criterion bench distribution (benches/bench_weighted_pair_ld.rs:8-28)."""
    r = rng.random((n_seqs, n_sites), dtype=np.float32)
    return np.where(r < 0.6, 0, np.where(r < 0.9, 3, 4)).astype(np.int8)
