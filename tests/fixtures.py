"""Reference test fixtures, reconstructed from their specification
(SURVEY.md Appendix B) as in-memory sequence lists, with golden outputs from
executing the Python reference (SURVEY.md Appendix A).
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Fixture alignments (SURVEY.md Appendix B)
# ---------------------------------------------------------------------------

EXAMPLE = [
    "ATAA",
    "TAAA", "TAAA", "TAAA",
    "T-AA",
    "TTAA", "TTAA", "TTAA", "TTAA",
    "TTAy",
]

T1_HENIKOFF_PAPER = [
    "GGAAAAA",
    "b-AAAAA",
    "z-CCCCC",
    "p-CCCCC",
    "M-TTTTT",
]

T2_HENIKOFF_COMPLEX1 = [
    "GATAA",
    "GTAAA", "GTAAA", "GTAAA",
    "GTTAA", "GTTAA", "GTTAA", "GTTAA",
]

T3_HENIKOFF_COMPLEX2 = [
    "GATAA",
    "GTAAA", "GTAAA", "GTAAA",
    "GTTAA", "GTTAA", "GTTAA",
    "GTT--",
]

T4_WEIGHTS1_LD0 = (
    ["AAA-"] + ["AAAA"] * 3 + ["TTAA"] * 4 + ["ATAA"] * 4 + ["TAAA"] * 4
)

T5_WEIGHTS1_LD025 = ["AAAA"] * 4 + ["TTAA"] * 4

T6_VARSITES_HK_LD = ["AAAA"] * 7 + ["TAAA"] * 2 + ["TTAA"]

ALL_FASTAS = {
    "example": EXAMPLE,
    "t1": T1_HENIKOFF_PAPER,
    "t2": T2_HENIKOFF_COMPLEX1,
    "t3": T3_HENIKOFF_COMPLEX2,
    "t4": T4_WEIGHTS1_LD0,
    "t5": T5_WEIGHTS1_LD025,
    "t6": T6_VARSITES_HK_LD,
}


def write_fasta(path, seqs) -> None:
    with open(path, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f">seq{i}\n{s}\n")


# ---------------------------------------------------------------------------
# Golden outputs (SURVEY.md Appendix A — executed Python reference, defaults
# min_acgt=0.8, min_variability=0.02; weights on the LD-masked alignment).
# Each LD row is (pos_a, pos_b, D, D', r2) rounded to 4 dp.
# ---------------------------------------------------------------------------

GOLDEN = {
    "example": dict(
        hk=[1, 1, 1, 1],
        ld=[1, 1, 0, 0],
        weights=[1.0, 0.381, 0.381, 0.381, 0.9524,
                 0.2381, 0.2381, 0.2381, 0.2381, 0.2381],
        pairs=[(0, 1, 0.1029, 0.3429, 0.2236)],
    ),
    "t1": dict(
        hk=[0, 0, 1, 1, 1, 1, 1],
        ld=[0, 0, 1, 1, 1, 1, 1],
        weights=[0.5, 0.5, 0.5, 0.5, 1.0],
        pairs=[
            (a, b, -0.25, 0.5, 1.0)
            for a in range(2, 7)
            for b in range(a + 1, 7)
        ],
    ),
    "t2": dict(
        hk=[1, 1, 1, 1, 1],
        ld=[0, 1, 1, 0, 0],
        weights=[1.0, 0.3968, 0.3968, 0.3968,
                 0.2857, 0.2857, 0.2857, 0.2857],
        pairs=[(1, 2, 0.1071, 0.3571, 0.2381)],
    ),
    "t3": dict(
        hk=[1, 1, 1, 1, 1],
        ld=[0, 1, 1, 1, 1],
        weights=[0.6341, 0.3252, 0.3252, 0.3252,
                 0.2683, 0.2683, 0.2683, 1.0],
        pairs=[
            (1, 2, 0.0531, 0.2857, 0.0912),
            (1, 3, 0.0544, 0.2929, 0.0945),
            (1, 4, 0.0544, 0.2929, 0.0945),
            (2, 3, 0.0837, 0.2929, 0.1657),
            (2, 4, 0.0837, 0.2929, 0.1657),
            (3, 4, -0.2071, 0.7071, 1.0),
        ],
    ),
    "t4": dict(
        hk=[1, 1, 1, 1],
        ld=[1, 1, 0, 1],
        weights=[1.0] + [0.2533] * 15,
        pairs=[
            (0, 1, -0.0328, 0.1556, 0.0181),
            (0, 3, 0.088, 0.4222, 0.1923),
            (1, 3, 0.088, 0.4222, 0.1923),
        ],
    ),
    "t5": dict(
        hk=[1, 1, 1, 1],
        ld=[1, 1, 0, 0],
        weights=[1.0] * 8,
        pairs=[(0, 1, -0.25, 0.5, 1.0)],
    ),
    "t6": dict(
        hk=[1, 1, 1, 1],
        ld=[1, 1, 0, 0],
        weights=[0.1905] * 7 + [0.3333, 0.3333, 1.0],
        pairs=[(0, 1, -0.1481, 0.4444, 0.4)],
    ),
}

# t7 VCF goldens (SURVEY.md Appendix A.8); the fixture itself lives in the
# read-only reference checkout, so tests that need its exact goldens skip
# without it.  Everything else uses the seeded t7-shaped VCF below.
T7_PATH = "/root/reference/tests/t7_1000genome.vcf"
T7_GOLDEN = dict(
    shape=(5008, 5),
    site_map=[44890030, 44890114, 44890164, 44890171, 44890183],
    weights_mean=0.00200,
    weights_max=1.0,
    weights_min=0.00101,
    pairs=[
        (44890030, 44890114, 0.0117, 0.1173, 0.0148),
        (44890030, 44890164, 0.01, 0.1001, 0.0124),
        (44890030, 44890171, 0.01, 0.1001, 0.0124),
        (44890030, 44890183, 0.0106, 0.1058, 0.0132),
        (44890114, 44890164, 0.0117, 0.1173, 0.0148),
        (44890114, 44890171, 0.0117, 0.1173, 0.0148),
        (44890114, 44890183, 0.0124, 0.1173, 0.0157),
        (44890164, 44890171, 0.01, 0.1001, 0.0124),
        (44890164, 44890183, 0.0106, 0.1058, 0.0132),
        (44890171, 44890183, 0.0106, 0.1058, 0.0132),
    ],
)


def random_alignment(rng, n_seqs, n_sites, p_gap=0.05, p_unknown=0.05):
    """Random int8 alignment with realistic symbol mix for property tests."""
    base = rng.integers(0, 4, size=(n_seqs, n_sites))
    u = rng.random((n_seqs, n_sites))
    base = np.where(u < p_gap, 4, base)
    base = np.where(u > 1 - p_unknown, 5, base)
    # Skew toward a major allele per site to create LD-like structure.
    major = rng.integers(0, 4, size=n_sites)
    take_major = rng.random((n_seqs, n_sites)) < 0.6
    base = np.where(take_major & (base < 4), major[None, :], base)
    return base.astype(np.int8)


# ---------------------------------------------------------------------------
# Seeded t7-shaped VCF: chromosome 19, the five t7 positions and the first
# two t7 rsIDs, phased genotypes with strong LD.  Haplotype h carries the
# ALT allele at site k when u_h < SYN7_MAF[k] (nested thresholds of one
# latent draw, 4% of cells flipped), so every pair is kept with r2 well
# above 0.013, and site 1 (44890114) has the highest minor-allele
# frequency — the hub a greedy MAF prune keeps.
# ---------------------------------------------------------------------------

SYN7_POS = [44890030, 44890114, 44890164, 44890171, 44890183]
SYN7_IDS = ["rs189636588", "rs73934845", "rs7000003", "rs7000004",
            "rs7000005"]
SYN7_MAF = [0.2, 0.45, 0.3, 0.25, 0.35]
SYN7_SAMPLES = 64
_SYN7_CACHE: dict = {}


def synthetic_t7_text(seed: int = 7) -> str:
    rng = np.random.default_rng(seed)
    n_haps = 2 * SYN7_SAMPLES
    u = rng.random(n_haps)
    haps = (u[:, None] < np.asarray(SYN7_MAF)[None, :]).astype(int)
    flip = rng.random(haps.shape) < 0.04
    haps = np.where(flip, 1 - haps, haps)
    lines = ["##fileformat=VCFv4.1",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
             + "\t".join(f"HG{96 + i:05d}" for i in range(SYN7_SAMPLES))]
    for k, (pos, rid) in enumerate(zip(SYN7_POS, SYN7_IDS)):
        gts = "\t".join(f"{haps[2 * i, k]}|{haps[2 * i + 1, k]}"
                        for i in range(SYN7_SAMPLES))
        lines.append(f"19\t{pos}\t{rid}\tC\tT\t100\tPASS\t.\tGT\t{gts}")
    return "\n".join(lines) + "\n"


def synthetic_t7_path() -> str:
    """Path of the seeded t7-shaped VCF, written once per process."""
    path = _SYN7_CACHE.get("path")
    if path is None:
        import tempfile
        from pathlib import Path

        path = str(Path(tempfile.mkdtemp(prefix="syn7_")) / "syn7.vcf")
        Path(path).write_text(synthetic_t7_text())
        _SYN7_CACHE["path"] = path
    return path


def synthetic_t7_reference_pairs():
    """``{(pos_a, pos_b): (D, D', r2)}`` of the seeded t7-shaped VCF from
    the float64 reference engine with its Henikoff weights."""
    from weightedld.core.henikoff import henikoff_weights_host
    from weightedld.core.reference_impl import reference_ld
    from weightedld.io.vcf import read_vcf

    aln, sm = read_vcf(synthetic_t7_path())
    w = henikoff_weights_host(aln)
    return {(a, b): (d, dp, r2) for a, b, d, dp, r2 in reference_ld(aln, w, sm)}
