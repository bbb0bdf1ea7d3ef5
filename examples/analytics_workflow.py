"""End-to-end LD analytics workflow on one device-resident session.

The intended serving pattern: upload a cohort once, then answer every
question against the resident session — no re-uploads, no recompiles
(thresholds are runtime scalars; each analytics query is its own cached
program).

    python examples/analytics_workflow.py [cohort.vcf|alignment.fasta] [CHROM]

Whole-genome multi-chromosome VCFs need the CHROM argument (positions
must be monotonic for the decay/prune steps).

Without an argument it generates a synthetic SNP cohort with planted LD
blocks so every step has visible structure.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo checkout

import weightedld as wld
from weightedld.runtime.driver import DriverConfig, LdSession


def synthetic_cohort(n_seqs=200, n_blocks=40, block=8, rng=None):
    """SNP matrix with LD blocks: sites within a block share a haplotype
    (with 10% noise), blocks are independent."""
    rng = rng or np.random.default_rng(0)
    hap = rng.integers(0, 2, size=(n_seqs, n_blocks))
    aln = np.repeat(hap, block, axis=1)
    flip = rng.random(aln.shape) < 0.10
    aln = np.where(flip, 1 - aln, aln)
    return aln.astype(np.int8), np.arange(n_blocks * block) * 500  # bp grid


if len(sys.argv) > 1:
    chrom = sys.argv[2] if len(sys.argv) > 2 else None
    res = wld.prepare(sys.argv[1], wld.WldConfig(chrom=chrom))
    aln, weights, site_map = res.alignment, res.weights, res.site_map
else:
    aln, site_map = synthetic_cohort()
    weights = None  # Henikoff computed ON DEVICE from the uploaded codes

session = LdSession(aln, weights, site_map, DriverConfig())

# 1. How much LD is there at all?  (reduction-only scan)
print("summary:", session.summarize())

# 2. What does the r2 distribution look like?  (pick a threshold from it)
print("r2 histogram:", session.r2_histogram([0, 0.05, 0.1, 0.3, 0.6, 1.01]))

# 3. How does LD decay with distance?  (bp bins from the site map)
print("decay:", session.ld_decay([0, 1_000, 4_000, 16_000, 64_000]))

# 4. The strongest signals, no threshold guessing.
top = session.top_pairs(5)
for a, b, r2 in zip(top.pos_a, top.pos_b, top.r2):
    print(f"top pair {a}-{b}  r2={float(r2):.4f}")

# 5. Records above the threshold the histogram suggested.
n = sum(len(rec) for _, rec in session.stream(r2_threshold=0.3))
print(f"{n} pairs with r2 > 0.3")

# 6. An independent-SNP subset for downstream association testing.
kept = session.prune(0.3)
print(f"pruned to {len(kept)} of {session.n_sites} sites (r2 <= 0.3)")
