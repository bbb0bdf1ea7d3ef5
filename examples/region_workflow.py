"""Targeted-locus workflow: region queries, sample subsetting, cross-region
LD, and PLINK-format output (round-5 capabilities beyond the reference).

The reference has no notion of regions, samples, or output interop — it
computes every pair of every site for every sequence in the file.  Real
cohort analyses are usually the opposite: one locus (or a pair of loci),
one sub-cohort, and downstream tooling that expects ``plink.ld`` columns.
This example drives that workflow end-to-end on the CLI surface:

    python examples/region_workflow.py [cohort.vcf]

Without an argument it synthesizes a small two-locus VCF.
"""

import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo checkout

from weightedld.cli import main as wld_main


def synthetic_vcf(path, n_samples=30, sites_per_locus=10, rng=None):
    """Two loci on one chromosome; the second locus's GT columns copy the
    first's with noise, so CROSS-locus LD is real, not incidental."""
    rng = rng or np.random.default_rng(7)
    header = ("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
              + "\t".join(f"s{i}" for i in range(n_samples)))
    rows = [header]
    base_hap = rng.integers(0, 2, size=2 * n_samples)
    for locus, start in (("A", 10_000), ("B", 60_000)):
        for s in range(sites_per_locus):
            hap = np.where(rng.random(2 * n_samples) < 0.15,
                           rng.integers(0, 2, size=2 * n_samples), base_hap)
            gts = "\t".join(f"{hap[2 * i]}|{hap[2 * i + 1]}"
                            for i in range(n_samples))
            rows.append(f"chr7\t{start + 37 * s}\trs{locus}{s}\tA\tT"
                        f"\t.\t.\t.\tGT\t{gts}")
    Path(path).write_text("\n".join(rows) + "\n")


def run(argv):
    rc = wld_main(argv)
    if rc != 0:
        raise SystemExit(f"CLI exited {rc}: {' '.join(argv)}")


def main():
    if len(sys.argv) > 1:
        vcf = sys.argv[1]
    else:
        tmp = tempfile.NamedTemporaryFile(suffix=".vcf", delete=False)
        tmp.close()
        vcf = tmp.name
        synthetic_vcf(vcf)

    print("== 1. region query: LD within locus A only (samtools-style)")
    run(["--file", vcf, "--region", "chr7:10,000-11,000",
         "--r2-threshold", "0.5"])

    print("\n== 2. sub-cohort: drop two samples, locus A again")
    run(["--file", vcf, "--region", "chr7:10000-11000",
         "--exclude-samples", "s0,s1", "--r2-threshold", "0.5"])

    print("\n== 3. cross-region rectangle: ONLY A x B pairs, plink columns")
    run(["--file", vcf, "--cross-regions", "chr7:10000-11000",
         "chr7:60000-61000", "--out-format", "plink",
         "--r2-threshold", "0.5"])

    print("\n== 4. strongest 3 cross pairs, threshold-free")
    run(["--file", vcf, "--cross-regions", "chr7:10000-11000",
         "chr7:60000-61000", "--top", "3"])

    print("\n== 5. LD pruning as a plink --extract file (SNP ids)")
    run(["--file", vcf, "--region", "chr7:10000-11000",
         "--prune-r2", "0.5", "--out-format", "plink"])


if __name__ == "__main__":
    main()
