"""Per-chromosome analysis loop over a whole-genome VCF.

The reference ignores the CHROM column entirely, mixing every chromosome
into one position axis (``WeightedLD.py:361-362``) — cross-chromosome
"distances" are then meaningless and positions can repeat.  This
framework instead enumerates chromosomes (``list_chromosomes`` /
``--list-chroms``) and analyses each on its own resident session
(``read_vcf(chrom=...)`` / ``--chrom``):

    python examples/per_chromosome.py [cohort.vcf]

Without an argument it synthesizes a small two-chromosome VCF.
"""

import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo checkout

import weightedld as wld
from weightedld.runtime.driver import DriverConfig, LdSession


def synthetic_vcf(path, n_samples=40, sites_per_chrom=24, rng=None):
    rng = rng or np.random.default_rng(0)
    header = ("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
              + "\t".join(f"s{i}" for i in range(n_samples)))
    rows = [header]
    for chrom, base in (("chr1", 10_000), ("chr2", 5_000)):
        # Two LD blocks per chromosome: sites in a block share a haplotype.
        for s in range(sites_per_chrom):
            import zlib

            block = s // (sites_per_chrom // 2)
            # Deterministic across processes (str hash() is salted).
            block_rng = np.random.default_rng(
                zlib.crc32(f"{chrom}/{block}".encode()))
            hap = block_rng.integers(0, 2, size=2 * n_samples)
            noise = rng.random(2 * n_samples) < 0.1
            hap = np.where(noise, 1 - hap, hap)
            gts = "\t".join(f"{hap[2*i]}|{hap[2*i+1]}"
                            for i in range(n_samples))
            rows.append(f"{chrom}\t{base + 100 * s}\t.\tA\tT\t.\t.\t.\tGT\t{gts}")
    rows.append("")  # trailing newline (the reference drops the last line)
    Path(path).write_text("\n".join(rows))


def main() -> int:
    if len(sys.argv) > 1:
        vcf = Path(sys.argv[1])
    else:
        vcf = Path(tempfile.mkdtemp()) / "two_chrom.vcf"
        synthetic_vcf(vcf)
        print(f"(synthesized {vcf})")

    for chrom in wld.list_chromosomes(vcf):
        aln, site_map = wld.read_vcf(vcf, chrom=chrom)
        session = LdSession(aln, None, site_map,  # Henikoff on device
                            DriverConfig(r2_threshold=0.3))
        summ = session.summarize()
        decay = session.ld_decay([0, 600, 5_000])
        kept = session.prune(0.3)
        print(f"{chrom}: {aln.shape[0]} haplotypes x {summ['n_sites']} sites, "
              f"{summ['n_over_threshold']}/{summ['n_pairs']} pairs r2>0.3; "
              f"mean r2 under 600 bp {decay['r2_mean'][0]:.3f} vs "
              f"{decay['r2_mean'][1] if decay['r2_mean'][1] is None else round(decay['r2_mean'][1], 3)} beyond; "
              f"pruned to {len(kept)} independent sites")
    return 0


if __name__ == "__main__":
    sys.exit(main())
