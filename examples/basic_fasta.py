"""Minimal reference-compatible run: FASTA in, TSV to stdout.

Equivalent to `python WeightedLD.py --file alignment.fasta` in the reference.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo checkout

import weightedld as wld
from weightedld.io.writer import write_pairs

res = wld.run(sys.argv[1] if len(sys.argv) > 1 else str(Path(__file__).with_name("example.fasta")))
write_pairs(res.records, sys.stdout)
