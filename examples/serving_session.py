"""Device-resident serving session: upload once, scan many times.

Useful when the same cohort is queried repeatedly (different r2 thresholds,
windows, resumed ranges): the alignment, weights, and tile plan live on the
device mesh across scans.
"""

import numpy as np

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo checkout

import weightedld as wld
from weightedld.runtime.driver import DriverConfig, LdSession

res = wld.prepare(sys.argv[1] if len(sys.argv) > 1 else str(Path(__file__).with_name("example.fasta")))

session = LdSession(
    res.alignment, res.weights, res.site_map,
    DriverConfig(r2_threshold=0.1),  # tile/batch auto-size per platform
)
# Tip: LdSession(res.alignment, None, res.site_map, ...) computes Henikoff
# weights ON DEVICE from the uploaded codes (one alignment upload instead
# of two; read them back from session.weights) — the fastest way to stand
# up a pod-scale session from raw arrays.

# Reduction-only scan: O(1) host traffic per batch.
print(session.summarize())

# Streamed records (compacted on device, transferred O(records)).
for batch, records in session.stream():
    for pa, pb, r2 in zip(records.pos_a, records.pos_b, records.r2):
        print(pa, pb, round(float(r2), 4))

# Re-scan at a different threshold: the threshold is a runtime scalar of
# the compiled program, so this reuses everything already on device.
print(session.summarize(r2_threshold=0.5))

# Threshold-free analytics against the same resident session:
top = session.top_pairs(3)           # the 3 strongest pairs by r2
for pa, pb, r2 in zip(top.pos_a, top.pos_b, top.r2):
    print("top:", pa, pb, round(float(r2), 4))
print(session.ld_decay([0, 2, 4]))   # r2-vs-distance curve (site_map units)
print("independent sites:", list(session.prune(0.5)))  # greedy LD pruning
