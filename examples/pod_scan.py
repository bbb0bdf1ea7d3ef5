"""Multi-host scan skeleton.

Run one copy of this per host, with the ``JAX_COORDINATOR_ADDRESS`` /
``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID`` environment (or Slurm / MPI)
wiring the processes together.  Every process drives its local GPUs over
the global mesh; the striped tile plan is deterministic, inputs are
replicated once, and only process 0 writes output — communication is
O(records).
"""

import numpy as np

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo checkout

import weightedld as wld
from weightedld.parallel.multihost import (
    global_mesh,
    initialize_distributed,
    is_output_process,
)
from weightedld.runtime.driver import DriverConfig, run_to_tsv

initialize_distributed()  # no-op for single-process runs

res = wld.prepare(sys.argv[1] if len(sys.argv) > 1 else str(Path(__file__).with_name("example.fasta")))
n = run_to_tsv(
    res.alignment, res.weights, res.site_map,
    out_path="pairs.tsv" if is_output_process() else "/dev/null",
    cfg=DriverConfig(r2_threshold=0.1),  # tiles/batch auto-sizes per platform
    mesh=global_mesh(),
    checkpoint=is_output_process(),
)
if is_output_process():
    print(f"{n} records written")
