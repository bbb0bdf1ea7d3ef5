"""Square LD matrices for heatmaps / downstream matrix consumers.

``LdSession.matrices()`` assembles full ``[S, S]`` D / D' / r2 matrices
(NaN below the diagonal and at skipped pairs) with transport engineered
like the record path; ``dtype=float16`` halves the device->host bytes
(values within 2^-11 relative — plenty for visualization and
thresholding), which matters because large-S exports are
transport-bandwidth-bound (PERF.md).  The CLI equivalent is
``--matrix-output m.npz [--matrix-dtype float16]``.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo checkout

import weightedld as wld
from weightedld.runtime.driver import DriverConfig, LdSession

res = wld.prepare(
    sys.argv[1] if len(sys.argv) > 1
    else str(Path(__file__).with_name("example.fasta"))
)
session = LdSession(res.alignment, res.weights, res.site_map, DriverConfig())

mats = session.matrices(dtype=np.float16)   # default: float32
s = len(res.site_map)
kept = int(mats["keep"].sum())
print(f"{s} x {s} matrices, {kept} surviving pairs, dtype {mats['r2'].dtype}")

out = Path(sys.argv[2]) if len(sys.argv) > 2 else Path("ld_matrices.npz")
np.savez_compressed(out, site_map=res.site_map, **mats)
print(f"wrote {out} ({out.stat().st_size} bytes)")

# r2 of the strongest pair, straight from the matrix:
r2 = mats["r2"].astype(np.float32)
i, j = np.unravel_index(np.nanargmax(np.where(mats["keep"], r2, np.nan)),
                        r2.shape)
print(f"strongest pair: sites {res.site_map[i]} x {res.site_map[j]} "
      f"r2={r2[i, j]:.4f}")
