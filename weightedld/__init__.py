"""weightedld — a weighted linkage-disequilibrium framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
ojcharles/WeightedLD: FASTA/VCF ingestion, variable-site masking, Henikoff
position-based sequence weighting, and the all-pairs weighted LD reduction
(D, D', r^2), formulated as one-hot integer contractions on the
accelerator's tensor cores and scaled over device meshes by sharding the
site-pair upper triangle.
"""

from .runtime.jaxcache import enable_persistent_cache as _enable_cache

_enable_cache()

from .core.encode import encode_alignment
from .core.henikoff import henikoff_weights
from .core.ld_dense import LdRecords, extract_records, ld_all_pairs_dense
from .core.paircore import PairStats, finalize_pair_tile, ld_pair_tile, pair_tables
from .core.sites import compute_variable_sites
from .io.fasta import read_fasta
from .io.vcf import list_chromosomes, read_vcf
from .pipeline import PipelineResult, WldConfig, prepare, run, site_stats
from .io.vcf import parse_region, vcf_sample_names
from .runtime.ingest import (
    prepare_fasta_streamed,
    prepare_vcf_streamed,
    session_from_fasta,
    session_from_vcf,
)

__version__ = "0.1.0"

__all__ = [
    "encode_alignment",
    "henikoff_weights",
    "LdRecords",
    "extract_records",
    "ld_all_pairs_dense",
    "PairStats",
    "finalize_pair_tile",
    "ld_pair_tile",
    "pair_tables",
    "compute_variable_sites",
    "read_fasta",
    "read_vcf",
    "list_chromosomes",
    "parse_region",
    "vcf_sample_names",
    "prepare_fasta_streamed",
    "session_from_fasta",
    "PipelineResult",
    "WldConfig",
    "prepare",
    "run",
    "site_stats",
    "prepare_vcf_streamed",
    "session_from_vcf",
]
