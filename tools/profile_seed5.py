#!/usr/bin/env python3
"""Profile the device-seed path per chunk: scan dispatch / bitmask fetch /
svt_chain5 lookup+chain / decoy suppression — the components of seed_cpu_s
in the production pipeline (align/pipeline.py seed_chunk).

Run on the GPU (default) to include the real bitmask fetch latency.
"""
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TEST_DIR = Path(os.environ.get("SVJT_TESTDIR", "/root/reference/test-dir"))
REPS = int(os.environ.get("SVJT_BENCH_REPS", "10"))

from svjedi_tpu.align import dev_scan
from svjedi_tpu.align import device as dev
from svjedi_tpu.align.decoy import build_decoy, suppress_candidates
from svjedi_tpu.align.index import build_panel_index, merge_indexes
from svjedi_tpu.align.seed import ChainParams, seed_candidates
from svjedi_tpu.config import AlignConfig
from svjedi_tpu.graph.build import build_graph
from svjedi_tpu.graph.cluster import build_panel
from svjedi_tpu.graph.svparse import parse_vcf_svs
from svjedi_tpu.io.fasta import read_fasta
from svjedi_tpu.io.fastq import read_reads
from svjedi_tpu.utils.native import load_native

cfg = AlignConfig()
chroms = read_fasta(TEST_DIR / "reference_genome.fasta")
parsed = parse_vcf_svs(
    TEST_DIR / "test.vcf", {c: len(s) for c, s in chroms.items()}
)
graph = build_graph(chroms, parsed)
panel = build_panel(graph, flank=cfg.flank, cluster_gap=cfg.cluster_gap,
                    max_paths_per_cluster=cfg.max_paths_per_cluster)
index = build_panel_index(panel, k=cfg.kmer, w=cfg.window,
                          max_hits_per_minimizer=cfg.max_hits_per_minimizer)
decoy = build_decoy(panel, k=cfg.kmer, w=cfg.window,
                    max_hits_per_minimizer=cfg.max_hits_per_minimizer)
combo = merge_indexes(index, decoy.index)
n_panel = len(index.path_len)

base = read_reads(str(TEST_DIR / "simulated_reads.fastq.gz"))
chunk = base  # one pipeline chunk = the 519-read bundle
cp = ChainParams(min_anchors=cfg.min_anchors, max_chains=cfg.max_chains,
                 max_gap=cfg.chain_max_gap, drift_abs=cfg.chain_drift_abs,
                 drift_permille=cfg.chain_drift_permille,
                 block_rows=cfg.block_rows,
                 ext_min_anchors=cfg.chain_ext_min_anchors)
native = load_native()
combo.native_lookup()  # prebuild

for it in range(4):
    t0 = time.perf_counter()
    dd = dev.upload(chunk.codes, panel, {}, offsets=chunk.offsets)
    t1 = time.perf_counter()
    out = dev_scan.dispatch_scan(dd, combo.k, combo.w)
    t2 = time.perf_counter()
    bits = dev_scan.fetch_bitmask(out)
    t3 = time.perf_counter()
    cands = seed_candidates(chunk, combo, chain_params=cp,
                            threads=cfg.threads,
                            panel_path_limit=n_panel, bits=bits)
    t4 = time.perf_counter()
    is_panel = cands.path < n_panel
    dec = cands.take(~is_panel, path_offset=-n_panel)
    pc = cands.take(is_panel)
    keep, mo, ms = suppress_candidates(
        chunk, pc, index, decoy, cp, threads=cfg.threads, dec=dec,
        return_margins=True,
    )
    t5 = time.perf_counter()
    print(f"iter{it}: upload={t1-t0:.3f} dispatch={t2-t1:.3f} "
          f"fetch={t3-t2:.3f} chain5={t4-t3:.3f} suppress={t5-t4:.3f} "
          f"n_cands={len(cands)}")

# chain5 CPU cost isolated (bits already on host), thread sweep:
for thr in (1, 2, 4):
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        seed_candidates(chunk, combo, chain_params=cp, threads=thr,
                        panel_path_limit=n_panel, bits=bits)
        ts.append(time.perf_counter() - t0)
    print(f"chain5 threads={thr}: best={min(ts):.3f}")

# Host-scan path for comparison:
t0 = time.perf_counter()
seed_candidates(chunk, combo, chain_params=cp, threads=cfg.threads,
                panel_path_limit=n_panel)
print(f"host scan+chain (svt_chain3): {time.perf_counter()-t0:.3f}")
