"""Per-shard retry (SURVEY §5.3 failure detection / recovery).

A device fault during the batched result fetch must not lose the
in-flight chunks: the align stage falls back to re-dispatching each
pending chunk from its kept candidates and processing it alone, with one
retry, producing byte-identical counts.
"""

import numpy as np

import svjedi_tpu.align.pipeline as pl
from svjedi_tpu.align.index import build_panel_index
from svjedi_tpu.config import AlignConfig, GenotypeConfig
from svjedi_tpu.graph.build import build_graph
from svjedi_tpu.graph.cluster import build_panel
from svjedi_tpu.graph.svparse import parse_vcf_svs
from svjedi_tpu.io import sim
from svjedi_tpu.io.fastq import ReadSet, encode_ascii


def _workload():
    import os
    import tempfile

    rng = np.random.default_rng(4)
    s = sim.simulate(seed=6, chrom_lengths={"c1": 60_000}, n_svs=8)
    names, seqs = sim.simulate_reads(
        rng, s.haplotypes, coverage=6.0, mean_len=3000, sd_len=500
    )
    with tempfile.TemporaryDirectory() as tmp:
        vcf = os.path.join(tmp, "t.vcf")
        sim.write_truth_vcf(s, vcf)
        parsed = parse_vcf_svs(vcf, {c: len(x) for c, x in s.chroms.items()})
    graph = build_graph(s.chroms, parsed)
    cfg = AlignConfig()
    panel = build_panel(graph, flank=cfg.flank, cluster_gap=cfg.cluster_gap)
    index = build_panel_index(panel, k=cfg.kmer, w=cfg.window)
    codes = np.concatenate([encode_ascii(x) for x in seqs])
    offsets = np.concatenate(
        [[0], np.cumsum([len(x) for x in seqs])]
    ).astype(np.int64)
    reads = ReadSet(names=names, codes=codes, offsets=offsets)
    return reads, panel, index, cfg


def test_bulk_fetch_failure_recovers_per_chunk(monkeypatch, capsys):
    reads, panel, index, cfg = _workload()
    gcfg = GenotypeConfig()
    clean, _, _ = pl.align_and_count(
        reads, panel, index, cfg, gcfg, collect_audit=False
    )

    real = pl.collect_outs
    state = {"fails": 1}

    def flaky(dispatches):
        if state["fails"]:
            state["fails"] -= 1
            raise RuntimeError("injected fetch failure")
        return real(dispatches)

    monkeypatch.setattr(pl, "collect_outs", flaky)
    timings = {}
    recovered, _, _ = pl.align_and_count(
        reads, panel, index, cfg, gcfg, collect_audit=False, timings=timings
    )
    assert recovered == clean
    assert timings.get("n_retries", 0) >= 1
    assert "per-chunk recovery" in capsys.readouterr().err


def test_persistent_failure_raises(monkeypatch):
    reads, panel, index, cfg = _workload()
    gcfg = GenotypeConfig()

    def dead(dispatches):
        raise RuntimeError("device gone")

    monkeypatch.setattr(pl, "collect_outs", dead)
    import pytest

    with pytest.raises(RuntimeError):
        pl.align_and_count(
            reads, panel, index, cfg, GenotypeConfig(), collect_audit=False
        )
