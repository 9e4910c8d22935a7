#!/usr/bin/env python3
"""Benchmark: read-to-graph alignment throughput (reads/s/chip).

Driver contract: print exactly ONE JSON line
``{"metric": ..., "value": N, "unit": ..., "vs_baseline": N}`` on stdout.

Workload: the reference test-dir bundle (519 real simulated long reads,
~4.3 Mb) replicated REPS times and pushed through the full align stage
(minimizer seeding → candidate voting → banded DP on the device → winner
reduction → allele-support counting), i.e. everything between "reads on
disk" and "per-SV counts". Correctness is asserted on the fly: the counts
from the benchmark run must reproduce the golden 40/40 genotype calls.

Baseline: the reference pipeline's aligner is minigraph (not available in
this image; the repo publishes no perf numbers, BASELINE.md). ``vs_baseline``
therefore reports our GPU throughput relative to minigraph's documented
long-read mapping throughput class on a multicore CPU (~4 Mb/s/thread ≈
≈500 reads/s on this read-length mix, Li 2020); override with
SVJT_BASELINE_READS_PER_S if a measured local baseline exists.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

TEST_DIR = Path(os.environ.get("SVJT_TESTDIR", "/root/reference/test-dir"))
REPS = int(os.environ.get("SVJT_BENCH_REPS", "10"))
#: minigraph-class CPU baseline (reads/s on this read mix); see docstring.
BASELINE_READS_PER_S = float(os.environ.get("SVJT_BASELINE_READS_PER_S", "500"))
#: "golden" (default; replicated test-dir bundle, golden-gated) or "scale"
#: (simulated 10 Mb / 1,000 SVs / 20x, truth-concordance-gated).
CONFIG = os.environ.get("SVJT_BENCH_CONFIG", "golden")


def _build_decoy(panel, cfg):
    """Whole-genome decoy index, exactly as run_pipeline builds it.

    The decoy competition is part of the production align stage (it is what
    gives the aligner minigraph's whole-graph specificity), so the bench
    must run — and time — it too.
    """
    if not cfg.decoy:
        return None
    from svjedi_tpu.align.decoy import build_decoy

    return build_decoy(
        panel, k=cfg.kmer, w=cfg.window,
        max_hits_per_minimizer=cfg.max_hits_per_minimizer,
    )


def _scale_bench() -> int:
    """Throughput on the BASELINE.md production-scale simulated config.

    Size knobs (defaults = the 10 Mb config): SVJT_SCALE_MB genome
    megabases, SVJT_SCALE_SVS SV count, SVJT_SCALE_COV read coverage.
    """
    import resource

    import numpy as np

    from svjedi_tpu.align.index import build_panel_index
    from svjedi_tpu.align.pipeline import align_and_count
    from svjedi_tpu.config import AlignConfig, GenotypeConfig
    from svjedi_tpu.graph.build import build_graph
    from svjedi_tpu.graph.cluster import build_panel
    from svjedi_tpu.graph.svparse import parse_vcf_svs
    from svjedi_tpu.io import sim
    from svjedi_tpu.io.fastq import ReadStream

    import tempfile

    def rss_gb() -> float:
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6

    def cur_rss_gb() -> float:
        """Current (not peak) resident set, GB."""
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1e6
        return 0.0

    # Optional phase-tagged RSS profile (SVJT_SCALE_MEMLOG=/path.tsv): a
    # sampler thread records current RSS twice a second plus the active
    # phase label — used to attribute Gb-scale peak memory to a phase
    # (sim / graph / index / decoy / align) instead of guessing from the
    # single end-of-run peak number.
    memlog = os.environ.get("SVJT_SCALE_MEMLOG")
    mem_phase = ["start"]
    if memlog:
        import threading

        def _sampler(path=memlog):
            t_start = time.perf_counter()
            with open(path, "w") as fh:
                fh.write("t_s\trss_gb\tphase\n")
                while True:
                    fh.write(
                        f"{time.perf_counter() - t_start:.1f}\t"
                        f"{cur_rss_gb():.2f}\t{mem_phase[0]}\n"
                    )
                    fh.flush()
                    time.sleep(0.5)

        threading.Thread(target=_sampler, daemon=True).start()

    mb = int(os.environ.get("SVJT_SCALE_MB", "10"))
    n_svs = int(os.environ.get("SVJT_SCALE_SVS", "1000"))
    cov = float(os.environ.get("SVJT_SCALE_COV", "20"))
    # BASELINE config-3 style knobs: a multi-chromosome genome and the
    # full SV-type mix (DEL/INS/INV plus BND translocation events).
    n_chroms = int(os.environ.get("SVJT_SCALE_CHROMS", "1"))
    sv_types = tuple(
        os.environ.get("SVJT_SCALE_TYPES", "DEL,INS,INV").split(",")
    )
    per = mb * 1_000_000 // n_chroms
    rng = np.random.default_rng(11)
    mem_phase[0] = "sim"
    s = sim.simulate(
        seed=2,
        chrom_lengths={f"chr{i + 1}": per for i in range(n_chroms)},
        n_svs=n_svs,
        sv_types=sv_types,
    )
    cfg = AlignConfig()
    gcfg = GenotypeConfig()
    with tempfile.TemporaryDirectory() as tmp:
        # Reads stream to disk as generated and stream back during
        # alignment (io.fastq.ReadStream): reads-resident memory is
        # O(chunk) — the whole point of the Gb-genome path. The old
        # in-memory form held coverage x genome of codes (83 MB RSS per
        # genome-Mb, PERF.md scale table).
        reads_path = os.path.join(tmp, "reads.fastq")
        mem_phase[0] = "sim_reads"
        n_reads, n_bases = sim.simulate_reads_fastq(
            rng, s.haplotypes, coverage=cov, path=reads_path
        )
        vcf = os.path.join(tmp, "t.vcf")
        sim.write_truth_vcf(s, vcf)
        parsed = parse_vcf_svs(vcf, {c: len(x) for c, x in s.chroms.items()})
        mem_phase[0] = "graph"
        graph = build_graph(s.chroms, parsed)
        mem_phase[0] = "panel"
        panel = build_panel(
            graph, flank=cfg.flank, cluster_gap=cfg.cluster_gap,
            max_paths_per_cluster=cfg.max_paths_per_cluster,
        )
        mem_phase[0] = "index"
        index = build_panel_index(
            panel, k=cfg.kmer, w=cfg.window,
            max_hits_per_minimizer=cfg.max_hits_per_minimizer,
        )
        mem_phase[0] = "decoy"
        decoy = _build_decoy(panel, cfg)
        # Drop the simulation's own big strings before aligning so peak
        # RSS reflects the pipeline, not the generator (the haplotypes
        # are already on disk as reads; the graph holds the reference).
        s = None
        import gc

        gc.collect()
        pre_align_resident_gb = cur_rss_gb()
        # SVJT_SCALE_ONE_PASS=1: time the first (warm) pass and skip the
        # second. For multi-hour Gb-scale runs the compile/warmup cost
        # amortized over millions of reads is noise (the persistent JAX
        # cache makes compiles ~free on a warm machine), and one pass
        # halves the wall clock; the accuracy gate still runs.
        one_pass = os.environ.get("SVJT_SCALE_ONE_PASS", "0") == "1"
        mem_phase[0] = "align_warm"
        t0_warm = time.perf_counter()
        counts, _, _ = align_and_count(
            ReadStream(reads_path), panel, index, cfg, gcfg,
            collect_audit=False, decoy=decoy,
        )  # warm + correctness input
        warm_dt = time.perf_counter() - t0_warm
        from svjedi_tpu.evals.contingency import contingency_report
        from svjedi_tpu.genotype.vcf_writer import write_genotyped_vcf

        out_vcf = os.path.join(tmp, "g.vcf")
        write_genotyped_vcf(vcf, out_vcf, counts)
        report = contingency_report(vcf, out_vcf)
        # The default 10 Mb/1000 SV/20x config genotypes 1000/1000 (gate
        # 100.0). Larger/lower-coverage configs hit the data's own ceiling:
        # at 12x, ~0.3% of het SVs have zero spanning reads from one
        # haplotype (verified read-by-read for the 50 Mb config's misses,
        # PERF.md), so the gate is tunable for those runs.
        min_acc = float(os.environ.get("SVJT_SCALE_MIN_ACC", "100.0"))
        import re as _re

        acc_m = _re.search(r"accuracy: ([\d.]+)", report)
        if acc_m is None or float(acc_m.group(1)) < min_acc:
            print(json.dumps({
                "metric": "scale_reads_per_s_per_chip", "value": 0.0,
                "unit": "reads/s", "vs_baseline": 0.0,
                "error": "scale accuracy check failed",
            }))
            return 1
        if one_pass:
            dt = warm_dt
        else:
            stream = ReadStream(reads_path)
            mem_phase[0] = "align_timed"
            t0 = time.perf_counter()
            align_and_count(
                stream, panel, index, cfg, gcfg, collect_audit=False,
                decoy=decoy,
            )
            dt = time.perf_counter() - t0
    # Memory/size profile for PERF.md's scale table (stderr, not the
    # driver's JSON line).
    print(
        f"[scale] genome={mb}Mb chroms={n_chroms} "
        f"types={','.join(sv_types)} svs={n_svs} cov={cov} "
        f"reads={n_reads} read_bases={int(n_bases/1e6)}Mb "
        f"panel_paths={len(panel.paths)} "
        f"panel_bases={sum(p.length for p in panel.paths)/1e6:.1f}Mb "
        f"decoy_hits={len(decoy.index.hit_path) if decoy else 0} "
        f"align_s={dt:.1f} peak_host_rss_gb={rss_gb():.1f} "
        f"pre_align_resident_gb={pre_align_resident_gb:.1f} "
        f"post_align_resident_gb={cur_rss_gb():.1f}",
        file=sys.stderr,
    )
    print(json.dumps({
        "metric": "scale_reads_per_s_per_chip",
        "value": round(n_reads / dt, 2),
        "unit": "reads/s",
        "vs_baseline": round(n_reads / dt / BASELINE_READS_PER_S, 3),
    }))
    return 0


def main() -> int:
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))

    # The native I/O/minimizer library is a gitignored build artifact; build
    # it so a fresh checkout benches the real configuration (a failed build
    # would silently fall back to numpy seeding, so it is fatal).
    import subprocess

    subprocess.run(["make", "-C", str(root / "native")], check=True,
                   capture_output=True)

    from svjedi_tpu.utils.jax_cache import configure_compile_cache

    configure_compile_cache()
    import jax

    dev0 = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip() if dev0.platform == "gpu" else "-"
    print(
        f"[bench] platform={dev0.platform} device_kind={dev0.device_kind} "
        f"devices={len(jax.devices())} card={card!r}",
        file=sys.stderr,
    )

    if CONFIG == "scale":
        return _scale_bench()

    from svjedi_tpu.align.index import build_panel_index
    from svjedi_tpu.align.pipeline import align_and_count
    from svjedi_tpu.config import AlignConfig, GenotypeConfig
    from svjedi_tpu.graph.build import build_graph
    from svjedi_tpu.graph.cluster import build_panel
    from svjedi_tpu.graph.svparse import parse_vcf_svs
    from svjedi_tpu.io.fasta import read_fasta
    from svjedi_tpu.io.fastq import ReadSet, read_reads

    align_cfg = AlignConfig()
    genotype_cfg = GenotypeConfig()

    chroms = read_fasta(TEST_DIR / "reference_genome.fasta")
    parsed = parse_vcf_svs(
        TEST_DIR / "test.vcf", {c: len(s) for c, s in chroms.items()}
    )
    graph = build_graph(chroms, parsed)
    panel = build_panel(
        graph,
        flank=align_cfg.flank,
        cluster_gap=align_cfg.cluster_gap,
        max_paths_per_cluster=align_cfg.max_paths_per_cluster,
    )
    index = build_panel_index(
        panel, k=align_cfg.kmer, w=align_cfg.window,
        max_hits_per_minimizer=align_cfg.max_hits_per_minimizer,
    )

    decoy = _build_decoy(panel, align_cfg)

    base = read_reads(str(TEST_DIR / "simulated_reads.fastq.gz"))

    # Warmup pass (compiles every DP bucket shape) and correctness check:
    # counts must reproduce the golden genotypes.
    counts, _, _ = align_and_count(
        base, panel, index, align_cfg, genotype_cfg, collect_audit=False,
        decoy=decoy,
    )
    import tempfile

    from svjedi_tpu.evals.contingency import contingency_report
    from svjedi_tpu.genotype.vcf_writer import write_genotyped_vcf

    with tempfile.TemporaryDirectory() as tmp:
        out_vcf = Path(tmp) / "g.vcf"
        write_genotyped_vcf(TEST_DIR / "test.vcf", out_vcf, counts)
        report = contingency_report(TEST_DIR / "test.vcf", out_vcf)
    golden = (TEST_DIR / "expected_genotype.vcf.eval").read_text()
    if report != golden:
        print(
            json.dumps(
                {
                    "metric": "reads_per_s_per_chip",
                    "value": 0.0,
                    "unit": "reads/s",
                    "vs_baseline": 0.0,
                    "error": "golden genotype check failed",
                }
            )
        )
        return 1

    # Timed run on the replicated read set.
    reps = ReadSet(
        names=[f"{n}/{r}" for r in range(REPS) for n in base.names],
        codes=np.tile(base.codes, REPS),
        offsets=np.concatenate(
            [base.offsets[:-1] + r * base.codes.size for r in range(REPS)]
            + [np.array([base.codes.size * REPS])]
        ),
    )
    # Pass 0 warms every compiled shape and host buffer; the later passes
    # measure steady state, reported as the median pass with the spread on
    # stderr.
    n_passes = int(os.environ.get("SVJT_BENCH_PASSES", "8"))
    # Chunked passes pipeline the host seed stage of chunk i+1 with the
    # device DP of chunk i (align_and_count's seeder thread); one monolithic
    # chunk would serialize them.
    chunk_reads = int(os.environ.get("SVJT_BENCH_CHUNK_READS", "2048"))
    # Small flush groups overlap the fetch/winner rounds with the seeder
    # thread's later chunks (see align_and_count).
    flush_every = int(os.environ.get("SVJT_BENCH_FLUSH_EVERY", "2"))
    steady = []
    for pass_i in range(n_passes):
        timings = {}
        t0 = time.perf_counter()
        align_and_count(reps, panel, index, align_cfg, genotype_cfg,
                        collect_audit=False, timings=timings, decoy=decoy,
                        chunk_reads=chunk_reads, flush_every=flush_every)
        pass_dt = time.perf_counter() - t0
        if pass_i > 0:
            steady.append(pass_dt)
        print(
            f"[bench] pass{pass_i} reads={reps.n_reads} total={pass_dt:.2f}s "
            + " ".join(f"{k}={v:.2f}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in timings.items() if k != "dp_batches"),
            file=sys.stderr,
        )
    dt = float(np.median(steady))
    print(f"[bench] steady passes min/median/max "
          f"{min(steady):.3f}/{dt:.3f}/{max(steady):.3f} s", file=sys.stderr)

    reads_per_s = reps.n_reads / dt
    result = {
        "metric": "reads_per_s_per_chip",
        "value": round(reads_per_s, 2),
        "unit": "reads/s",
        "vs_baseline": round(reads_per_s / BASELINE_READS_PER_S, 3),
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
