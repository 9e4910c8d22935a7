"""End-to-end pipeline: VCF + FASTA + FASTQ → genotyped VCF.

In-process equivalent of the reference's four-subprocess orchestration
(svjedi-graph.py:26-128), with the same artifact contract on disk when
``keep_artifacts`` is set: ``<prefix>.gfa``, ``<prefix>_svs_edges.json``,
``<prefix>_ignored_svs.txt``, ``<prefix>_informative_aln.json``,
``<prefix>_genotype.vcf`` — plus ``<prefix>_stats.json`` (ours).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

from .config import PipelineConfig
from .graph.build import (
    build_graph,
    write_gfa,
    write_ignored_svs,
    write_svs_edges_json,
)
from .graph.cluster import build_panel
from .graph.svparse import parse_vcf_svs
from .align.index import build_panel_index
from .align.pipeline import align_and_count
from .genotype.filter_gaf import write_informative_json
from .genotype.vcf_writer import write_genotyped_vcf
from .io.fasta import read_fasta
from .io.fastq import read_reads
from .utils.stats import RunStats


def merge_shards(
    vcf,
    prefix: str,
    n_shards: int,
    out_vcf=None,
    min_support: int = 3,
    err: float = 0.00005,
) -> Dict:
    """Merge per-host shard audit tables and genotype once.

    The only cross-read state in the whole pipeline is the per-(SV, allele)
    alignment list, so the multi-host reduction is a concatenation + count
    (associative and order-independent; SURVEY §2.2).
    """
    merged: Dict = {}
    for i in range(n_shards):
        path = f"{prefix}.shard{i}of{n_shards}_informative_aln.json"
        with open(path) as fh:
            part = json.load(fh)
        for tag, pair in part.items():
            entry = merged.setdefault(tag, [[], []])
            entry[0].extend(pair[0])
            entry[1].extend(pair[1])
    from .genotype.filter_gaf import counts_from_informative

    write_informative_json(merged, f"{prefix}_informative_aln.json")
    counts = counts_from_informative(merged)
    out_vcf = out_vcf or f"{prefix}_genotype.vcf"
    summary = write_genotyped_vcf(
        vcf, out_vcf, counts, min_support=min_support, err=err
    )
    return {"counts": counts, "output_vcf": out_vcf, "summary": summary}


def run_pipeline(cfg: PipelineConfig) -> Dict:
    """Run all stages; returns summary info."""
    stats = RunStats()
    prefix = cfg.prefix

    proc_idx, proc_cnt = 0, 1
    if cfg.multihost:
        # jax.distributed.initialize must precede ANY backend-touching JAX
        # call (jax 0.9 refuses otherwise), so the process group joins
        # before any stage that might reach the device.
        from .dist.multihost import initialize

        proc_idx, proc_cnt = initialize()
        stats.set("process", f"{proc_idx}/{proc_cnt}")

    with stats.timer("load_reference"):
        chroms = read_fasta(cfg.ref)
        chrom_lengths = {c: len(s) for c, s in chroms.items()}

    with stats.timer("construct_graph"):
        parsed = parse_vcf_svs(cfg.vcf, chrom_lengths)
        graph = build_graph(chroms, parsed)
    stats.set("n_svs", len(parsed.svs))
    stats.set("n_discarded_svs", len(parsed.discarded))
    stats.set("n_nodes", graph.n_nodes)
    stats.set("n_links", len(graph.links))
    if cfg.keep_artifacts:
        write_gfa(graph, f"{prefix}.gfa")
        write_svs_edges_json(graph, f"{prefix}_svs_edges.json")
        write_ignored_svs(parsed, f"{prefix}_ignored_svs.txt")

    # Stage-artifact resume (SURVEY §5.4: the reference's on-disk staging
    # gives de-facto resumability; we honor the same contract): with an
    # existing informative-aln JSON, the aligner is skipped and counts come
    # from the audit table.
    informative_path = Path(f"{prefix}_informative_aln.json")
    if cfg.resume and informative_path.exists():
        from .genotype.filter_gaf import counts_from_informative

        with informative_path.open() as fh:
            audit = json.load(fh)
        counts = counts_from_informative(audit)
        stats.set("resumed_from", str(informative_path))
        with stats.timer("genotype"):
            out_vcf = f"{prefix}_genotype.vcf"
            summary = write_genotyped_vcf(
                cfg.vcf, out_vcf, counts,
                min_support=cfg.genotype.min_support, err=cfg.genotype.err,
            )
        stats.counters.update(summary)
        stats.dump(f"{prefix}_stats.json")
        return {"counts": counts, "stats": stats, "output_vcf": out_vcf}

    with stats.timer("build_panel"):
        panel = build_panel(
            graph,
            flank=cfg.align.flank,
            cluster_gap=cfg.align.cluster_gap,
            max_paths_per_cluster=cfg.align.max_paths_per_cluster,
            max_hops_per_path=cfg.align.max_hops_per_path,
        )
        index = build_panel_index(
            panel,
            k=cfg.align.kmer,
            w=cfg.align.window,
            max_hits_per_minimizer=cfg.align.max_hits_per_minimizer,
        )
    stats.set("n_clusters", len(panel.clusters))
    stats.set("n_panel_paths", panel.n_paths)
    stats.set("panel_bases", panel.total_bases())
    truncated = [cl.cluster_id for cl in panel.clusters if cl.truncated]
    stats.set("panel_truncated_clusters", len(truncated))
    if truncated:
        # Every (SV, allele) link stays countable via the per-SV fallback
        # sub-panels (graph/cluster.py build_panel), but combination
        # haplotypes beyond the cap are not enumerated — genotypes in
        # these neighborhoods may degrade; never silently.
        import sys as _sys

        affected = sorted({
            t
            for cl in panel.clusters
            if cl.truncated
            for pi in cl.paths
            for (t, *_rest) in panel.paths[pi].owned
        })
        print(
            f"[panel] WARNING: {len(truncated)} cluster(s) hit the "
            f"haplotype-walk enumeration cap "
            f"(max_paths_per_cluster={cfg.align.max_paths_per_cluster}); "
            "per-SV fallback sub-panels keep every allele countable. "
            f"Affected SVs: {', '.join(affected[:12])}"
            + (" ..." if len(affected) > 12 else ""),
            file=_sys.stderr,
        )
        stats.set("panel_truncated_svs", affected)

    decoy = None
    if cfg.align.decoy:
        if cfg.dist.decoy_shards > 1:
            # Sharded whole-genome competition (dist/decoy_shard.py): each
            # shard is built WITHOUT the full hit table ever existing; in
            # one process all G shards end up resident (equality mode) —
            # on a (data x graph) process grid each host builds only its
            # own shard and holds ~1/G of the table.
            from .dist.decoy_shard import build_decoy_shard

            G = cfg.dist.decoy_shards
            with stats.timer("build_decoy"):
                decoy = [
                    build_decoy_shard(
                        panel, G, g, k=cfg.align.kmer, w=cfg.align.window,
                        max_hits_per_minimizer=(
                            cfg.align.max_hits_per_minimizer
                        ),
                    )
                    for g in range(G)
                ]
            stats.set("decoy_shards", G)
            stats.set(
                "decoy_shard_hit_bytes", [s.hit_bytes() for s in decoy]
            )
        else:
            from .align.decoy import build_decoy

            with stats.timer("build_decoy"):
                decoy = build_decoy(
                    panel,
                    k=cfg.align.kmer,
                    w=cfg.align.window,
                    max_hits_per_minimizer=cfg.align.max_hits_per_minimizer,
                )

    # Read loading: streamed (O(chunk) resident — the Gb-genome mode) or
    # eager. Shard/multihost modes slice the read set by global index and
    # need it resident, so they always load eagerly.
    stream_mode = cfg.stream_reads
    if cfg.multihost or cfg.shard is not None:
        if stream_mode:
            import sys as _sys

            print(
                "[pipeline] note: --shard/--multihost need the full read "
                "set resident; streaming disabled for this run",
                file=_sys.stderr,
            )
        stream_mode = False
    elif stream_mode is None:
        stream_mode = True
    if stream_mode:
        from .io.fastq import ReadStream

        reads = ReadStream(cfg.reads)
        stats.set("read_loader", "stream")
    else:
        with stats.timer("load_reads"):
            reads = read_reads(cfg.reads)
            if cfg.multihost:
                from .dist.multihost import process_read_block

                lo, hi = process_read_block(reads.n_reads)
                reads = reads.slice(lo, hi)
                stats.set("process_block", f"[{lo},{hi})")
            elif cfg.shard is not None:
                i, n = cfg.shard
                lo = reads.n_reads * i // n
                hi = reads.n_reads * (i + 1) // n
                reads = reads.slice(lo, hi)
                stats.set("shard", f"{i}/{n}")
        stats.set("n_reads", reads.n_reads)
        stats.set("read_bases", int(reads.lengths.sum()))

    # Single-host multi-device data parallelism (DistConfig.data_shards):
    # read chunks round-robin over the first N local devices, panel
    # replicated per device; the per-(SV, allele) count sum — the
    # pipeline's only cross-read reduction — merges per-device results
    # exactly (SURVEY §2.2). Chunk size shrinks so every device gets work.
    devices = None
    chunk_reads = 16384
    if cfg.dist.data_shards > 1:
        import jax

        devs = jax.devices()
        n_dev = min(cfg.dist.data_shards, len(devs))
        if n_dev > 1:
            devices = devs[:n_dev]
            if not stream_mode:  # stream: count unknown until consumed
                chunk_reads = min(
                    chunk_reads, max(512, -(-reads.n_reads // n_dev))
                )
            stats.set("data_shards", n_dev)

    profiling = cfg.profile_dir is not None
    if profiling:
        import jax

        jax.profiler.start_trace(str(cfg.profile_dir))
    align_timings: Dict = {}
    with stats.timer("align"):
        counts, audit, winners = align_and_count(
            reads, panel, index, cfg.align, cfg.genotype, decoy=decoy,
            devices=devices, chunk_reads=chunk_reads, timings=align_timings,
        )
    for key in ("dp_engine", "device_scan", "n_retries", "n_candidates"):
        stats.set(key, align_timings[key])
    if profiling:
        import jax

        jax.profiler.stop_trace()
    if stream_mode:
        # Counts known only after the stream has been consumed.
        stats.set("n_reads", reads.n_reads)
        stats.set("read_bases", int(reads.total_bases))
    stats.set("n_winning_alignments", int(len(winners.read)))
    if winners.rescore_flag is not None:
        # Winners whose audit re-score fell below the chain score by more
        # than the slack: breakpoint-crossing spans bridging an alignment
        # discontinuity (see Winners.rescore_deficit). Surfaced so runs
        # can be compared; pinned on the golden bundle in
        # tests/test_end_to_end.py.
        stats.set("n_audit_rescore_below", int(winners.rescore_flag.sum()))
    if cfg.dist.graph_shards > 1:
        # On-mesh SPMD count merge (dist/count_merge.py): re-derive the
        # per-(SV, allele) matrix from the merged winners under shard_map
        # on a (data, graph) device mesh — entries sharded over data, tag
        # ranges over graph, ONE psum — byte-equal to the host reduction
        # (tests/test_mesh_count.py). This is the scalable counting path
        # for genomes whose tag table warrants sharding.
        import jax

        from .dist.count_merge import mesh_count_support
        from .dist.mesh import make_mesh

        n_dev = len(jax.devices())
        g = min(cfg.dist.graph_shards, n_dev)
        # Data axis: every remaining device unless --data-shards narrows it.
        d = max(1, n_dev // g)
        if cfg.dist.data_shards > 1:
            d = max(1, min(cfg.dist.data_shards, d))
        with stats.timer("mesh_count"):
            mesh = make_mesh(data_shards=d, graph_shards=g,
                             devices=jax.devices()[: d * g])
            from .config import resolve_min_count_density

            counts = mesh_count_support(
                panel, winners, mesh, d_over=cfg.genotype.d_over,
                min_density=resolve_min_count_density(
                    cfg.genotype, cfg.align
                ),
            )
        stats.set("mesh", f"{d}x{g}")
    if cfg.write_gaf:
        from .align.gaf_out import write_gaf as _write_gaf

        _write_gaf(f"{prefix}.gaf", panel, winners, reads)
    stats.set(
        "n_informative_alignments",
        int(sum(sum(v) for v in counts.values())),
    )
    if cfg.shard is not None:
        # Shard mode: emit this host's audit table and stop — merging (the
        # per-(SV, allele) count sum) and genotyping happen once, via the
        # ``merge`` command.
        i, n = cfg.shard
        shard_path = f"{prefix}.shard{i}of{n}_informative_aln.json"
        write_informative_json(audit, shard_path)
        stats.dump(f"{prefix}.shard{i}of{n}_stats.json")
        return {"counts": counts, "stats": stats, "shard_json": shard_path}
    if cfg.multihost and proc_cnt > 1:
        # The only cross-host reduction: sum the count tables over the
        # fabric; process 0 genotypes (dist/multihost.py).
        from .dist.multihost import allreduce_counts

        with stats.timer("count_allreduce"):
            counts = allreduce_counts(counts)
        if cfg.keep_artifacts:
            write_informative_json(
                audit, f"{prefix}.host{proc_idx}_informative_aln.json"
            )
        if proc_idx != 0:
            stats.dump(f"{prefix}.host{proc_idx}_stats.json")
            return {"counts": counts, "stats": stats, "output_vcf": None}
    elif cfg.keep_artifacts:
        write_informative_json(audit, f"{prefix}_informative_aln.json")

    with stats.timer("genotype"):
        out_vcf = f"{prefix}_genotype.vcf"
        summary = write_genotyped_vcf(
            cfg.vcf,
            out_vcf,
            counts,
            min_support=cfg.genotype.min_support,
            err=cfg.genotype.err,
        )
    stats.counters.update(summary)
    stats.dump(f"{prefix}_stats.json")
    return {
        "counts": counts,
        "stats": stats,
        "output_vcf": out_vcf,
    }
