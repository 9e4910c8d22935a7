#!/usr/bin/env python3
"""CUDA banded-DP kernel vs ``band_dp_batch`` compiled by XLA, on one GPU.

    python tools/dp_engine_compare.py [--out chiprun_out/dp_engine_compare.json]

Both engines run in this one process, in turns:

1. end to end: ``align_and_count`` over the seeded 10 Mb / 1,000 SV / 20x
   bundle (``io.sim.write_bundle``), once per engine to compile, then timed
   in the order cuda, xla, xla, cuda; the two engines' counts must be equal;
2. per bucket: at every (bucket, batch) shape the dispatcher formed in the
   timed cuda pass, on real candidate windows of that bucket (window-length
   order, padded with empty problems as the dispatcher pads), the kernel
   and the XLA scan timed in turns; buckets the bundle never forms are
   timed at full width on 256 problems.

Cell-updates/s count useful cells (window rows x band) for both engines.
The card's name and power limit go beside every number.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _time(fn, reps: int = 3) -> float:
    """Median seconds of ``fn()`` (which blocks on its result)."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "dp_engine_compare.json"))
    args = ap.parse_args()

    import jax
    import numpy as np

    if jax.devices()[0].platform != "gpu":
        print("dp_engine_compare: needs a GPU", file=sys.stderr)
        return 1
    from svjedi_tpu.align import device as dev
    from svjedi_tpu.align.decoy import build_decoy
    from svjedi_tpu.align.extend import DPParams
    from svjedi_tpu.align.index import build_panel_index
    from svjedi_tpu.align.pipeline import (
        _pick_bucket, align_and_count, candidate_layout,
    )
    from svjedi_tpu.align.seed import ChainParams, seed_candidates
    from svjedi_tpu.config import AlignConfig, GenotypeConfig
    from svjedi_tpu.graph.build import build_graph
    from svjedi_tpu.graph.cluster import build_panel
    from svjedi_tpu.graph.svparse import parse_vcf_svs
    from svjedi_tpu.io.fasta import read_fasta
    from svjedi_tpu.io.fastq import ReadStream
    from svjedi_tpu.io.sim import write_bundle
    from svjedi_tpu.kernels import band_dp_cuda
    from svjedi_tpu.utils.jax_cache import configure_compile_cache

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    configure_compile_cache()
    subprocess.run(["make", "-C", str(ROOT / "native")], check=True,
                   capture_output=True)
    band_dp_cuda.register()
    cfg, gcfg = AlignConfig(), GenotypeConfig()
    result = {"card": card, "device_kind": jax.devices()[0].device_kind}

    with tempfile.TemporaryDirectory() as tmp:
        bundle = write_bundle(Path(tmp) / "bundle")
        chroms = read_fasta(bundle["ref"])
        parsed = parse_vcf_svs(bundle["vcf"],
                               {c: len(s) for c, s in chroms.items()})
        panel = build_panel(
            build_graph(chroms, parsed), flank=cfg.flank,
            cluster_gap=cfg.cluster_gap,
            max_paths_per_cluster=cfg.max_paths_per_cluster,
        )
        index = build_panel_index(
            panel, k=cfg.kmer, w=cfg.window,
            max_hits_per_minimizer=cfg.max_hits_per_minimizer,
        )
        decoy = build_decoy(panel, k=cfg.kmer, w=cfg.window,
                            max_hits_per_minimizer=cfg.max_hits_per_minimizer)

        def e2e(engine):
            timings = {}
            t0 = time.perf_counter()
            counts, _, _ = align_and_count(
                ReadStream(bundle["reads"]), panel, index, cfg, gcfg,
                decoy=decoy, timings=timings, _engine=engine,
            )
            return time.perf_counter() - t0, counts, timings

        runs = {"cuda": [], "xla": []}
        warm = {}
        for engine in ("cuda", "xla"):
            dt, counts, _ = e2e(engine)
            warm[engine] = (dt, counts)
            print(f"[compare] warm {engine}: {dt:.2f} s  ({card})",
                  flush=True)
        if warm["cuda"][1] != warm["xla"][1]:
            raise AssertionError("engines disagree on counts")
        for engine in ("cuda", "xla", "xla", "cuda"):
            dt, counts, timings = e2e(engine)
            assert counts == warm["cuda"][1]
            runs[engine].append({
                "wall_s": dt,
                "batches": timings.pop("dp_batches"),
                "timings": timings,
            })
            print(f"[compare] e2e {engine}: {dt:.2f} s "
                  f"({bundle['n_reads'] / dt:.1f} reads/s), fetch+DP wait "
                  f"{timings.get('fetch_s', 0.0):.2f} s  ({card})",
                  flush=True)
        result["n_reads"] = bundle["n_reads"]
        result["end_to_end"] = {
            e: {"wall_s": [r["wall_s"] for r in rs],
                "reads_per_s": [bundle["n_reads"] / r["wall_s"] for r in rs],
                "timings": [r["timings"] for r in rs]}
            for e, rs in runs.items()
        }

        # ---- per bucket at the dispatcher's shapes ----
        shapes = sorted({(b, pp) for b, pp, _ in runs["cuda"][0]["batches"]})
        chunk = next(iter(ReadStream(bundle["reads"]).chunks(16384)))
        data = dev.upload(chunk.codes, panel, offsets=chunk.offsets)
        cands = seed_candidates(chunk, index, chain_params=ChainParams())
        _, m32, keep, q_start, t_start, t_lo, t_hi = candidate_layout(
            chunk, index, cands, cfg, data
        )
        order = np.flatnonzero(keep)
        bucket_of = np.array([_pick_bucket(int(v), cfg.buckets)
                              for v in m32[order]])
        params = DPParams(match=cfg.match, mismatch=cfg.mismatch,
                          gap_open=cfg.gap_open, gap_extend=cfg.gap_extend)
        seen = {b for b, _ in shapes}
        shapes += [(b, 256) for b in cfg.buckets if b not in seen]
        per_bucket = []
        for bucket, ppad in sorted(shapes):
            pool = order[bucket_of == bucket]
            full_width = len(pool) == 0
            if full_width:
                pool = order
            pool = pool[np.argsort(m32[pool], kind="stable")]
            n_real = min(ppad, len(pool))
            sel = pool[:n_real]
            meta = np.zeros((5, ppad), np.int32)
            meta[0, :n_real] = q_start[sel]
            meta[1, :n_real] = bucket if full_width else m32[sel]
            meta[2, :n_real] = t_start[sel]
            meta[3, :n_real] = t_lo[sel]
            meta[4, :n_real] = t_hi[sel]
            meta_d = jax.device_put(meta)
            useful = int(np.minimum(meta[1], bucket).sum()) * cfg.band

            def call(engine):
                return lambda: dev.window_score_packed(
                    data.reads2, data.panel_padded, meta_d, bucket=bucket,
                    band=cfg.band, params=params, engine=engine,
                ).block_until_ready()

            a = np.asarray(call("cuda")())
            b = np.asarray(call("xla")())
            assert np.array_equal(a, b), (bucket, ppad)
            tk, tx = [], []
            for engine in ("cuda", "xla", "xla", "cuda"):
                (tk if engine == "cuda" else tx).append(
                    _time(call(engine)))
            row = {
                "bucket": bucket, "batch": ppad, "real_problems": n_real,
                "full_width": full_width, "useful_cells": useful,
                "cuda_s": statistics.median(tk),
                "xla_s": statistics.median(tx),
            }
            row["cuda_gcells_per_s"] = useful / row["cuda_s"] / 1e9
            row["xla_gcells_per_s"] = useful / row["xla_s"] / 1e9
            per_bucket.append(row)
            print(f"[compare] bucket {bucket} batch {ppad} "
                  f"({n_real} real{', full width' if full_width else ''}): "
                  f"cuda {row['cuda_s'] * 1e3:.2f} ms "
                  f"({row['cuda_gcells_per_s']:.1f} Gcell/s), xla "
                  f"{row['xla_s'] * 1e3:.2f} ms "
                  f"({row['xla_gcells_per_s']:.1f} Gcell/s)  ({card})",
                  flush=True)
        result["per_bucket"] = per_bucket

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps({
        "card": card,
        "reads_per_s": {e: v["reads_per_s"]
                        for e, v in result["end_to_end"].items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
