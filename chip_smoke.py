#!/usr/bin/env python3
"""Smoke test of the genotyping path on one NVIDIA GPU.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # only the multi-card path, 4 cards

Phases (one process; it shells out only to nvidia-smi, make and nvcc):

1. device: prints nvidia-smi's name and power limit and requires
   ``jax.devices()[0].platform == "gpu"``. Without a GPU it exits non-zero
   and prints no result; there is no CPU fallback.
2. build: ``make -C native`` must succeed, the CUDA banded-DP kernel is
   built and registered, and the native chainer that the device minimizer
   scan feeds must be present.
3. equality at real widths: on candidate windows the production stages
   build from the bundle, the GPU engine equals ``band_dp_batch`` run on
   the CPU device for every bucket of ``AlignConfig.buckets``, exactly on
   all five outputs; the device minimizer scan's bitmask equals the native
   host scan bit for bit.
4. end to end: the seeded 10 Mb / 1,000 SV (DEL/INS/INV) / 20x bundle
   through ``svjedi_tpu run`` and ``eval``; requires accuracy 100.0, the
   device scan as the seeding path, and zero retries.

``--four-cards`` runs instead, on four cards, ``run --data-shards 4`` and
``run --data-shards 2 --graph-shards 2`` on the same bundle, each required
to write a genotyped VCF byte-equal to a one-card run, and
``__graft_entry__.dryrun_multichip(4)``.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
#: Problem cells (rows x band) the CPU reference checks per bucket: the CPU
#: is the slow side of the comparison.
CPU_CELL_BUDGET = 1 << 30


def _card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return proc.stdout.strip()


def _label(card: str) -> str:
    """One-line card label for the end of each result line."""
    lines = card.splitlines()
    if len(set(lines)) == 1 and len(lines) > 1:
        return f"{len(lines)} x {lines[0]}"
    return "; ".join(lines)


def _say(card: str, msg: str) -> None:
    print(f"[smoke] {msg}  ({_label(card)})", flush=True)


def _pad_pow2(n: int, floor: int = 256) -> int:
    p = floor
    while p < n:
        p <<= 1
    return p


def build_phase(card: str) -> None:
    from svjedi_tpu.kernels import band_dp_cuda
    from svjedi_tpu.utils.native import load_native

    t0 = time.perf_counter()
    proc = subprocess.run(["make", "-C", str(ROOT / "native")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"make -C native failed:\n{proc.stderr[-3000:]}")
    native = load_native()
    if native is None or not hasattr(native._lib, "svt_chain5"):
        raise RuntimeError("native chainer (svt_chain5) missing: the device "
                           "minimizer scan would not be used")
    t1 = time.perf_counter()
    lib = band_dp_cuda.register()
    _say(card, f"build: native {t1 - t0:.1f} s, CUDA kernel {lib.name} "
               f"{time.perf_counter() - t1:.1f} s")


def equality_phase(card: str, bundle, cfg, engine: str = "cuda",
                   n_reads: int = 4096) -> None:
    """GPU engine == band_dp_batch on the CPU device, every bucket; device
    scan == native host scan."""
    import jax
    import numpy as np

    from svjedi_tpu.align import dev_scan
    from svjedi_tpu.align import device as dev
    from svjedi_tpu.align.extend import DPParams
    from svjedi_tpu.align.index import build_panel_index
    from svjedi_tpu.align.pipeline import candidate_layout
    from svjedi_tpu.align.seed import ChainParams, seed_candidates
    from svjedi_tpu.graph.build import build_graph
    from svjedi_tpu.graph.cluster import build_panel
    from svjedi_tpu.graph.svparse import parse_vcf_svs
    from svjedi_tpu.io.fasta import read_fasta
    from svjedi_tpu.io.fastq import ReadStream
    from svjedi_tpu.utils.native import load_native

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
    chunk = next(iter(ReadStream(bundle["reads"]).chunks(n_reads)))
    cands = seed_candidates(chunk, index, chain_params=ChainParams())
    data = dev.upload(chunk.codes, panel, offsets=chunk.offsets)
    _, _, keep, q_start, t_start, t_lo, t_hi = candidate_layout(
        chunk, index, cands, cfg, data
    )
    real = np.flatnonzero(keep)
    cpu = jax.devices("cpu")[0]
    reads2_cpu = jax.device_put(data.reads2, cpu)
    panel_cpu = jax.device_put(data.panel_padded, cpu)
    params = DPParams(match=cfg.match, mismatch=cfg.mismatch,
                      gap_open=cfg.gap_open, gap_extend=cfg.gap_extend)
    _say(card, "equality: tolerance 0 on score, qs, ts, qe, te — the DP "
               "is integer arithmetic")
    for bucket in cfg.buckets:
        # Full-width windows (m = bucket) from real candidates, batch shape
        # a dispatcher pad class, bounded by the CPU reference's budget.
        cap = max(256, 1 << (CPU_CELL_BUDGET // (bucket * cfg.band))
                  .bit_length() - 1)
        P = min(_pad_pow2(len(real)), cap)
        sel = np.resize(real, P)
        meta = np.stack([q_start[sel], np.full(P, bucket, np.int32),
                         t_start[sel], t_lo[sel], t_hi[sel]]).astype(np.int32)
        kw = dict(bucket=bucket, band=cfg.band, params=params)
        got = np.asarray(dev.window_score_packed(
            data.reads2, data.panel_padded, jax.device_put(meta),
            engine=engine, **kw))
        ref = np.asarray(dev.window_score_packed(
            reads2_cpu, panel_cpu, jax.device_put(meta, cpu), engine="xla",
            **kw))
        if not np.array_equal(got, ref):
            bad = int((got != ref).any(axis=1).sum())
            raise AssertionError(
                f"bucket {bucket}: {bad}/{P} problems differ from the "
                "reference")
        _say(card, f"equality: bucket {bucket} x {P} problems "
                   f"({P * bucket * cfg.band / 1e9:.2f} G cells): "
                   f"{engine} == band_dp_batch on CPU, exact; "
                   f"{int((ref[:, 0] >= cfg.min_score).sum())} scored "
                   f">= min_score")

    bits = dev_scan.fetch_bitmask(
        dev_scan.dispatch_scan(data, cfg.kmer, cfg.window))
    got_read, got_pos = dev_scan.bitmask_positions(bits, chunk.offsets)
    m_read, m_pos, _, _ = load_native().minimizers(
        chunk.codes, chunk.offsets, cfg.kmer, cfg.window)
    long_enough = (np.diff(chunk.offsets) - cfg.kmer + 1)[m_read] >= cfg.window
    if not (np.array_equal(got_read, m_read[long_enough])
            and np.array_equal(got_pos, m_pos[long_enough])):
        raise AssertionError("device minimizer scan differs from the "
                             "native host scan")
    _say(card, f"equality: device minimizer scan == native host scan on "
               f"{chunk.n_reads} reads, {len(got_pos)} minimizers, "
               "bit for bit")


def _run(bundle, prefix: str, extra=()):
    from svjedi_tpu import cli

    argv = ["run", "-v", str(bundle["vcf"]), "-r", str(bundle["ref"]),
            "-q", str(bundle["reads"]), "-p", prefix, *extra]
    if cli.main(argv) != 0:
        raise RuntimeError(f"svjedi_tpu {' '.join(argv)} failed")
    stats = json.loads(Path(f"{prefix}_stats.json").read_text())
    return Path(f"{prefix}_genotype.vcf"), stats


def _accuracy(bundle, vcf: Path) -> tuple:
    from svjedi_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["eval", str(bundle["vcf"]), str(vcf)])
    report = buf.getvalue()
    acc = re.search(r"Genotyping accuracy: ([\d.]+)", report)
    return (float(acc.group(1)) if acc else 0.0), report


def end_to_end_phase(card: str, bundle, workdir: Path,
                     min_accuracy: float = 100.0) -> None:
    import jax

    t0 = time.perf_counter()
    vcf, stats = _run(bundle, str(workdir / "smoke"))
    wall = time.perf_counter() - t0
    acc, report = _accuracy(bundle, vcf)
    for line in report.strip().splitlines():
        print(f"[smoke] eval: {line}")
    counters, times = stats["counters"], stats["timings_s"]
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use", 0)
    n_reads = counters["n_reads"]
    _say(card, f"end to end: {n_reads} reads, {counters['read_bases']} "
               f"bases; run wall {wall:.2f} s ({n_reads / wall:.1f} reads/s); "
               f"align stage {times['align']:.2f} s "
               f"({n_reads / times['align']:.1f} reads/s); peak device "
               f"memory {peak / 2**30:.2f} GiB; engine "
               f"{counters['dp_engine']}; device scan "
               f"{counters['device_scan']}; retries {counters['n_retries']}")
    if not counters["device_scan"]:
        raise AssertionError("seeding fell back to the host minimizer scan")
    if counters["n_retries"] != 0:
        raise AssertionError(f"{counters['n_retries']} DP retries")
    if acc < min_accuracy:
        raise AssertionError(f"accuracy {acc} < {min_accuracy}")


def four_card_phase(card: str, bundle, workdir: Path) -> None:
    import __graft_entry__ as graft

    one, _ = _run(bundle, str(workdir / "one"))
    for name, extra in (("data4", ("--data-shards", "4")),
                        ("data2graph2", ("--data-shards", "2",
                                         "--graph-shards", "2"))):
        t0 = time.perf_counter()
        vcf, stats = _run(bundle, str(workdir / name), extra)
        if vcf.read_bytes() != one.read_bytes():
            raise AssertionError(f"{' '.join(extra)}: VCF differs from the "
                                 "one-card run")
        _say(card, f"four cards: run {' '.join(extra)} in "
                   f"{time.perf_counter() - t0:.2f} s, mesh "
                   f"{stats['counters'].get('mesh', '-')}: genotyped VCF "
                   "byte-equal to one card")
    graft.dryrun_multichip(4)
    _say(card, "four cards: dryrun_multichip(4) passed")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-card path and its check")
    args = parser.parse_args(argv)

    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        # The reference side of phase 3 runs on the CPU device.
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    import jax

    first = jax.devices()[0]
    if first.platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform {first.platform!r}); "
              "this smoke runs on an NVIDIA GPU only", file=sys.stderr)
        return 1
    want = 4 if args.four_cards else 1
    if len(jax.devices()) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(jax.devices())}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from svjedi_tpu.config import AlignConfig
        from svjedi_tpu.io.sim import write_bundle
        from svjedi_tpu.utils.jax_cache import configure_compile_cache
    except ImportError as exc:
        print(f"chip_smoke: the svjedi_tpu package is not beside this "
              f"script ({exc})", file=sys.stderr)
        return 1

    card = _card_line()
    print(card)
    configure_compile_cache()
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        t0 = time.perf_counter()
        bundle = write_bundle(work / "bundle")
        _say(card, f"bundle: 10 Mb, 1000 SVs, 20x: {bundle['n_reads']} "
                   f"reads, {bundle['n_bases']} bases written in "
                   f"{time.perf_counter() - t0:.1f} s")
        build_phase(card)
        if args.four_cards:
            four_card_phase(card, bundle, work)
        else:
            equality_phase(card, bundle, AlignConfig())
            end_to_end_phase(card, bundle, work)
    _say(card, f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": first.platform, "kind": first.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
