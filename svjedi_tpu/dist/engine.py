"""Sharded count step running the production DP engine.

One jitted SPMD program takes the production device layout (the read and
panel buffers + the (5, P) window metadata of ``align/device.py``), runs
the platform's DP engine (``align.device.resolve_engine``: the CUDA kernel
on a GPU, the XLA reference on the CPU) for (score, qs, ts, qe, te),
applies the winner + junction-coverage + density rules, and psums the
per-(tag, allele) count matrix over a (data, graph) mesh.

Sharding layout (SURVEY §2.2/§5.8):
- candidate problems sharded over ``data`` (each card DPs its slice);
- sequence buffers + owned-link table replicated;
- the tag (SV) space range-partitioned over ``graph``;
- ONE ``psum`` of the (n_tags, 2) int32 matrix is the only collective.

Reference semantics being distributed: the only cross-read reduction in the
whole reference pipeline is the per-(SV, allele) alignment count
(filter-alignments.py:163-166 accumulation, predict-genotype.py:219-227
``len()``), an associative integer sum.
"""

from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..align.device import OUT_COLS, window_score_packed
from ..align.extend import DPParams
from .count_step import OwnedTable


@functools.partial(
    jax.jit,
    static_argnames=(
        "bucket", "band", "params", "n_groups", "n_tags", "d_over",
        "min_score", "min_density_millis", "engine", "tag_lo", "tag_hi",
    ),
)
def dp_filter_count(
    reads2: jnp.ndarray,  # device.upload read layout
    panel_padded: jnp.ndarray,
    meta: jnp.ndarray,  # (5, P) int32 rows per device.META_ROWS
    path_start: jnp.ndarray,  # (P,) int32 panel_start[cand_path]
    group: jnp.ndarray,  # (P,) int32 winner-competition group id
    cand_path: jnp.ndarray,  # (P,) int32 panel path id
    owned: OwnedTable,
    *,
    bucket: int,
    band: int,
    params: DPParams,
    n_groups: int,
    n_tags: int,
    engine: str,  # align.device.resolve_engine()
    d_over: int = 100,
    min_score: int = 40,
    min_density_millis: int = 500,
    tag_lo: int = 0,
    tag_hi: int = 1 << 30,
) -> Dict[str, jnp.ndarray]:
    """Production-engine DP → winner → junction counts, fully on device."""
    res = window_score_packed(
        reads2, panel_padded, meta, bucket=bucket, band=band, params=params,
        engine=engine,
    )
    score, qs, ts, qe, te = (res[:, i] for i in range(len(OUT_COLS)))
    # Window coords → path coords (meta row 2 is absolute into the padded
    # panel buffer; lane 0 of the target window sits at that offset).
    toff = meta[2] - path_start
    ts = ts + toff
    te = te + toff

    # Winner per group under the production count rules: score floor +
    # score-density floor (align/pipeline.py prune_secondaries).
    span = jnp.maximum(qe - qs + 1, te - ts + 1)
    dense = score * 1000 >= min_density_millis * span
    qual = (score >= min_score) & dense
    eff = jnp.where(qual, score, -1)
    best = jax.ops.segment_max(eff, group, num_segments=n_groups)
    n = meta.shape[1]
    idx = jnp.arange(n, dtype=jnp.int32)
    big = jnp.int32(1 << 30)
    tied = (eff == best[group]) & qual
    first = jax.ops.segment_min(
        jnp.where(tied, idx, big), group, num_segments=n_groups
    )
    is_winner = tied & (idx == first[group])

    # Junction coverage for every owned link of the winner's path
    # (filter-alignments.py:258-273 in path coordinates), masked to this
    # graph shard's tag range.
    oj = owned.junction[cand_path]
    otag = owned.tag[cand_path]
    oall = owned.allele[cand_path]
    ovalid = owned.valid[cand_path]
    covers = (
        ovalid
        & is_winner[:, None]
        & ((oj - ts[:, None]) >= d_over)
        & ((te[:, None] - oj + 1) >= d_over)
        & (otag >= tag_lo)
        & (otag < tag_hi)
    )
    flat = (otag * 2 + oall).reshape(-1)
    contrib = covers.astype(jnp.int32).reshape(-1)
    counts = jax.ops.segment_sum(contrib, flat, num_segments=2 * n_tags)
    return {
        "counts": counts.reshape(n_tags, 2),
        "score": score,
        "qs": qs,
        "ts": ts,
        "qe": qe,
        "te": te,
        "is_winner": is_winner,
    }


def make_sharded_count_step(
    mesh: Mesh,
    *,
    bucket: int,
    band: int,
    params: DPParams,
    n_groups_per_shard: int,
    n_tags: int,
    engine: str,
    d_over: int = 100,
    min_score: int = 40,
    min_density_millis: int = 500,
):
    """Jitted multi-card count step over a (data, graph) mesh.

    Candidate arrays shard over ``data`` (meta on its problem axis);
    sequence buffers and the owned table replicate; each graph shard counts its
    disjoint tag range; one psum over the whole mesh returns the exact
    global (n_tags, 2) matrix replicated. Group ids are shard-local
    (callers give each data shard its own candidate groups).
    """
    n_graph = mesh.shape["graph"]
    tags_per_shard = -(-n_tags // n_graph)

    def step(reads2, panel_padded, meta, path_start, group, cand_path,
             owned):
        gidx = jax.lax.axis_index("graph")
        lo = (gidx * tags_per_shard).astype(jnp.int32)
        hi = jnp.minimum(lo + tags_per_shard, n_tags).astype(jnp.int32)
        out = dp_filter_count(
            reads2, panel_padded, meta, path_start, group, cand_path, owned,
            bucket=bucket, band=band, params=params,
            n_groups=n_groups_per_shard, n_tags=n_tags, d_over=d_over,
            min_score=min_score, min_density_millis=min_density_millis,
            engine=engine,
            # tag range masking must stay traced per shard: re-apply here.
            tag_lo=0, tag_hi=1 << 30,
        )
        gmask = (jnp.arange(n_tags, dtype=jnp.int32) >= lo) & (
            jnp.arange(n_tags, dtype=jnp.int32) < hi
        )
        counts = jnp.where(gmask[:, None], out["counts"], 0)
        return jax.lax.psum(counts, axis_name=("data", "graph"))

    spec_d = P("data")
    return jax.jit(
        jax.shard_map(
            step,
            mesh=mesh,
            in_specs=(
                P(), P(),  # sequence buffers replicated
                P(None, "data"),  # meta problems sharded
                spec_d, spec_d, spec_d,
                P(),  # owned table replicated
            ),
            out_specs=P(),
            check_vma=False,
        )
    )


def assert_no_group_straddle(
    group: np.ndarray, meta: np.ndarray, data_shards: int
) -> None:
    """Check that no winner-competition group straddles a data-shard cut.

    ``make_sharded_count_step`` elects one winner PER SHARD per group id;
    a (read, cluster) group split across the equal data split would be
    counted once per shard it touches. Padding rows (meta window length 0)
    are ignored — they can never win. Raises AssertionError on a straddle.
    """
    P = len(group)
    if data_shards <= 1 or P == 0:
        return
    assert P % data_shards == 0, (P, data_shards)
    shard_len = P // data_shards
    m = np.asarray(meta)[1]
    real = m > 0
    g = np.asarray(group)
    for b in range(shard_len, P, shard_len):
        left = g[:b][real[:b]]
        right = g[b:][real[b:]]
        common = np.intersect1d(left, right)
        assert common.size == 0, (
            f"groups {common[:8].tolist()} straddle the shard cut at {b}"
        )
