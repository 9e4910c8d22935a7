"""Cross-checks between the host count path and the on-mesh count step.

VERDICT r1 required the two counting implementations to be proven
equivalent on identical candidates: the host path (align/pipeline.py
``align_candidates`` + ``count_support``) and the device path
(dist/engine.py ``dp_filter_count``). The construction (short
single-block chains from the production seeding stages) makes the on-device
winner-per-group rule coincide with the host chain reduction.
"""

import numpy as np
import pytest

import __graft_entry__ as graft


@pytest.fixture(scope="module")
def prob():
    return graft._production_problem()


def test_dp_filter_count_v3_matches_count_support(prob):
    from svjedi_tpu.align.pipeline import align_candidates, count_support
    from svjedi_tpu.align.seed import ChainParams, seed_candidates
    from svjedi_tpu.config import GenotypeConfig
    from svjedi_tpu.dist.engine import dp_filter_count

    dev_counts = np.asarray(
        dp_filter_count(
            *graft._count_args(prob),
            bucket=prob["bucket"], band=prob["band"], params=prob["params"],
            n_groups=prob["n_groups"], n_tags=prob["n_tags"], engine="xla",
        )["counts"]
    )

    reads, panel, index, cfg = (
        prob["reads"], prob["panel"], prob["index"], prob["cfg"]
    )
    cands = seed_candidates(reads, index, chain_params=ChainParams())
    winners = align_candidates(reads, panel, index, cands, cfg)
    host_counts, _ = count_support(
        panel, winners, reads, GenotypeConfig().d_over, collect_audit=False
    )

    host_dense = np.zeros_like(dev_counts)
    for tag, (r, a) in host_counts.items():
        ti = prob["tags"].index(tag)
        host_dense[ti, 0] = r
        host_dense[ti, 1] = a
    assert dev_counts.sum() > 0
    np.testing.assert_array_equal(dev_counts, host_dense)


def test_sharded_count_step_v3_matches_single_device(prob):
    """The psum-merged sharded step equals the single-device step (the
    dry-run asserts the same on the driver's virtual mesh; this keeps it
    in CI on the 8-device conftest mesh, with the XLA engine)."""
    import jax

    from svjedi_tpu.dist.engine import (
        dp_filter_count, make_sharded_count_step,
    )
    from svjedi_tpu.dist.mesh import make_mesh

    n = min(4, len(jax.devices()))
    mesh = make_mesh(
        data_shards=n // 2 or 1, graph_shards=2 if n >= 2 else 1,
        devices=jax.devices()[:n],
    )
    p = graft._production_problem(pad_to=128 * mesh.shape["data"])
    step = make_sharded_count_step(
        mesh, bucket=p["bucket"], band=p["band"], params=p["params"],
        n_groups_per_shard=p["n_groups"], n_tags=p["n_tags"], engine="xla",
    )
    counts = np.asarray(step(*graft._count_args(p)))
    ref = np.asarray(
        dp_filter_count(
            *graft._count_args(p),
            bucket=p["bucket"], band=p["band"], params=p["params"],
            n_groups=p["n_groups"], n_tags=p["n_tags"], engine="xla",
        )["counts"]
    )
    np.testing.assert_array_equal(counts, ref)
