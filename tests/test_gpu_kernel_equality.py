"""Compiled GPU banded-DP kernel vs the XLA reference, bit for bit.

The CUDA kernel (kernels/band_dp.cu) has no interpret mode, so these tests
need a card and skip elsewhere. On a GPU host run them with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``: the reference
runs on the CPU device of the same process. All arithmetic is integer, so
equality is exact.
"""

import numpy as np
import pytest

from svjedi_tpu.align.extend import DPParams

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    import jax

    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("no GPU in this process (the CUDA kernel needs a card)")
    return gpus[0]


def _mutate(rng, seg, sub=0.06, ins=0.03, dele=0.03):
    seg = seg[rng.random(len(seg)) >= dele].copy()
    flip = rng.random(len(seg)) < sub
    seg[flip] = rng.integers(0, 4, int(flip.sum()))
    at = np.flatnonzero(rng.random(len(seg)) < ins)
    return np.insert(seg, at, rng.integers(0, 4, len(at)).astype(np.int8))


def _problems(rng, n, bucket, band, panel_len=400_000):
    """Windows over mutated panel copies: real alignments with gaps, N
    bases, clipped path bounds, unrelated targets, empty and over-long
    windows."""
    panel = rng.integers(0, 4, panel_len).astype(np.int8)
    panel[rng.integers(0, panel_len, panel_len // 500)] = 4
    pad = bucket + band + 64
    segs, meta, off = [], np.zeros((5, n), np.int32), 0
    for p in range(n):
        ln = int(rng.integers(bucket // 2, bucket + 64))
        src = int(rng.integers(0, panel_len - 2 * ln))
        seg = _mutate(rng, panel[src : src + ln])
        segs.append(seg)
        meta[0, p] = off
        meta[1, p] = len(seg)
        meta[2, p] = pad + src - band // 2 + int(rng.integers(-8, 9))
        if p % 10 == 9:  # unrelated target: tie-heavy noise scores
            meta[2, p] = pad + int(rng.integers(0, panel_len - 2 * ln))
        meta[3, p] = pad + src - int(rng.integers(0, 2 * band))
        meta[4, p] = pad + src + int(rng.integers(ln // 2, 2 * ln))
        off += len(seg)
    meta[1, :4] = (0, 1, bucket, bucket + 40)
    reads2 = np.concatenate(segs + [np.full(pad, 4, np.int8)])
    panel_padded = np.concatenate(
        [np.full(pad, 4, np.int8), panel, np.full(pad, 4, np.int8)]
    )
    return reads2, panel_padded, meta


@pytest.mark.parametrize("bucket,band", [(512, 128), (2048, 128), (512, 64),
                                         (256, 32), (512, 256)])
def test_cuda_kernel_equals_xla_reference(gpu, bucket, band):
    import jax

    from svjedi_tpu.align import device as dev
    from svjedi_tpu.kernels.band_dp_cuda import band_dp_windows

    rng = np.random.default_rng(bucket + band)
    reads2, panel_padded, meta = _problems(rng, 1024, bucket, band)
    params = DPParams()
    got = np.asarray(band_dp_windows(
        jax.device_put(reads2, gpu), jax.device_put(panel_padded, gpu),
        jax.device_put(meta, gpu), bucket=bucket, band=band, params=params,
    ))
    cpu = jax.devices("cpu")[0]
    ref = np.asarray(dev.window_score_packed(
        jax.device_put(reads2, cpu), jax.device_put(panel_padded, cpu),
        jax.device_put(meta, cpu), bucket=bucket, band=band, params=params,
        engine="xla",
    ))
    assert (ref[:, 0] > 40).mean() > 0.3, "problems must hold real alignments"
    np.testing.assert_array_equal(got, ref)


def test_dist_engine_on_gpu_equals_xla(gpu):
    import __graft_entry__ as graft
    from svjedi_tpu.align.device import resolve_engine
    from svjedi_tpu.dist.engine import dp_filter_count

    prob = graft._production_problem()
    args = (prob["data"].reads2, prob["data"].panel_padded, prob["meta"],
            prob["path_start"], prob["group"], prob["cand_path"],
            prob["owned"])
    kw = dict(bucket=prob["bucket"], band=prob["band"],
              params=prob["params"], n_groups=prob["n_groups"],
              n_tags=prob["n_tags"])
    assert resolve_engine(gpu.platform) == "cuda"
    got = np.asarray(dp_filter_count(*args, engine="cuda", **kw)["counts"])
    ref = np.asarray(dp_filter_count(*args, engine="xla", **kw)["counts"])
    np.testing.assert_array_equal(got, ref)
    assert got.sum() > 0
