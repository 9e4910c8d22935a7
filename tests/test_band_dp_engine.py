"""DP engine selection and the CUDA kernel's contract, checked on the CPU.

The CUDA kernel (kernels/band_dp.cu) runs only on a card
(tests/test_gpu_kernel_equality.py). What surrounds it is checked here: the
engine resolver, the FFI wrapper's argument checks and lowering, the
pipeline's engine plumbing, and — through a numpy model of the kernel's
row step — the encodings it relies on: the packed prefix-max keys for
horizontal gaps, the row-best key, window fetching by metadata, and the
early stop at each problem's window length.
"""

import numpy as np
import pytest

from svjedi_tpu.align import device as dev
from svjedi_tpu.align.extend import NEG, DPParams, band_dp_batch


@pytest.mark.parametrize(
    "platform,engine",
    [("cpu", "xla"), ("gpu", "cuda"), ("tpu", None), ("rocm", None)],
)
def test_resolve_engine(platform, engine):
    if engine is None:
        with pytest.raises(ValueError, match="no banded-DP engine"):
            dev.resolve_engine(platform)
    else:
        assert dev.resolve_engine(platform) == engine


def test_resolve_engine_defaults_to_the_default_device():
    assert dev.resolve_engine() == "xla"  # tests run on the CPU backend


def test_window_score_rejects_unknown_engine():
    z = np.zeros(4096, np.int8)
    with pytest.raises(ValueError, match="unknown DP engine"):
        dev.window_score_packed(
            z, z, np.zeros((5, 8), np.int32), bucket=64, band=32,
            params=DPParams(), engine="v3",
        )


# ---- numpy model of the kernel -------------------------------------------


def kernel_model(reads2, panel, meta, bucket, band, prm=DPParams()):
    """The kernel's algorithm over whole bands (all lanes at once)."""
    P = meta.shape[1]
    out = np.zeros((P, 5), np.int64)
    k = np.arange(band, dtype=np.int64)
    oe, ext = prm.open_extend, prm.gap_extend
    for p in range(P):
        q_start, m, t_start, t_lo, t_hi = (int(v) for v in meta[:, p])
        rows = min(max(m, 0), bucket)

        def tcode(j):
            idx = t_start + j
            ok = (idx >= t_lo) & (idx < t_hi)
            return np.where(ok, panel[np.clip(idx, 0, len(panel) - 1)], 4)

        H = np.zeros(band, np.int64)
        V = np.full(band, NEG, np.int64)
        SH = k.copy()
        SV = k.copy()
        T = tcode(k)
        best, bstart, bqe, bte = 0, 0, -1, -1
        for i in range(rows):
            qi = int(reads2[np.clip(q_start + i, 0, len(reads2) - 1)])
            if i > 0:
                T = np.append(T[1:], tcode(np.array([i + band - 1]))[0])
            h_up = np.append(H[1:], NEG)
            v_up = np.append(V[1:], NEG)
            sh_up = np.append(SH[1:], 0)
            sv_up = np.append(SV[1:], 0)
            vo, ve = h_up + oe, v_up + ext
            V = np.maximum(vo, ve)
            SV = np.where(vo >= ve, sh_up, sv_up)
            sub = np.where((T == qi) & (qi < 4), prm.match, prm.mismatch)
            diag = H + sub
            ht = np.maximum(diag, V)
            st = np.where(diag >= V, SH, SV)
            reset = ht <= 0
            ht = np.where(reset, 0, ht)
            st = np.where(reset, ((i + 1) << 16) | (i + 1 + k), st)
            key = (((ht - ext * k) << 8 | k) << 32) | st
            ex = np.concatenate([[-1], np.maximum.accumulate(key)[:-1]])
            f = (ex >> 40) + oe + ext * (k - 1)
            take = (ex >= 0) & (f > ht)
            H = np.where(take, f, ht)
            SH = np.where(take, ex & 0xFFFFFFFF, st)
            row_key = int(((H << 8) | (255 - k)).max())
            if row_key >> 8 > best:
                kb = 255 - (row_key & 255)
                best, bstart, bqe, bte = row_key >> 8, int(SH[kb]), i, i + kb
        out[p] = (best, bstart >> 16, bstart & 0xFFFF, bqe, bte)
    return out


def _mutated_windows(rng, n, bucket, band):
    panel = rng.integers(0, 4, 20_000).astype(np.int8)
    panel[rng.integers(0, len(panel), 40)] = 4
    reads, meta, off = [], np.zeros((5, n), np.int32), 0
    for p in range(n):
        ln = int(rng.integers(bucket // 2, bucket + 16))
        src = int(rng.integers(band, len(panel) - 2 * ln - band))
        seg = panel[src : src + ln].copy()
        seg = seg[rng.random(ln) >= 0.04]
        flip = rng.random(len(seg)) < 0.08
        seg[flip] = rng.integers(0, 4, int(flip.sum()))
        at = np.flatnonzero(rng.random(len(seg)) < 0.04)
        seg = np.insert(seg, at, rng.integers(0, 4, len(at)).astype(np.int8))
        reads.append(seg)
        meta[:, p] = (
            off, len(seg), src - band // 2 + int(rng.integers(-6, 7)),
            src - int(rng.integers(0, band)),
            src + int(rng.integers(ln // 2, 2 * ln)),
        )
        if p % 4 == 3:  # unrelated target: noise scores, many ties
            meta[2, p] = int(rng.integers(0, len(panel) - 2 * ln))
        off += len(seg)
    meta[1, :3] = (0, 1, bucket + 9)  # empty, one row, over-long window
    reads2 = np.concatenate(reads + [np.full(bucket + band, 4, np.int8)])
    return reads2, panel, meta


@pytest.mark.parametrize("bucket,band,seed", [(96, 32, 0), (160, 64, 1)])
def test_kernel_model_equals_band_dp_batch(bucket, band, seed):
    rng = np.random.default_rng(seed)
    reads2, panel, meta = _mutated_windows(rng, 24, bucket, band)
    ref = np.asarray(dev.window_score_packed(
        reads2, panel, meta, bucket=bucket, band=band, params=DPParams(),
        engine="xla",
    ))
    assert (ref[:, 0] >= 40).sum() >= 10, "windows must hold real alignments"
    np.testing.assert_array_equal(
        kernel_model(reads2, panel, meta, bucket, band), ref
    )


def test_rows_past_window_length_never_improve():
    """The kernel stops each problem at row m; band_dp_batch runs all
    bucket rows. Equal results on every problem support the early stop."""
    rng = np.random.default_rng(5)
    reads2, panel, meta = _mutated_windows(rng, 32, 128, 64)
    meta[1] = np.minimum(meta[1], 100)
    full = np.asarray(dev.window_score_packed(
        reads2, panel, meta, bucket=256, band=64, params=DPParams(),
        engine="xla",
    ))
    cut = np.asarray(dev.window_score_packed(
        reads2, panel, meta, bucket=128, band=64, params=DPParams(),
        engine="xla",
    ))
    np.testing.assert_array_equal(full, cut)


# ---- FFI wrapper -----------------------------------------------------------


@pytest.mark.parametrize(
    "bucket,band,params,match",
    [
        (512, 96, DPParams(), "bands"),
        (65_500, 128, DPParams(), "exceeds"),
        (512, 128, DPParams(gap_extend=1), "gap_extend"),
        (30_720, 128, DPParams(match=400), "23-bit"),
    ],
)
def test_cuda_wrapper_rejects_unsupported_problems(bucket, band, params,
                                                   match):
    from svjedi_tpu.kernels.band_dp_cuda import check_problem

    with pytest.raises(ValueError, match=match):
        check_problem(bucket, band, params)
    check_problem(30_720, 128, DPParams())  # production shape passes


def test_cuda_call_lowers_to_one_custom_call():
    import jax.numpy as jnp

    from svjedi_tpu.kernels import band_dp_cuda

    text = band_dp_cuda._call.lower(
        jnp.zeros(8192, jnp.int8), jnp.zeros(4096, jnp.int8),
        jnp.zeros((5, 256), jnp.int32), bucket=2048, band=128,
        params=DPParams(),
    ).as_text()
    calls = [ln for ln in text.splitlines() if "custom_call" in ln]
    assert len(calls) == 1 and "@svt_band_dp" in calls[0]
    for attr in ("bucket = 2048", "band = 128", "match = 2",
                 "mismatch = -4", "gap_open = -4", "gap_extend = -2"):
        assert attr in calls[0], attr
    assert "tensor<256x5xi32>" in calls[0]


def test_cuda_build_targets_hopper_from_this_source():
    from svjedi_tpu.kernels import band_dp_cuda

    lib = band_dp_cuda.library_path()
    assert lib.parent == band_dp_cuda.BUILD_DIR
    cmd = band_dp_cuda.build_command(lib, "nvcc")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert str(band_dp_cuda.SOURCE) in cmd and str(lib) in cmd


# ---- pipeline plumbing -----------------------------------------------------


def test_align_candidates_engine_override_matches_default():
    import __graft_entry__ as graft
    from svjedi_tpu.align.pipeline import align_candidates
    from svjedi_tpu.align.seed import ChainParams, seed_candidates

    prob = graft._production_problem()
    reads, panel, index, cfg = (
        prob["reads"], prob["panel"], prob["index"], prob["cfg"]
    )
    cands = seed_candidates(reads, index, chain_params=ChainParams())
    default = align_candidates(reads, panel, index, cands, cfg)
    forced = align_candidates(reads, panel, index, cands, cfg, engine="xla")
    assert len(default.read) > 0
    for f in ("read", "path", "score", "qs", "qe", "ts", "te"):
        np.testing.assert_array_equal(getattr(default, f),
                                      getattr(forced, f))
    with pytest.raises(ValueError, match="unknown DP engine"):
        align_candidates(reads, panel, index, cands, cfg, engine="v3")
