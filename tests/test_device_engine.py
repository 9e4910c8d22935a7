"""Device read/panel layout and the XLA window-fetch engine."""

import numpy as np

from svjedi_tpu.align.extend import DPParams, band_dp_batch
from svjedi_tpu.align import device as dev


def _layout(rng, n_reads=6, read_len=300, panel_len=2000, pad=512):
    codes = rng.integers(0, 4, n_reads * read_len).astype(np.int8)
    offsets = np.arange(n_reads + 1, dtype=np.int64) * read_len
    panel = rng.integers(0, 4, panel_len).astype(np.int8)

    class _P:
        pass

    path = _P()
    path.length = panel_len
    path.seq = panel

    class _Panel:
        paths = [path]

    data = dev.upload(codes, _Panel(), max_window=pad)
    return codes, offsets, panel, data


def test_reads2_layout():
    rng = np.random.default_rng(0)
    codes, offsets, _, data = _layout(rng)
    reads2 = np.asarray(data.reads2)
    N = data.n_bases
    assert N >= len(codes) and N % 4 == 0
    assert len(reads2) % 1024 == 0
    np.testing.assert_array_equal(reads2[: len(codes)], codes)
    # Shape-class padding between the real codes and the rc half is A (0).
    assert (reads2[len(codes) : N] == 0).all()
    # rc half: read r reversed-complemented at 2N - o_{r+1}.
    r = 2
    lo, hi = offsets[r], offsets[r + 1]
    rc = codes[lo:hi][::-1].copy()
    rc[rc < 4] = 3 - rc[rc < 4]
    start = 2 * N - hi
    np.testing.assert_array_equal(reads2[N + (N - hi) : N + (N - lo)], rc)
    assert (reads2[2 * N :] == 4).all()


def _window_problems(rng, data, panel, n_real, bucket=128, band=128, P=8):
    # Sample windows from real read content (beyond n_real is A padding,
    # where alignments against a random panel tie massively).
    q_start = rng.integers(0, n_real - bucket, P).astype(np.int32)
    m = rng.integers(64, bucket + 1, P).astype(np.int32)
    t_start = (data.panel_start[0] + rng.integers(0, len(panel) - bucket - band, P)).astype(np.int32)
    t_lo = np.full(P, data.panel_start[0], np.int32)
    t_hi = np.full(P, data.panel_start[0] + len(panel), np.int32)
    return q_start, m, t_start, t_lo, t_hi


def test_gather_engine_matches_manual_windows():
    rng = np.random.default_rng(1)
    codes, offsets, panel, data = _layout(rng)
    bucket = band = 128
    q_start, m, t_start, t_lo, t_hi = _window_problems(rng, data, panel, len(codes))
    out = dev.window_score(
        data.reads2, data.panel_padded, q_start, m, t_start, t_lo, t_hi,
        bucket=bucket, band=band, params=DPParams(),
    )
    # Manual window construction + reference DP.
    reads2 = np.asarray(data.reads2)
    panel_padded = np.asarray(data.panel_padded)
    P = len(q_start)
    q = np.full((P, bucket), 4, np.int8)
    t = np.full((P, bucket + band), 4, np.int8)
    for p in range(P):
        win = reads2[q_start[p] : q_start[p] + bucket].copy()
        win[m[p] :] = 4
        q[p] = win
        tw = panel_padded[t_start[p] : t_start[p] + bucket + band].copy()
        pos = t_start[p] + np.arange(bucket + band)
        tw[(pos < t_lo[p]) | (pos >= t_hi[p])] = 4
        t[p] = tw
    ref = band_dp_batch(q, t, band, DPParams())
    for key in ("score", "qs", "ts", "qe", "te"):
        np.testing.assert_array_equal(
            np.asarray(out[key]), np.asarray(ref[key]), err_msg=key
        )
