"""Banded affine-gap local alignment, batched (the extend stage).

The workhorse: score a batch of fixed-shape (read-window × target-window)
problems along a diagonal band:

- row iteration over the read axis with the whole band as a vector lane
  dimension — all dependencies resolve to the previous row except
  horizontal gap runs, which are closed exactly with a log-shift weighted
  prefix-max scan (no serial inner loop);
- the band is pre-positioned by seeding: target row window ``T[:, i:i+B]``
  holds the cells of diagonal offset ``d0 ± B/2`` (the caller slices the
  panel path with that offset), so the kernel indexes statically.

Two implementations with one contract:
- :func:`band_dp_batch` — jnp ``lax.scan``: the correctness reference and
  the CPU engine;
- kernels/band_dp.cu — the CUDA kernel, the GPU engine (bit-identical
  results, ties included).

A tiny O(mn) full-matrix Smith-Waterman (:func:`smith_waterman_full`) exists
for kernel unit tests only.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

import jax
import jax.numpy as jnp

NEG = -(1 << 30)


@dataclass(frozen=True)
class DPParams:
    match: int = 2
    mismatch: int = -4
    gap_open: int = -4  # charged on the first gap base together with extend
    gap_extend: int = -2

    @property
    def open_extend(self) -> int:
        return self.gap_open + self.gap_extend


def _shift_left(a, fill=NEG):
    """a[..., k] <- a[..., k+1] (pad last lane)."""
    return jnp.concatenate(
        [a[..., 1:], jnp.full(a.shape[:-1] + (1,), fill, a.dtype)], axis=-1
    )


def _shift_right(a, s, fill=NEG):
    if s == 0:
        return a
    return jnp.concatenate(
        [jnp.full(a.shape[:-1] + (s,), fill, a.dtype), a[..., :-s]], axis=-1
    )


@functools.partial(jax.jit, static_argnames=("band", "params"))
def band_dp_batch(
    q: jnp.ndarray,  # (P, M) int8 read windows, padded with 4 (N)
    t: jnp.ndarray,  # (P, M + band) int8 target windows, padded with 4
    band: int,
    params: DPParams = DPParams(),
) -> Dict[str, jnp.ndarray]:
    """Batched banded local alignment.

    Cell (i, k) of the band corresponds to read position i and target-window
    position j = i + k (the caller centers the band by slicing the target
    starting at d0 - band//2). Returns per-problem best score and the
    inclusive window coordinates of the alignment span:
    ``qs/qe`` (read) and ``ts/te`` (target window).
    """
    P, M = q.shape
    B = band
    oe = params.open_extend
    ext = params.gap_extend

    q32 = q.astype(jnp.int32)
    t32 = t.astype(jnp.int32)

    def row(state, i):
        (H, V, sqh, sth, sqv, stv, best, bqs, bts, bqe, bte) = state
        trow = jax.lax.dynamic_slice_in_dim(t32, i, B, axis=1)  # (P,B)
        qi = jax.lax.dynamic_slice_in_dim(q32, i, 1, axis=1)  # (P,1)
        sub = jnp.where(
            (qi == trow) & (qi < 4), params.match, params.mismatch
        )

        # Vertical gap (consumes read base, j fixed): parents at k+1.
        H_up = _shift_left(H)
        V_up = _shift_left(V)
        sqh_up = _shift_left(sqh, 0)
        sth_up = _shift_left(sth, 0)
        sqv_up = _shift_left(sqv, 0)
        stv_up = _shift_left(stv, 0)
        v_open = H_up + oe
        v_ext = V_up + ext
        V_new = jnp.maximum(v_open, v_ext)
        take_open = v_open >= v_ext
        sqv_new = jnp.where(take_open, sqh_up, sqv_up)
        stv_new = jnp.where(take_open, sth_up, stv_up)

        # Diagonal + vertical + reset-to-zero.
        diag = H + sub
        htmp = jnp.maximum(diag, V_new)
        take_diag = diag >= V_new
        sq_t = jnp.where(take_diag, sqh, sqv_new)
        st_t = jnp.where(take_diag, sth, stv_new)
        # Local alignment floor: an empty cell seeds a new alignment whose
        # first aligned cell is this cell's diagonal successor (i+1, k).
        k_idx = jax.lax.broadcasted_iota(jnp.int32, (P, B), 1)
        reset = htmp <= 0
        htmp = jnp.maximum(htmp, 0)
        sq_t = jnp.where(reset, i + 1, sq_t)
        st_t = jnp.where(reset, i + 1 + k_idx, st_t)

        # Horizontal gap runs: weighted prefix max via doubling shifts.
        F = _shift_right(htmp, 1) + oe
        fq = _shift_right(sq_t, 1, 0)
        ft = _shift_right(st_t, 1, 0)
        s = 1
        while s < B:
            cand = _shift_right(F, s) + ext * s
            cq = _shift_right(fq, s, 0)
            ct = _shift_right(ft, s, 0)
            take = cand > F
            F = jnp.where(take, cand, F)
            fq = jnp.where(take, cq, fq)
            ft = jnp.where(take, ct, ft)
            s <<= 1

        take_f = F > htmp
        H_new = jnp.where(take_f, F, htmp)
        sqh_new = jnp.where(take_f, fq, sq_t)
        sth_new = jnp.where(take_f, ft, st_t)

        # Track the global best end per problem.
        row_best = jnp.max(H_new, axis=1)
        row_arg = jnp.argmax(H_new, axis=1).astype(jnp.int32)
        improved = row_best > best
        gather = lambda a: jnp.take_along_axis(a, row_arg[:, None], axis=1)[:, 0]
        best = jnp.where(improved, row_best, best)
        bqs = jnp.where(improved, gather(sqh_new), bqs)
        bts = jnp.where(improved, gather(sth_new), bts)
        bqe = jnp.where(improved, i, bqe)
        bte = jnp.where(improved, i + row_arg, bte)

        return (
            (H_new, V_new, sqh_new, sth_new, sqv_new, stv_new,
             best, bqs, bts, bqe, bte),
            None,
        )

    zeros_i32 = jnp.zeros((P, B), jnp.int32)
    k_idx0 = jax.lax.broadcasted_iota(jnp.int32, (P, B), 1)
    init = (
        zeros_i32,  # H: row "-1" is all empty
        jnp.full((P, B), NEG, jnp.int32),  # V
        jnp.zeros((P, B), jnp.int32),  # sqh (first aligned cell row 0)
        k_idx0,  # sth
        jnp.zeros((P, B), jnp.int32),
        k_idx0,
        jnp.zeros((P,), jnp.int32),  # best score 0
        jnp.zeros((P,), jnp.int32),
        jnp.zeros((P,), jnp.int32),
        jnp.full((P,), -1, jnp.int32),
        jnp.full((P,), -1, jnp.int32),
    )
    (H, V, sqh, sth, sqv, stv, best, bqs, bts, bqe, bte), _ = jax.lax.scan(
        row, init, jnp.arange(M)
    )
    return {
        "score": best,
        "qs": bqs,
        "ts": bts,
        "qe": bqe,
        "te": bte,
    }


@functools.partial(jax.jit, static_argnames=("band", "params"))
def band_dp_stats_batch(
    q: jnp.ndarray,  # (P, M) int8 read windows, padded with 4 (N)
    t: jnp.ndarray,  # (P, M + band) int8 target windows, padded with 4
    band: int,
    params: DPParams = DPParams(),
) -> Dict[str, jnp.ndarray]:
    """Banded local alignment tracking exact-match statistics.

    Same band semantics as :func:`band_dp_batch`, but instead of start
    coordinates it carries, per cell, the number of exact base matches
    (``matches``) and of diagonal steps (``n_diag``) along the optimal path
    ending there. From the returned end coordinates these give the
    GAF-faithful columns (filter-alignments.py:193-196 consumes col 10
    matches, col 11 block length, and the ``id:f:`` identity):

        block_len = qspan + tspan - n_diag   (M + X + I + D)
        identity  = matches / block_len

    Used by the audit pass on winning alignments only (re-scoring a clamped
    window is cheap next to the candidate sweep); among equal-scoring
    optimal paths the reported statistics are those of the path the DP tie-
    breaking selects.
    """
    P, M = q.shape
    B = band
    oe = params.open_extend
    ext = params.gap_extend

    q32 = q.astype(jnp.int32)
    t32 = t.astype(jnp.int32)

    def row(state, i):
        (H, V, mh, dh, mv, dv, best, bm, bd, bqe, bte) = state
        trow = jax.lax.dynamic_slice_in_dim(t32, i, B, axis=1)
        qi = jax.lax.dynamic_slice_in_dim(q32, i, 1, axis=1)
        is_match = (qi == trow) & (qi < 4)
        sub = jnp.where(is_match, params.match, params.mismatch)

        # Vertical gap: parents at k+1; gap bases add no match/diag step.
        H_up = _shift_left(H)
        V_up = _shift_left(V)
        mh_up = _shift_left(mh, 0)
        dh_up = _shift_left(dh, 0)
        mv_up = _shift_left(mv, 0)
        dv_up = _shift_left(dv, 0)
        v_open = H_up + oe
        v_ext = V_up + ext
        V_new = jnp.maximum(v_open, v_ext)
        take_open = v_open >= v_ext
        mv_new = jnp.where(take_open, mh_up, mv_up)
        dv_new = jnp.where(take_open, dh_up, dv_up)

        diag = H + sub
        htmp = jnp.maximum(diag, V_new)
        take_diag = diag >= V_new
        m_t = jnp.where(take_diag, mh + is_match, mv_new)
        d_t = jnp.where(take_diag, dh + 1, dv_new)
        reset = htmp <= 0
        htmp = jnp.maximum(htmp, 0)
        m_t = jnp.where(reset, 0, m_t)
        d_t = jnp.where(reset, 0, d_t)

        # Horizontal gap runs (weighted prefix max; stats ride the shifts).
        F = _shift_right(htmp, 1) + oe
        fm = _shift_right(m_t, 1, 0)
        fd = _shift_right(d_t, 1, 0)
        s = 1
        while s < B:
            cand = _shift_right(F, s) + ext * s
            cm = _shift_right(fm, s, 0)
            cd = _shift_right(fd, s, 0)
            take = cand > F
            F = jnp.where(take, cand, F)
            fm = jnp.where(take, cm, fm)
            fd = jnp.where(take, cd, fd)
            s <<= 1

        take_f = F > htmp
        H_new = jnp.where(take_f, F, htmp)
        mh_new = jnp.where(take_f, fm, m_t)
        dh_new = jnp.where(take_f, fd, d_t)

        row_best = jnp.max(H_new, axis=1)
        row_arg = jnp.argmax(H_new, axis=1).astype(jnp.int32)
        improved = row_best > best
        gather = lambda a: jnp.take_along_axis(a, row_arg[:, None], axis=1)[:, 0]
        best = jnp.where(improved, row_best, best)
        bm = jnp.where(improved, gather(mh_new), bm)
        bd = jnp.where(improved, gather(dh_new), bd)
        bqe = jnp.where(improved, i, bqe)
        bte = jnp.where(improved, i + row_arg, bte)

        return (
            (H_new, V_new, mh_new, dh_new, mv_new, dv_new,
             best, bm, bd, bqe, bte),
            None,
        )

    zeros = jnp.zeros((P, B), jnp.int32)
    init = (
        zeros,
        jnp.full((P, B), NEG, jnp.int32),
        zeros, zeros, zeros, zeros,
        jnp.zeros((P,), jnp.int32),
        jnp.zeros((P,), jnp.int32),
        jnp.zeros((P,), jnp.int32),
        jnp.full((P,), -1, jnp.int32),
        jnp.full((P,), -1, jnp.int32),
    )
    (H, V, mh, dh, mv, dv, best, bm, bd, bqe, bte), _ = jax.lax.scan(
        row, init, jnp.arange(M)
    )
    return {
        "score": best,
        "matches": bm,
        "n_diag": bd,
        "qe": bqe,
        "te": bte,
    }


def smith_waterman_full(
    q: np.ndarray, t: np.ndarray, params: DPParams = DPParams()
) -> Tuple[int, int, int, int, int]:
    """Exact O(mn) local affine alignment (tests only).

    Returns (score, qs, ts, qe, te), end coordinates inclusive.
    """
    m, n = len(q), len(t)
    oe, ext = params.open_extend, params.gap_extend
    H = np.zeros((n + 1,), dtype=np.int64)
    E = np.full((n + 1,), NEG, dtype=np.int64)  # horizontal (gap in t)
    F = np.full((n + 1,), NEG, dtype=np.int64)  # vertical
    SH = [(0, j) for j in range(n + 1)]  # start of alignment ending here
    SE = [(0, 0)] * (n + 1)
    SF = [(0, 0)] * (n + 1)
    best = (0, 0, 0, -1, -1)
    for i in range(m):
        H_prev = H.copy()
        SH_prev = list(SH)
        H[0] = 0
        SH[0] = (i + 1, 0)
        for j in range(1, n + 1):
            sub = (
                params.match
                if (q[i] == t[j - 1] and q[i] < 4)
                else params.mismatch
            )
            e_open, e_ext = H[j - 1] + oe, E[j - 1] + ext
            E[j] = max(e_open, e_ext)
            SE[j] = SH[j - 1] if e_open >= e_ext else SE[j - 1]
            f_open, f_ext = H_prev[j] + oe, F[j] + ext
            new_F = max(f_open, f_ext)
            SF[j] = SH_prev[j] if f_open >= f_ext else SF[j]
            F[j] = new_F
            diag = H_prev[j - 1] + sub
            h = max(0, diag, E[j], new_F)
            if h == 0:
                SH[j] = (i + 1, j)  # next diagonal consumer starts there
            elif h == diag:
                SH[j] = SH_prev[j - 1]
            elif h == new_F:
                SH[j] = SF[j]
            else:
                SH[j] = SE[j]
            H[j] = h
            if h > best[0]:
                best = (int(h), SH[j][0], SH[j][1], i, j - 1)
    return best
