"""Device-resident alignment engine: window fetch + banded DP on the device.

The flat read codes (forward ++ whole-array reverse complement) and the
sentinel-padded flat panel sequence are uploaded once per read chunk; each
DP batch is described by a (5, P) int32 metadata matrix (``META_ROWS``) and
its windows are fetched on the device, so host<->device traffic per batch
is kilobytes. Two engines share that contract (:func:`resolve_engine` picks
one per platform): the XLA reference (gather + ``band_dp_batch``) and the
CUDA kernel (kernels/band_dp.cu), which reads the buffers directly.

Layout invariants (shared by both engines):
- ``reads2`` = fwd codes ++ revcomp codes ++ sentinel bases; reverse-strand
  windows are addressed inside the rc half with positive stride (rc of read
  r with offsets [o_r, o_r+1) starts at 2N - o_{r+1}). N is the forward-half
  length *after* padding the codes up to a power-of-two class (so chunk-size
  jitter does not mint new compiled shapes); the A-padding tail is masked by
  the per-problem window length ``m``.
- ``panel_padded`` = pad ++ panel ++ pad with pad >= max_window + 4*ALIGN,
  so every window fetch stays in range; per-path validity is enforced from
  absolute [t_lo, t_hi) bounds.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from .extend import DPParams, band_dp_batch


@dataclass
class DeviceData:
    reads2: jnp.ndarray  # int8 (2N + pad,)
    panel_padded: jnp.ndarray  # int8 (pad + total + pad,)
    panel_start: np.ndarray  # int64 per-path start into panel_padded (host)
    panel_len: np.ndarray  # int64 per-path length (host)
    n_bases: int  # N (forward half length)
    pad: int
    #: Read-boundary offsets on device ((R+1,) int32) + true code count —
    #: set when upload() was given ``offsets`` (they ride the codes
    #: transfer). Consumed by the on-device minimizer scan
    #: (align/dev_scan.py).
    offsets32: jnp.ndarray = None
    n_codes: int = 0


@functools.partial(jax.jit, static_argnames=("n_cap", "pad"))
def _expand_reads_raw(codes: jnp.ndarray, n_cap: int, pad: int):
    """fwd ++ revcomp ++ sentinel layout from raw (unpadded) codes.

    Shape-class padding happens ON DEVICE: host-side packing/padding of a
    ~100 MB chunk costs seconds of numpy, while the raw int8 transfer plus
    this trivially-fused expansion is tens of ms. The raw-length retrace is
    XLA-only (cheap); everything downstream sees only the n_cap class.
    """
    n = codes.shape[0]
    codes = jnp.concatenate(
        [codes, jnp.zeros((n_cap - n,), jnp.int8)]
    )
    flipped = jnp.flip(codes)
    rc = jnp.where(flipped < 4, 3 - flipped, flipped).astype(jnp.int8)
    sentinel = jnp.full((pad,), 4, jnp.int8)
    return jnp.concatenate([codes, rc, sentinel])


@functools.partial(jax.jit, static_argnames=("n_codes", "n_cap", "pad"))
def _expand_reads_payload(payload: jnp.ndarray, n_codes: int, n_cap: int,
                          pad: int):
    """fwd ++ revcomp ++ sentinel layout from a codes+offsets payload.

    ``payload`` = raw int8 codes (n_codes) followed by the read-offset
    table's little-endian int32 bytes; the offsets ride the same transfer
    (see :func:`upload`) and are unpacked by :func:`_payload_offsets`.
    """
    codes = payload[:n_codes]
    codes = jnp.concatenate([codes, jnp.zeros((n_cap - n_codes,), jnp.int8)])
    flipped = jnp.flip(codes)
    rc = jnp.where(flipped < 4, 3 - flipped, flipped).astype(jnp.int8)
    sentinel = jnp.full((pad,), 4, jnp.int8)
    return jnp.concatenate([codes, rc, sentinel])


@functools.partial(jax.jit, static_argnames=("n_codes", "n_off"))
def _payload_offsets(payload: jnp.ndarray, n_codes: int, n_off: int):
    """Bitcast the payload's offset-table tail back to (n_off,) int32."""
    raw = payload[n_codes : n_codes + 4 * n_off]
    return jax.lax.bitcast_convert_type(raw.reshape(n_off, 4), jnp.int32)


#: Granule of both buffers' lengths and part of the sentinel padding: the
#: pad of max_window + 4*ALIGN sentinels keeps every window fetch in range.
ALIGN = 1024


def upload(
    reads_codes: np.ndarray,
    panel,
    panel_cache: dict = None,
    max_window: int = 30976,
    device=None,
    offsets: np.ndarray = None,
) -> DeviceData:
    """Upload a read chunk + panel to the device (panel cached across chunks).

    The raw int8 codes go over in one transfer; the device pads them to the
    shape class and builds the fwd++rc layout. ``device`` pins the buffers
    to one card of a multi-device host (the data-parallel chunk round-robin,
    align/pipeline.py); callers then keep one ``panel_cache`` per device.
    None = the default device.
    """
    import jax

    put = (lambda x: jax.device_put(x, device)) if device is not None else (
        jnp.asarray
    )
    pad = max_window + 4 * ALIGN
    if panel_cache is not None and "flat" in panel_cache:
        panel_padded = panel_cache["flat"]
        starts = panel_cache["starts"]
        lens = panel_cache["lens"]
    else:
        lens = np.array([p.length for p in panel.paths], dtype=np.int64)
        starts = np.zeros(len(lens), dtype=np.int64)
        if len(lens):
            np.cumsum(lens[:-1], out=starts[1:])
        starts += pad
        total = pad + int(lens.sum()) + pad
        total += (-total) % ALIGN
        flat = np.full(total, 4, dtype=np.int8)
        pos = pad
        for p in panel.paths:
            flat[pos : pos + p.length] = p.seq
            pos += p.length
        panel_padded = put(flat)
        if panel_cache is not None:
            panel_cache["flat"] = panel_padded
            panel_cache["starts"] = starts
            panel_cache["lens"] = lens

    n = len(reads_codes)
    # Every distinct reads2 length re-lowers each jit that takes it, so the
    # forward half is padded to a power of two above a floor: the class
    # count stays logarithmic in chunk size at <= 2x buffer waste.
    n_cap = 1 << max(12, (max(n, 1) - 1).bit_length())
    # Sentinel tail sized so the total is ALIGN-aligned (2*n_cap + pad_tot).
    pad_tot = pad + (-(2 * n_cap + pad)) % ALIGN
    offsets32 = None
    if offsets is not None:
        # The read-boundary table rides the codes transfer: payload = codes
        # ++ int32-LE offset bytes, split back apart on device.
        off32 = np.ascontiguousarray(offsets, dtype="<i4")
        payload = put(
            np.concatenate([reads_codes, off32.view(np.int8)])
        )
        reads2 = _expand_reads_payload(
            payload, n_codes=n, n_cap=n_cap, pad=pad_tot
        )
        offsets32 = _payload_offsets(payload, n_codes=n, n_off=len(off32))
    else:
        reads2 = _expand_reads_raw(
            put(reads_codes), n_cap=n_cap, pad=pad_tot
        )
    return DeviceData(
        reads2=reads2,
        panel_padded=panel_padded,
        panel_start=starts,
        panel_len=lens,
        n_bases=n_cap,
        pad=pad,
        offsets32=offsets32,
        n_codes=n,
    )


def device_of(data: DeviceData):
    """The device a production upload is pinned to (None when uncommitted)."""
    return getattr(data.reads2, "device", None)


#: DP engine per JAX platform: the XLA reference on the CPU, the CUDA
#: kernel (kernels/band_dp.cu) on NVIDIA GPUs.
ENGINES = {"cpu": "xla", "gpu": "cuda"}


def resolve_engine(platform: str = None) -> str:
    """The DP engine for ``platform`` (default: the default device's).

    Raises for a platform with no engine: nothing falls back to another
    platform or to an interpreter.
    """
    if platform is None:
        platform = jax.devices()[0].platform
    try:
        return ENGINES[platform]
    except KeyError:
        raise ValueError(
            f"no banded-DP engine for platform {platform!r} "
            f"(supported: {', '.join(sorted(ENGINES))})"
        ) from None


#: Row order of the packed metadata matrix consumed by
#: :func:`window_score_packed`.
META_ROWS = ("q_start", "m", "t_start", "t_lo", "t_hi")
#: Column order of its packed (P, 5) int32 result.
OUT_COLS = ("score", "qs", "ts", "qe", "te")


@functools.partial(
    jax.jit, static_argnames=("bucket", "band", "params", "engine")
)
def window_score_packed(
    reads2: jnp.ndarray,
    panel_padded: jnp.ndarray,
    meta: jnp.ndarray,  # (5, P) int32, rows per META_ROWS
    bucket: int,
    band: int,
    params: DPParams,
    engine: str,
) -> jnp.ndarray:
    """Banded DP over the windows ``meta`` describes: (P, 5) int32 result.

    One int32 matrix in, one (P, 5) matrix out (columns per OUT_COLS) that
    the caller keeps on device and fetches in bulk with other batches.
    """
    if engine == "cuda":
        from ..kernels.band_dp_cuda import band_dp_windows

        return band_dp_windows(
            reads2, panel_padded, meta, bucket=bucket, band=band,
            params=params,
        )
    if engine != "xla":
        raise ValueError(f"unknown DP engine {engine!r}")
    q_start, m, t_start, t_lo, t_hi = (meta[i] for i in range(5))
    res = window_score(
        reads2, panel_padded, q_start, m, t_start, t_lo, t_hi,
        bucket=bucket, band=band, params=params,
    )
    return jnp.stack([res[c] for c in OUT_COLS], axis=1)


@functools.partial(jax.jit, static_argnames=("bucket", "band", "params"))
def window_score(
    reads2: jnp.ndarray,
    panel_padded: jnp.ndarray,
    q_start: jnp.ndarray,  # (P,) int32 window start in reads2
    m: jnp.ndarray,  # (P,) int32 read-window length
    t_start: jnp.ndarray,  # (P,) int32 target window lane-0 in panel_padded
    t_lo: jnp.ndarray,  # (P,) int32 first valid index of the path
    t_hi: jnp.ndarray,  # (P,) int32 one-past-last valid index
    bucket: int,
    band: int,
    params: DPParams,
) -> Dict[str, jnp.ndarray]:
    """Gather fixed-shape windows on device and run ``band_dp_batch``."""
    cols = jnp.arange(bucket, dtype=jnp.int32)
    qidx = q_start[:, None] + cols[None, :]
    qv = jnp.take(reads2, jnp.clip(qidx, 0, reads2.size - 1))
    q = jnp.where(cols[None, :] < m[:, None], qv, 4).astype(jnp.int8)
    tcols = jnp.arange(bucket + band, dtype=jnp.int32)
    tidx = t_start[:, None] + tcols[None, :]
    tvalid = (tidx >= t_lo[:, None]) & (tidx < t_hi[:, None])
    tv = jnp.take(panel_padded, jnp.clip(tidx, 0, panel_padded.size - 1))
    t = jnp.where(tvalid, tv, 4).astype(jnp.int8)
    return band_dp_batch(q, t, band, params)
