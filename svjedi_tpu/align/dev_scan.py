"""On-device minimizer scan: the seed stage's dominant host cost moves to
the device.

The merged panel+decoy minimizer scan is pure elementwise integer work
(rolling 2-bit k-mer packing, a murmur finalizer, a w-window
leftmost-argmin) over buffers that ALREADY live in device memory for the
DP kernels, i.e. exactly what XLA fuses into one elementwise program.

Design: the scan uses no scatter and no per-element gather (the only XLA
ops here whose cost grows per element rather than fusing into the
elementwise pipeline). Emission is decided pointwise by
a run-length identity: position p is the leftmost argmin of SOME
w-window iff a(p) + b(p) >= w-1, where a(p) = length of the maximal run
of predecessors with strictly greater key and b(p) = maximal run of
successors with greater-or-equal key (both capped at w-1 and at the
read's k-mer range). Both runs are w-1 static shifted compares. The
result leaves the device as a fixed-size packed BITMASK of emitted
k-mer start positions (n_cap/8 bytes, one transfer, no capacity
overflow by construction); the host side (native ``svt_chain5``)
iterates set bits, recomputes hash/strand from the codes it already
holds, applies the panel bitmap + exact lookup, and chains — sharing
``chain_one_read`` with every other seeding path.

Reads with fewer than w k-mers (shorter than k+w-1 bases) use a
shrunken effective window the flat formulation cannot express; their
bits stay clear and ``svt_chain5`` scans them with the native per-read
scanner instead.

Reference context: this replaces the k-mer indexing/seeding half of
minigraph (invoked at svjedi-graph.py:104); the reference has no
device-side analog.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

#: Sentinel hash for invalid (N-containing / palindromic / cross-read)
#: k-mer positions — sorts after every real hash (matches native kInvalid).
INVALID = np.uint32(0xFFFFFFFF)


def _mix32(x: jnp.ndarray) -> jnp.ndarray:
    """murmur3 fmix32 finalizer — bit-identical to align/minimizer._mix32
    and native fmix32 (uint32 wrap-around multiply)."""
    x = x.astype(jnp.uint32)
    x ^= x >> jnp.uint32(16)
    x *= jnp.uint32(0x85EBCA6B)
    x ^= x >> jnp.uint32(13)
    x *= jnp.uint32(0xC2B2AE35)
    x ^= x >> jnp.uint32(16)
    return x


@functools.partial(jax.jit, static_argnames=("k", "w", "n_cap"))
def _scan_kernel(
    reads2: jnp.ndarray,
    offsets32: jnp.ndarray,
    k: int,
    w: int,
    n_cap: int,
) -> jnp.ndarray:
    """All-reads minimizer scan over the uploaded forward code buffer.

    Returns an (n_cap // 8,) uint8 bitmask: bit (p & 7) of byte (p >> 3)
    is set iff global k-mer start position p is an emitted minimizer of
    its read. One fused elementwise XLA program — no scatter, no gather.
    """
    codes = reads2[:n_cap]
    c = (codes & jnp.int8(3)).astype(jnp.uint32)
    comp = jnp.uint32(3) - c

    nk = n_cap - k + 1
    # Base-level read ids: read_id[p] = (#offsets <= p) - 1. The single
    # small scatter (R+1 updates) is noise.
    marks = jnp.zeros(n_cap + 1, jnp.int32).at[offsets32].add(
        1, mode="drop"
    )
    read_id = jnp.cumsum(marks)[:n_cap] - 1

    # Rolling k-mer packing, exactly as align/minimizer._kmer_values:
    # fwd = sum_j code[p+j] << 2(k-1-j);  rc from complemented mirror.
    fwd = jnp.zeros(nk, jnp.uint32)
    rc = jnp.zeros(nk, jnp.uint32)
    valid = jnp.ones(nk, jnp.bool_)
    for j in range(k):
        fwd = (fwd << jnp.uint32(2)) | c[j : j + nk]
        rc = (rc << jnp.uint32(2)) | comp[k - 1 - j : k - 1 - j + nk]
        valid &= codes[j : j + nk] < 4
    # k-mer-level read id: -1 unless the whole k-mer lies in one real
    # read (buffer padding shares id n_reads and is excluded).
    n_reads = offsets32.shape[0] - 1
    krid = jnp.where(
        (read_id[:nk] == read_id[k - 1 : k - 1 + nk])
        & (read_id[:nk] < n_reads),
        read_id[:nk],
        jnp.int32(-1),
    )

    h = _mix32(jnp.minimum(fwd, rc))
    h = jnp.where(
        valid & (fwd != rc) & (krid >= 0), h, jnp.uint32(INVALID)
    )

    # Emission by run lengths: p is the leftmost argmin of some w-window
    # of its read iff a + b >= w-1, with
    #   a = maximal run of predecessors j=p-1,p-2,.. (same read's k-mer
    #       range) with hash[j] > hash[p]   (strict: leftmost tie-break),
    #   b = maximal run of successors with hash[j] >= hash[p],
    # both capped at w-1. INVALID neighbors extend runs (they sort after
    # every real hash — native windows include them as sentinel keys);
    # out-of-read neighbors stop them (native windows never span reads).
    a = jnp.zeros(nk, jnp.int32)
    b = jnp.zeros(nk, jnp.int32)
    run_a = jnp.ones(nk, jnp.bool_)
    run_b = jnp.ones(nk, jnp.bool_)
    false_d = lambda d: jnp.zeros(d, jnp.bool_)  # noqa: E731
    for d in range(1, w):
        ok_a = jnp.concatenate(
            [false_d(d), (h[:-d] > h[d:]) & (krid[:-d] == krid[d:])]
        )
        ok_b = jnp.concatenate(
            [(h[d:] >= h[:-d]) & (krid[d:] == krid[:-d]), false_d(d)]
        )
        run_a &= ok_a
        run_b &= ok_b
        a += run_a
        b += run_b
    emitted = (h != jnp.uint32(INVALID)) & (a + b >= w - 1)

    # Bitpack (LSB-first, the index.hash_bitmap byte convention).
    emitted = jnp.concatenate(
        [emitted, jnp.zeros(n_cap - nk, jnp.bool_)]
    )
    weights = jnp.asarray([1, 2, 4, 8, 16, 32, 64, 128], jnp.uint8)
    return (
        emitted.reshape(n_cap // 8, 8).astype(jnp.uint8) * weights
    ).sum(axis=1, dtype=jnp.uint8)


def _scan_cap(n_codes: int, n_cap: int) -> int:
    """Static scan length: n_codes rounded up to a quarter-octave class
    ({1, 1.25, 1.5, 1.75} x 2^k, multiple-of-8), capped at the buffer's
    n_cap. The buffer keeps n_cap's coarse power-of-two classes, but the
    scan is a cheap XLA compile, so finer classes are affordable — and the
    power-of-two padding is real device time at big chunks (a 17 Mb chunk
    pads to 33.6 M: the scan would run 2x the useful volume)."""
    if n_codes <= 32:
        return min(32, n_cap)
    base = 1 << max((n_codes - 1).bit_length() - 1, 5)
    for num in (4, 5, 6, 7, 8):
        cap = base * num // 4  # base >= 32: always a multiple of 8
        if cap >= n_codes:
            return min(cap, n_cap)
    return n_cap


#: One-time note when the async-d2h hint fails for an unexpected reason.
_ASYNC_WARNED = False


def dispatch_scan(device_data, k: int, w: int) -> jnp.ndarray:
    """Enqueue the scan for an uploaded chunk; returns the device bitmask.

    ``device_data`` must come from ``device.upload(..., offsets=...)`` so
    the boundary table is on device. The d2h copy is pre-started so the
    later fetch finds it resident.
    """
    if device_data.offsets32 is None:
        raise ValueError(
            "dispatch_scan needs device_data.offsets32: call "
            "device.upload(..., offsets=chunk.offsets)"
        )
    out = _scan_kernel(
        device_data.reads2, device_data.offsets32,
        k=k, w=w,
        n_cap=_scan_cap(device_data.n_codes, device_data.n_bases),
    )
    try:
        out.copy_to_host_async()
    except Exception as exc:  # noqa: BLE001 - the call is purely a hint
        # Any failure here (missing API on this backend, a transient
        # transfer error, ...) must degrade to a synchronous fetch, never
        # abort the run: fetch_bitmask does the real transfer either way.
        global _ASYNC_WARNED
        if not _ASYNC_WARNED and not isinstance(
            exc, (AttributeError, NotImplementedError)
        ):
            import sys

            print(
                f"[dev_scan] note: async d2h hint failed ({exc!r}); "
                "falling back to synchronous fetches",
                file=sys.stderr,
            )
            _ASYNC_WARNED = True
    return out


def fetch_bitmask(scan_out: jnp.ndarray) -> np.ndarray:
    """Device bitmask -> host uint8 array (the async copy usually makes
    this a no-op by fetch time)."""
    return np.asarray(scan_out)


def bitmask_positions(
    bitmask: np.ndarray, offsets: np.ndarray
) -> tuple:
    """(read_id, local_pos) of every set bit — test/debug helper; the
    production path hands the bitmask straight to native svt_chain5."""
    bits = np.unpackbits(bitmask, bitorder="little")
    pos_g = np.flatnonzero(bits).astype(np.int64)
    rid = (np.searchsorted(offsets, pos_g, side="right") - 1).astype(
        np.int32
    )
    return rid, (pos_g - offsets[rid]).astype(np.int32)
