"""Hopper banded-DP kernel (``band_dp.cu``) called through ``jax.ffi``.

One warp per DP problem with the band held in registers; the kernel fetches
its read and target windows itself from the uploaded buffers by the (5, P)
window metadata (align/device.py ``META_ROWS``) and returns the (P, 5)
``OUT_COLS`` matrix of :func:`align.device.window_score_packed`,
bit-identical to ``band_dp_batch`` on the same windows.

The shared library is built from ``band_dp.cu`` with ``nvcc`` for
``sm_90a`` on first use, into ``build/`` beside this file (git-ignored);
the file name carries a hash of the source, so an edited kernel is rebuilt.
``python -m svjedi_tpu.kernels.band_dp_cuda`` builds it ahead of time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..align.extend import DPParams

SOURCE = Path(__file__).with_name("band_dp.cu")
BUILD_DIR = Path(__file__).with_name("build")
TARGET = "svt_band_dp"
#: Band widths the kernel is instantiated for (32 lanes x 1/2/4/8 cells).
BANDS = (32, 64, 128, 256)
#: Start coordinates travel as (row << 16 | target column).
MAX_WINDOW = 1 << 16


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libsvt_band_dp_{digest}.so"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is required to build "
                       "the GPU banded-DP kernel")


def build_command(out: Path, compiler: str = "nvcc") -> List[str]:
    return [
        compiler,
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(),
        "-o", str(out), str(SOURCE),
    ]


def build() -> Path:
    """Compile the kernel library if this source has not been built yet."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        build_command(tmp, nvcc()), capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed building {SOURCE.name}:\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, lib)
    return lib


@functools.cache
def register() -> Path:
    """Build (if needed) and register the FFI target once per process."""
    lib = build()
    handle = ctypes.cdll.LoadLibrary(str(lib))
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(handle.SvtBandDp), platform="CUDA"
    )
    return lib


def check_problem(bucket: int, band: int, params: DPParams) -> None:
    """Reject shapes and scores the kernel's packed encodings cannot hold."""
    if band not in BANDS:
        raise ValueError(f"GPU band-DP kernel supports bands {BANDS}, "
                         f"got {band}")
    if bucket + band >= MAX_WINDOW:
        raise ValueError(f"window {bucket} + band {band} exceeds "
                         f"{MAX_WINDOW - 1} rows/columns")
    if params.gap_extend > 0 or params.match <= 0:
        raise ValueError("GPU band-DP kernel needs match > 0 and "
                         "gap_extend <= 0")
    if params.match * bucket - params.gap_extend * band >= 1 << 23:
        raise ValueError("scores too large for the kernel's 23-bit keys")


@functools.partial(jax.jit, static_argnames=("bucket", "band", "params"))
def _call(reads2, panel_padded, meta, bucket: int, band: int,
          params: DPParams):
    return jax.ffi.ffi_call(
        TARGET, jax.ShapeDtypeStruct((meta.shape[1], 5), jnp.int32)
    )(
        reads2, panel_padded, meta,
        bucket=np.int64(bucket), band=np.int64(band),
        match=np.int64(params.match), mismatch=np.int64(params.mismatch),
        gap_open=np.int64(params.gap_open),
        gap_extend=np.int64(params.gap_extend),
    )


def band_dp_windows(reads2, panel_padded, meta, bucket: int, band: int,
                    params: DPParams):
    """(P, 5) int32 [score, qs, ts, qe, te] for the (5, P) window metadata."""
    check_problem(bucket, band, params)
    register()
    return _call(reads2, panel_padded, meta, bucket=bucket, band=band,
                 params=params)


if __name__ == "__main__":
    print(build())
