"""Multi-host (pod-slice) support: process init + cross-host count merge.

SURVEY §2.2/§5.8: the pipeline's only cross-read reduction is the
per-(SV, allele) alignment count — an associative integer sum — so the
multi-host story is: every host runs the align stage on its block of the
read stream (reads sharded by ``jax.process_index()``), then the count
tables merge across hosts, then one host genotypes. Two transports exist:

- the file-glued ``--shard i/n`` + ``merge`` commands (no coordinator
  needed; any shared filesystem);
- this module: ``jax.distributed`` process groups with the merge riding
  the interconnect (``--multihost`` on the run command), no shared
  filesystem required.

Counts are tag-keyed dicts whose key sets differ per host (a host may see
no read for some SV), so the merge all-gathers the serialized tables and
sums — the payload is a few KB; one collective at the end of the run.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Join the jax.distributed process group; return (index, count).

    With no arguments, jax.distributed.initialize auto-discovers the
    cluster from a cluster manager's environment (e.g. SLURM); on a single
    unconfigured host auto-detection fails and (0, 1) is returned with a
    warning.

    jax.distributed.initialize must run before ANYTHING touches the XLA
    backend (jax 0.9 raises RuntimeError otherwise), including
    jax.process_count() — so the initialize attempt comes first, and the
    already-initialized-backend case is handled explicitly rather than
    probed for. Explicit coordination parameters never degrade silently:
    if they cannot be applied, this raises.
    """
    import sys

    import jax

    explicit = any(
        v is not None
        for v in (coordinator_address, num_processes, process_id)
    )
    if jax.distributed.is_initialized():
        # A prior initialize() (ours or the caller's) already joined the
        # group; re-joining is an error, so just report the membership.
        if explicit:
            raise RuntimeError(
                "--multihost coordination parameters given but "
                "jax.distributed was already initialized earlier in this "
                "process; pass them before any other JAX use"
            )
        return jax.process_index(), jax.process_count()
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as exc:
        if "backend" in str(exc).lower():
            # The XLA backend was touched before us. Without explicit
            # config this process may still legitimately be single-host;
            # with explicit config the user asked for a group we cannot
            # join — that must be fatal, not N independent full runs
            # racing on one output prefix.
            if explicit:
                raise RuntimeError(
                    "jax.distributed.initialize() could not run: the XLA "
                    "backend was already initialized. --multihost with "
                    "explicit coordination must be the first JAX call in "
                    "the process."
                ) from exc
            print(
                "[multihost] WARNING: XLA backend already initialized; "
                "skipping jax.distributed auto-init "
                f"({exc})",
                file=sys.stderr,
            )
        elif explicit:
            raise
        else:
            # Auto-detection found no cluster: single-process mode.
            print(
                f"[multihost] no cluster detected ({exc}); running "
                "single-process",
                file=sys.stderr,
            )
    except ValueError:
        if explicit:
            raise
        print(
            "[multihost] no cluster configuration; running single-process",
            file=sys.stderr,
        )
    return jax.process_index(), jax.process_count()


def process_read_block(n_reads: int) -> Tuple[int, int]:
    """This host's contiguous [lo, hi) block of the global read stream."""
    import jax

    i, n = jax.process_index(), jax.process_count()
    return n_reads * i // n, n_reads * (i + 1) // n


def allreduce_counts(
    counts: Dict[str, List[int]]
) -> Dict[str, List[int]]:
    """Sum per-(SV, allele) count tables across all hosts.

    Identity on a single process. Tables are serialized (key sets differ
    per host), length-padded, all-gathered over the global device mesh,
    and summed — order-independent by associativity.
    """
    import jax

    if jax.process_count() == 1:
        return counts
    import numpy as np
    from jax.experimental import multihost_utils

    # Processes reach this first collective with however much skew their
    # align stages had (minutes at genome scale); gloo's lazy TCP pair
    # setup inside the allgather only tolerates ~30 s of it ("Gloo context
    # initialization failed: Connect timeout"). The coordination-service
    # barrier has a configurable timeout and no gloo involvement, so wait
    # there first — after it, every process enters the gloo collective
    # within milliseconds.
    try:
        from jax._src import distributed

        client = distributed.global_state.client
        if client is not None:
            client.wait_at_barrier(
                "svjt_allreduce_counts", timeout_in_ms=3_600_000
            )
    except Exception:
        pass  # best-effort: without it, small-skew runs still work

    payload = np.frombuffer(
        json.dumps(counts, sort_keys=True).encode(), dtype=np.uint8
    )
    n = np.array([len(payload)], dtype=np.int32)
    max_n = int(multihost_utils.process_allgather(n).max())
    padded = np.zeros(max_n, dtype=np.uint8)
    padded[: len(payload)] = payload
    gathered = np.asarray(multihost_utils.process_allgather(padded))
    lengths = np.asarray(multihost_utils.process_allgather(n)).reshape(-1)
    merged: Dict[str, List[int]] = {}
    for row, ln in zip(gathered, lengths):
        part = json.loads(bytes(row[: int(ln)]).decode())
        for tag, pair in part.items():
            entry = merged.setdefault(tag, [0, 0])
            entry[0] += pair[0]
            entry[1] += pair[1]
    return merged
