"""Device-side owned-link table for the on-mesh count step.

The count step itself lives in dist/engine.py (the production DP engine
under shard_map with one psum of the (n_tags, 2) matrix); this module
holds the padded per-path owned-link table both the engine and the driver
entry points consume.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import jax.numpy as jnp


class OwnedTable(NamedTuple):
    """Per-path owned-link table, padded to K columns (host-built)."""

    junction: jnp.ndarray  # (n_paths, K) int32 path-space junction offsets
    tag: jnp.ndarray  # (n_paths, K) int32 tag ids
    allele: jnp.ndarray  # (n_paths, K) int32 0/1
    valid: jnp.ndarray  # (n_paths, K) bool
    #: crossed graph-link ids (cluster.PanelPath.owned[..][3]); used by the
    #: mesh count merge's per-(read, link, tag, allele) dedup. May be None
    #: for consumers that predate it (dist/engine.py ignores it).
    link: jnp.ndarray = None  # (n_paths, K) int32


def build_owned_table(panel, tag_to_id: Dict[str, int], k_max: int = 0) -> OwnedTable:
    """Pad each panel path's owned-link list into the device table."""
    import numpy as np

    K = max([len(p.owned) for p in panel.paths] + [1, k_max])
    n = len(panel.paths)
    junction = np.zeros((n, K), dtype=np.int32)
    tag = np.zeros((n, K), dtype=np.int32)
    allele = np.zeros((n, K), dtype=np.int32)
    link = np.zeros((n, K), dtype=np.int32)
    valid = np.zeros((n, K), dtype=bool)
    for pid, path in enumerate(panel.paths):
        for col, (t, a, j, li) in enumerate(path.owned):
            junction[pid, col] = j
            tag[pid, col] = tag_to_id[t]
            allele[pid, col] = a
            link[pid, col] = li
            valid[pid, col] = True
    return OwnedTable(
        junction=jnp.asarray(junction),
        tag=jnp.asarray(tag),
        allele=jnp.asarray(allele),
        valid=jnp.asarray(valid),
        link=jnp.asarray(link),
    )
