"""Carry state into the port: table sets and CSR graphs from NumPy.

Both take plain arrays, so state built by either package (the JAX
package's `build_split_tables` dict, its `CsrGraph` fields) crosses
over without the port importing anything of it.
"""

from __future__ import annotations

import numpy as np
import torch

from openr_tpu_torch.decision.linkstate import (
    CsrGraph,
    MetricPatch,
    next_csr_version,
)

_TABLE_KEYS = ("base_nbr", "base_wgt", "ov_ids", "ov_nbr", "ov_wgt", "out_nbr")


def split_tables_from_numpy(
    tables: dict, node_overloaded: np.ndarray, device
) -> dict:
    """Device table set for `ops.spf_split` from a `build_split_tables`
    dict: int32 tables, plus `over` [vp] bool (the node overload bits,
    cut or zero-padded to vp), `vp` and `uniform_metric` as ints, and
    under `host` what the metric-patch scatter needs on the host: the
    base width `base_w` and the overflow row of each node, `ov_pos`."""
    vp = int(tables["vp"])
    over = np.zeros(vp, dtype=bool)
    m = min(vp, len(node_overloaded))
    over[:m] = np.asarray(node_overloaded[:m], dtype=bool)
    out = {
        k: torch.from_numpy(
            np.ascontiguousarray(tables[k], dtype=np.int32)
        ).to(device)
        for k in _TABLE_KEYS
    }
    out["over"] = torch.from_numpy(over).to(device)
    out["vp"] = vp
    out["uniform_metric"] = int(tables.get("uniform_metric", 0))
    out["host"] = {
        "base_w": int(np.shape(tables["base_nbr"])[1]),
        "ov_pos": np.array(tables["ov_pos"], dtype=np.int64),
    }
    return out


def csr_from_numpy(
    *,
    num_nodes: int,
    num_edges: int,
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_metric: np.ndarray,
    node_overloaded: np.ndarray,
    node_mask: np.ndarray,
    node_names,
    adj_details: dict,
    adj_overrides: dict | None = None,
    edge_index: dict | None = None,
    patches=(),
    base_version: int | None = None,
    dense_tables=None,
) -> CsrGraph:
    """A port `CsrGraph` from another CSR's arrays, names, adjacency
    details and, for a patched CSR, its details overrides, edge index
    and patch journal (each patch any object with the `MetricPatch`
    fields). Everything is copied and the graph gets a fresh version.

    `base_version` is the fresh version too, unless given: pass the
    `base_version` of the port CSR that this one's journal patches
    (made by an earlier call from the other package's base), and a
    solver that cached the base scatters the journal instead of
    rebuilding its tables.

    `dense_tables`, the other CSR's (nbr, wgt) dense in-neighbor tables,
    are carried as int32 copies, so that both packages' KSP reads the
    same arrays (else `dense_tables()` builds them from the edges)."""
    names = list(node_names)
    ver = next_csr_version()

    def details(d: dict) -> dict:
        return {
            (int(k[0]), int(k[1])): [tuple(x) for x in v]
            for k, v in d.items()
        }

    return CsrGraph(
        num_nodes=int(num_nodes),
        num_edges=int(num_edges),
        edge_src=np.array(edge_src, dtype=np.int32),
        edge_dst=np.array(edge_dst, dtype=np.int32),
        edge_metric=np.array(edge_metric, dtype=np.int32),
        node_overloaded=np.array(node_overloaded, dtype=bool),
        node_mask=np.array(node_mask, dtype=bool),
        node_names=names,
        adj_details=details(adj_details),
        name_to_id={s: i for i, s in enumerate(names)},
        adj_overrides=details(adj_overrides or {}),
        edge_index={
            (int(k[0]), int(k[1])): int(v)
            for k, v in (edge_index or {}).items()
        },
        version=ver,
        base_version=ver if base_version is None else int(base_version),
        patches=tuple(
            MetricPatch(int(p.edge_idx), int(p.dense_row),
                        int(p.dense_col), int(p.metric))
            for p in patches
        ),
        _dense=None if dense_tables is None else tuple(
            np.array(t, dtype=np.int32) for t in dense_tables
        ),
    )
