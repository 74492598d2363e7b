"""Carry state into the port: table sets and CSR graphs from NumPy.

Both take plain arrays, so state built by either package (the JAX
package's `build_split_tables` dict, its `CsrGraph` fields) crosses
over without the port importing anything of it.
"""

from __future__ import annotations

import numpy as np
import torch

from openr_tpu_torch.decision.linkstate import CsrGraph, next_csr_version

_TABLE_KEYS = ("base_nbr", "base_wgt", "ov_ids", "ov_nbr", "ov_wgt", "out_nbr")


def split_tables_from_numpy(
    tables: dict, node_overloaded: np.ndarray, device
) -> dict:
    """Device table set for `ops.spf_split` from a `build_split_tables`
    dict: int32 tables, plus `over` [vp] bool (the node overload bits,
    cut or zero-padded to vp), `vp` and `uniform_metric` as ints."""
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
) -> CsrGraph:
    """A port `CsrGraph` from another CSR's arrays, names and
    adjacency details (copied, with a fresh version)."""
    names = list(node_names)
    ver = next_csr_version()
    return CsrGraph(
        num_nodes=int(num_nodes),
        num_edges=int(num_edges),
        edge_src=np.array(edge_src, dtype=np.int32),
        edge_dst=np.array(edge_dst, dtype=np.int32),
        edge_metric=np.array(edge_metric, dtype=np.int32),
        node_overloaded=np.array(node_overloaded, dtype=bool),
        node_mask=np.array(node_mask, dtype=bool),
        node_names=names,
        adj_details={
            (int(k[0]), int(k[1])): [tuple(d) for d in v]
            for k, v in adj_details.items()
        },
        name_to_id={s: i for i, s in enumerate(names)},
        version=ver,
        base_version=ver,
    )
