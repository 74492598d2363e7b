"""Fleet solve: every node's RouteDatabase from batched multi-root solves
(port of `openr_tpu/decision/fleet.py`).

The distances from every needed root (each target node and its
neighbors) come from `TorchSpfSolver._solve_dist` in chunks of `chunk`
roots; each node's ECMP first hops then follow on the host from the
shared matrix by the identity `first_hop_matrix` uses, and its routes
from the solver's own assembly. The result equals each node's own
`compute_routes`.
"""

from __future__ import annotations

import numpy as np

from openr_tpu_torch.ops.spf import INF_DIST, METRIC_MAX, HostRows, pad_batch
from openr_tpu_torch.types.routes import RouteDatabase


def compute_fleet_ribs(ls, ps, nodes: list[str] | None = None, solver=None,
                       chunk: int = 256) -> dict[str, RouteDatabase]:
    """RouteDatabases for every node in `nodes` (default: all nodes of
    the topology; unknown names are skipped) from batched solves of the
    roots they need, `chunk` roots at a time (a power-of-two bucket; the
    last chunk repeats roots to fill it). Each chunk's copy to the host
    runs on a side stream while the next chunk solves. `solver` defaults
    to `TorchSpfSolver()`, on the card. LFA backups are not assembled
    here: a solver with `enable_lfa` raises."""
    from openr_tpu_torch.decision.spf_backend import TorchSpfSolver

    if solver is None:
        solver = TorchSpfSolver()
    if solver.enable_lfa:
        raise ValueError(
            "compute_fleet_ribs does not assemble LFA backups; use the "
            "per-node TorchSpfSolver(enable_lfa=True) path"
        )
    csr = ls.to_csr()
    if csr.num_nodes == 0:
        return {}
    nbrs_of: dict[int, list[int]] = {}
    for (s, d) in csr.adj_details:
        nbrs_of.setdefault(s, []).append(d)
    targets = [
        node
        for node in (nodes if nodes is not None else list(csr.node_names))
        if node in csr.name_to_id
    ]
    if not targets:
        return {}
    # only the roots the targets need: a subset request must not pay a
    # whole-fleet solve
    needed: set[int] = set()
    for node in targets:
        mid = csr.name_to_id[node]
        needed.add(mid)
        needed.update(nbrs_of.get(mid, []))
    root_list = np.array(sorted(needed), dtype=np.int32)
    col_of = {int(r): i for i, r in enumerate(root_list)}

    chunk = pad_batch(min(chunk, max(len(root_list), 1)))
    n_roots = len(root_list)
    sink = HostRows(n_roots, solver.solve_vp(csr), solver.device)
    for start in range(0, n_roots, chunk):
        roots = np.resize(root_list[start : start + chunk], chunk)
        d = solver._solve_dist(csr, roots)
        sink.put(start, d, min(chunk, n_roots - start))
    dist_all = sink.result().T  # [vp, roots]
    # one fingerprint of the route caches per root: raise the cap for
    # good, so a second pass on a shared solver reuses every root's
    # entries (`trim_caches` sets it back)
    solver._mpls_fingerprint_cap = max(
        solver._mpls_fingerprint_cap, len(targets) + 1
    )
    return _assemble_all(solver, ls, ps, csr, targets, nbrs_of, col_of,
                         dist_all)


def _assemble_all(solver, ls, ps, csr, targets, nbrs_of, col_of, dist_all
                  ) -> dict[str, RouteDatabase]:
    out: dict[str, RouteDatabase] = {}
    vp = dist_all.shape[0]
    for node in targets:
        my_id = csr.name_to_id[node]
        nbr_ids = sorted(nbrs_of.get(my_id, []))
        k = len(nbr_ids)
        b = pad_batch(1 + k)
        nbr_metric = np.empty(k, dtype=np.int64)
        for i, d in enumerate(nbr_ids):
            nbr_metric[i] = min(
                min(det[1] for det in csr.details(my_id, d)), METRIC_MAX
            )
        d_root = dist_all[:, col_of[my_id]].astype(np.int64)
        d_nbr = dist_all[:, [col_of[d] for d in nbr_ids]].astype(np.int64)
        # the first-hop identity on the host: n is a first hop toward v
        # iff m(root, n) + dist_n(v) == dist_root(v); overloaded neighbors
        # only toward themselves
        reach = (d_root[:, None] < INF_DIST) & (d_nbr < INF_DIST)
        on_spt = reach & (nbr_metric[None, :] + d_nbr == d_root[:, None])
        if k:
            ids = np.array(nbr_ids)
            dest_is_nbr = np.arange(vp)[:, None] == ids[None, :]
            on_spt &= ~csr.node_overloaded[ids][None, :] | dest_is_nbr
        fh = np.zeros((b - 1, vp), dtype=bool)
        fh[:k] = on_spt.T
        solved = (
            csr, d_root.astype(np.int32)[:, None], fh, nbr_ids, None,
        )
        rdb = RouteDatabase(this_node_name=node)
        out[node] = solver._assemble_routes(rdb, ls, ps, node, solved)
    return out
