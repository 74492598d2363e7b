"""Synthetic topology generators (the port's copy of
`openr_tpu/utils/topogen.py`): same seeds, same graphs, same arrays.

Every dataclass generator returns `(adj_dbs, prefix_dbs)`: one
AdjacencyDatabase per node (bidirectional adjacencies, integer metrics)
and one PrefixDatabase per node advertising its loopback.
"""

from __future__ import annotations

import numpy as np

from openr_tpu_torch.common.constants import DIST_INF
from openr_tpu_torch.common.util import pad_bucket
from openr_tpu_torch.types.network import IpPrefix
from openr_tpu_torch.types.topology import (
    Adjacency,
    AdjacencyDatabase,
    PrefixDatabase,
    PrefixEntry,
)


def node_name(i: int) -> str:
    return f"node-{i}"


def loopback(i: int) -> IpPrefix:
    """Unique /32 per node out of 10.0.0.0/8."""
    return IpPrefix.make(
        f"10.{(i >> 16) & 0xFF}.{(i >> 8) & 0xFF}.{i & 0xFF}/32"
    )


def _mk_dbs(n: int, edges: list[tuple[int, int, int]], area: str = "0"):
    """edges: directed (u, v, metric); callers emit both directions."""
    adjs: dict[int, list[Adjacency]] = {i: [] for i in range(n)}
    for u, v, m in edges:
        adjs[u].append(
            Adjacency(
                other_node_name=node_name(v),
                if_name=f"if_{u}_{v}",
                other_if_name=f"if_{v}_{u}",
                metric=m,
            )
        )
    adj_dbs = [
        AdjacencyDatabase(
            this_node_name=node_name(i),
            adjacencies=tuple(adjs[i]),
            node_label=101 + i,
            area=area,
        )
        for i in range(n)
    ]
    prefix_dbs = [
        PrefixDatabase(
            this_node_name=node_name(i),
            prefix_entries=(PrefixEntry(prefix=loopback(i)),),
            area=area,
        )
        for i in range(n)
    ]
    return adj_dbs, prefix_dbs


def ring(n: int, metric: int = 1):
    edges = []
    for i in range(n):
        j = (i + 1) % n
        edges += [(i, j, metric), (j, i, metric)]
    return _mk_dbs(n, edges)


def grid(rows: int, cols: int, metric: int = 1):
    edges = []
    for r in range(rows):
        for c in range(cols):
            a = r * cols + c
            if c + 1 < cols:
                edges += [(a, a + 1, metric), (a + 1, a, metric)]
            if r + 1 < rows:
                edges += [(a, a + cols, metric), (a + cols, a, metric)]
    return _mk_dbs(rows * cols, edges)


def full_mesh(n: int, metric: int = 1):
    edges = []
    for i in range(n):
        for j in range(i + 1, n):
            edges += [(i, j, metric), (j, i, metric)]
    return _mk_dbs(n, edges)


def fat_tree(k: int = 4, metric: int = 1):
    """3-tier k-ary fat-tree: (k/2)^2 cores; k pods of k/2 agg + k/2
    tor; every tor to every agg of its pod; agg i of each pod to cores
    [i*(k/2), (i+1)*(k/2))."""
    assert k % 2 == 0
    half = k // 2
    n_core = half * half
    n_agg = k * half
    n = n_core + n_agg + k * half
    edges = []
    for pod in range(k):
        for a in range(half):
            agg = n_core + pod * half + a
            for t in range(half):
                tor = n_core + n_agg + pod * half + t
                edges += [(agg, tor, metric), (tor, agg, metric)]
            for c in range(half):
                core = a * half + c
                edges += [(agg, core, metric), (core, agg, metric)]
    return _mk_dbs(n, edges)


def fat_tree_pod(k: int = 4, pods: int = 1, metric: int = 1):
    """A pod-granular slice of `fat_tree(k)`: the (k/2)^2 cores and
    `pods` pods of k/2 agg + k/2 tor each ((k/2)^2 + pods * k nodes;
    `pods=k` is the whole tree), with the same wiring."""
    assert k % 2 == 0 and k >= 2, k
    assert 1 <= pods <= k, (pods, k)
    half = k // 2
    n_core = half * half
    edges = []
    for pod in range(pods):
        for a in range(half):
            agg = n_core + pod * k + a
            for t in range(half):
                tor = n_core + pod * k + half + t
                edges += [(agg, tor, metric), (tor, agg, metric)]
            for c in range(half):
                core = a * half + c
                edges += [(agg, core, metric), (core, agg, metric)]
    return _mk_dbs(n_core + pods * k, edges)


def wan_like(
    n: int,
    seed: int = 0,
    core_frac: float = 0.25,
    metric_lo: int = 10,
    metric_hi: int = 100,
):
    """A ring of core POPs with seeded express chords; every other node
    a stub dual-homed to two core POPs; seeded metrics."""
    assert n >= 4, n
    rng = np.random.default_rng(seed)
    n_core = min(max(3, int(n * core_frac)), n)
    n_stub = n - n_core

    def m():
        return int(rng.integers(metric_lo, metric_hi + 1))

    edges = []
    seen: set[tuple[int, int]] = set()

    def add(u, v, w):
        if u == v or (u, v) in seen:
            return
        seen.add((u, v))
        seen.add((v, u))
        edges.append((u, v, w))
        edges.append((v, u, w))

    for i in range(n_core):
        add(i, (i + 1) % n_core, m())
    for _ in range(max(1, n_core // 3)):
        u = int(rng.integers(0, n_core))
        v = int(rng.integers(0, n_core))
        add(u, v, m())
    for s in range(n_stub):
        sid = n_core + s
        h = int(rng.integers(0, n_core))
        add(sid, h, m())
        if n_core > 1:
            add(sid, (h + 1) % n_core, m())
    return _mk_dbs(n, edges)


def hub_and_spoke(
    hubs: int = 2, spokes: int = 8, metric: int = 1, spoke_metric: int = 10
):
    """Fully meshed hubs; each spoke dual-homed to a primary hub
    (round-robin) and the next hub over."""
    assert hubs >= 1 and spokes >= 0, (hubs, spokes)
    edges = []
    for i in range(hubs):
        for j in range(i + 1, hubs):
            edges += [(i, j, metric), (j, i, metric)]
    for s in range(spokes):
        sid = hubs + s
        h = s % hubs
        edges += [(sid, h, spoke_metric), (h, sid, spoke_metric)]
        if hubs > 1:
            b = (h + 1) % hubs
            edges += [(sid, b, spoke_metric), (b, sid, spoke_metric)]
    return _mk_dbs(hubs + spokes, edges)


def edges_of(adj_dbs) -> list[tuple[str, str]]:
    """The undirected (name_a, name_b) pairs of a generator's adjacency
    databases, sorted: the wiring list `emulator.Cluster.from_edges`
    takes (each pair becomes one point-to-point link)."""
    pairs: set[tuple[str, str]] = set()
    for db in adj_dbs:
        for adj in db.adjacencies:
            a, b = db.this_node_name, adj.other_node_name
            pairs.add((a, b) if a < b else (b, a))
    return sorted(pairs)


def erdos_renyi(n: int, avg_degree: int = 10, seed: int = 0,
                max_metric: int = 16):
    """Random graph with ~n*avg_degree/2 undirected edges (BASELINE
    config 3's shape at LinkState scale): a backbone ring for
    connectivity plus random chords, metrics uniform in [1, max_metric]."""
    rng = np.random.default_rng(seed)
    seen = set()
    edges = []

    def add(u, v, m):
        if u == v or (u, v) in seen:
            return
        seen.add((u, v))
        seen.add((v, u))
        edges.append((u, v, m))
        edges.append((v, u, m))

    for i in range(n):
        add(i, (i + 1) % n, int(rng.integers(1, max_metric + 1)))
    target = n * avg_degree // 2
    us = rng.integers(0, n, size=3 * target)
    vs = rng.integers(0, n, size=3 * target)
    ms = rng.integers(1, max_metric + 1, size=3 * target)
    for u, v, m in zip(us, vs, ms):
        if len(seen) // 2 >= target:
            break
        add(int(u), int(v), int(m))
    return _mk_dbs(n, edges)


def erdos_renyi_csr(
    n: int, avg_degree: int = 10, seed: int = 0, max_metric: int = 16
):
    """Padded CSR arrays of a random graph (backbone ring + chords)
    without building dataclasses: (edge_src, edge_dst, edge_metric,
    padded_nodes, n, num_edges)."""
    rng = np.random.default_rng(seed)
    target = n * avg_degree // 2
    ring_u = np.arange(n, dtype=np.int64)
    ring_v = (ring_u + 1) % n
    us = rng.integers(0, n, size=int(2.2 * target))
    vs = rng.integers(0, n, size=int(2.2 * target))
    keep = us != vs
    us, vs = us[keep], vs[keep]
    u_all = np.concatenate([ring_u, us])
    v_all = np.concatenate([ring_v, vs])
    lo, hi = np.minimum(u_all, v_all), np.maximum(u_all, v_all)
    _, first_idx = np.unique(lo * n + hi, return_index=True)
    first_idx = np.sort(first_idx)[: target + n]
    lo, hi = lo[first_idx], hi[first_idx]
    metric = rng.integers(1, max_metric + 1, size=lo.shape[0])

    src = np.concatenate([lo, hi]).astype(np.int32)
    dst = np.concatenate([hi, lo]).astype(np.int32)
    met = np.concatenate([metric, metric]).astype(np.int32)
    order = np.argsort(dst, kind="stable")
    src, dst, met = src[order], dst[order], met[order]

    e = src.shape[0]
    vp = pad_bucket(n + 1)
    ep = pad_bucket(e, minimum=128)
    edge_src = np.zeros(ep, dtype=np.int32)
    edge_dst = np.full(ep, vp - 1, dtype=np.int32)
    edge_metric = np.full(ep, DIST_INF, dtype=np.int32)
    edge_src[:e] = src
    edge_dst[:e] = dst
    edge_metric[:e] = met
    return edge_src, edge_dst, edge_metric, vp, n, e


class LsdbView:
    """LinkState-shaped read surface over a directly built CsrGraph, for
    benchmark-scale topologies: the RIB path reads only `to_csr()`,
    `area`, `nodes`, `node_label()` and `adjacency_db()`."""

    def __init__(self, csr, area: str = "0"):
        self._csr = csr
        self.area = area
        self.nodes = list(csr.node_names)
        self._labels = {s: 101 + i for i, s in enumerate(csr.node_names)}
        self._out_index = None

    def to_csr(self):
        return self._csr

    def node_label(self, node: str) -> int:
        return self._labels[node]

    def adjacency_db(self, node: str):
        """Synthesized from the CSR arrays (no per-link labels)."""
        csr = self._csr
        nid = csr.name_to_id.get(node)
        if nid is None:
            return None
        if self._out_index is None:
            valid = csr.edge_metric < DIST_INF
            src = csr.edge_src[valid]
            order = np.argsort(src, kind="stable")
            starts = np.searchsorted(
                src[order], np.arange(csr.padded_nodes + 1)
            )
            self._out_index = (
                csr.edge_dst[valid][order],
                csr.edge_metric[valid][order],
                starts,
            )
        dst, met, starts = self._out_index
        lo, hi = starts[nid], starts[nid + 1]
        adjs = tuple(
            Adjacency(
                other_node_name=csr.node_names[int(d)],
                if_name=f"if_{nid}_{int(d)}",
                other_if_name=f"if_{int(d)}_{nid}",
                metric=int(m),
            )
            for d, m in zip(dst[lo:hi], met[lo:hi])
        )
        return AdjacencyDatabase(
            this_node_name=node,
            adjacencies=adjs,
            node_label=self._labels[node],
            area=self.area,
        )


def erdos_renyi_lsdb(
    n: int, avg_degree: int = 20, seed: int = 0, max_metric: int = 64
):
    """Benchmark-scale LSDB: (ls_view, prefix_state, csr). adj_details
    are filled for node-0 only (the vantage point); one loopback prefix
    per node."""
    from openr_tpu_torch.decision.linkstate import (
        CsrGraph,
        PrefixState,
        next_csr_version,
    )

    edge_src, edge_dst, edge_metric, vp, nn, e = erdos_renyi_csr(
        n, avg_degree=avg_degree, seed=seed, max_metric=max_metric
    )
    names = [node_name(i) for i in range(nn)]
    valid = edge_metric < DIST_INF
    my = 0
    adj_details: dict = {}
    out_mask = (edge_src == my) & valid
    for d, m in zip(edge_dst[out_mask], edge_metric[out_mask]):
        adj_details.setdefault((my, int(d)), []).append(
            (f"if_{my}_{int(d)}", int(m), 0, 0, f"if_{int(d)}_{my}")
        )
    ver = next_csr_version()
    csr = CsrGraph(
        num_nodes=nn,
        num_edges=int(e),
        edge_src=edge_src,
        edge_dst=edge_dst,
        edge_metric=edge_metric,
        node_overloaded=np.zeros(vp, dtype=bool),
        node_mask=np.arange(vp) < nn,
        node_names=names,
        adj_details=adj_details,
        name_to_id={s: i for i, s in enumerate(names)},
        version=ver,
        base_version=ver,
    )
    ps = PrefixState()
    for i, s in enumerate(names):
        entry = PrefixEntry(prefix=loopback(i))
        ps._entries[entry.prefix] = {s: entry}
    return LsdbView(csr), ps, csr


def _v4_str(addr: int) -> str:
    return (
        f"{(addr >> 24) & 0xFF}.{(addr >> 16) & 0xFF}."
        f"{(addr >> 8) & 0xFF}.{addr & 0xFF}"
    )


def ramp_prefix_state(
    names: list[str],
    n_prefixes: int,
    anycast_every: int = 0,
    base: str = "16.0.0.0",
):
    """PrefixState with `n_prefixes` /32s from `base` up, advertised
    round-robin across `names[1:]` (node 0 is the vantage point, so
    routes == prefixes). With `anycast_every` = k > 0, every k-th prefix
    gains a second advertiser, the next one in the round (an equal-metric
    anycast pair)."""
    import ipaddress

    from openr_tpu_torch.decision.linkstate import PrefixState

    base_int = int(ipaddress.IPv4Address(base))
    if base_int + n_prefixes > 1 << 32:
        raise ValueError("range overflows the v4 address space")
    ps = PrefixState()
    adv = names[1:] or names
    n_adv = len(adv)
    entries = ps._entries
    for i in range(n_prefixes):
        e = PrefixEntry(prefix=IpPrefix(prefix=f"{_v4_str(base_int + i)}/32"))
        per = {adv[i % n_adv]: e}
        if anycast_every and i % anycast_every == 0 and n_adv > 1:
            per[adv[(i + 1) % n_adv]] = e
        entries[e.prefix] = per
    ps._rev += 1
    return ps


def backbone(rings: int, ring_size: int):
    """Ring of rings (the WAN backbone of BASELINE config 4): `rings`
    site rings of `ring_size` nodes `bb<i>` (metric 10), adjacent sites
    joined by two inter-site links (metric 100) at ring positions 0 and
    ring_size // 2, so edge-disjoint paths exist everywhere. Node labels
    100000 + i. Returns the AdjacencyDatabases."""
    n = rings * ring_size
    edges: dict[tuple[int, int], int] = {}

    def add(a, b, m):
        edges[(a, b)] = m
        edges[(b, a)] = m

    for r in range(rings):
        base = r * ring_size
        for i in range(ring_size):
            add(base + i, base + (i + 1) % ring_size, 10)
        nxt = ((r + 1) % rings) * ring_size
        add(base, nxt, 100)  # inter-site
        add(base + ring_size // 2, nxt + ring_size // 2, 100)
    by_src: dict[int, list] = {}
    for (a, b), m in edges.items():
        by_src.setdefault(a, []).append((b, m))
    dbs = []
    for a in range(n):
        adjs = tuple(
            Adjacency(
                other_node_name=f"bb{b}", if_name=f"if{a}-{b}",
                other_if_name=f"if{b}-{a}", metric=m,
            )
            for b, m in sorted(by_src.get(a, []))
        )
        dbs.append(
            AdjacencyDatabase(
                this_node_name=f"bb{a}", adjacencies=adjs,
                node_label=100_000 + a,
            )
        )
    return dbs
