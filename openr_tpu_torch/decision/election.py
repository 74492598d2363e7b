"""Prefix classification for RIB assembly.

The port's copy of the classification half of
`openr_tpu/decision/election.py`: prefixes split into "plain" (one
known advertiser, SP_ECMP, no constraints), "multi" (anycast ECMP: two
or more advertisers, all plain-shaped, as a CSR prefix->advertiser
matrix) and "complex" (everything else); and the scalar half of the
multi-advertiser election over that matrix (`elect_multi_np`, the NumPy
path; `ops/election.py` runs the same algebra on the device).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from openr_tpu_torch.common.constants import DIST_INF
from openr_tpu_torch.types.topology import ForwardingAlgorithm

INF64 = np.int64(DIST_INF)


@dataclass
class MultiTable:
    """Columnar prefix->advertiser matrix (slot s belongs to prefix
    ``seg[s]``); known advertisers first within a prefix, by NAME."""

    prefixes: list
    indptr: np.ndarray  # int64 [M+1]
    seg: np.ndarray  # int64 [S]
    adv: np.ndarray  # int64 [S] advertiser node id (0 for unknown)
    known: np.ndarray  # bool [S]
    rank: np.ndarray  # int64 [S] dense metric-key rank (higher = better)
    entries: list
    names: list


@dataclass
class ElectView:
    """One PrefixState revision's election-ready classification."""

    plain_p: list  # [P] IpPrefix
    plain_n: list  # [P] advertiser name
    plain_e: list  # [P] PrefixEntry
    orig: np.ndarray  # int64 [P] advertiser node id
    multi: MultiTable | None
    complex_items: list  # [(prefix, {node: entry})]
    gen: tuple  # (lineage, rev, base_version)


@dataclass
class MultiElection:
    """Per-prefix outcome arrays of one multi-table election."""

    survive: np.ndarray  # bool [M] a route exists (reachable, not local)
    local: np.ndarray  # bool [M] my node among the best advertisers
    is_best: np.ndarray  # bool [S] slot in the best-metric-key set
    chosen: np.ndarray  # bool [S] slot in the min-IGP chosen set
    min_igp: np.ndarray  # int64 [M]


def _entry_plain(e) -> bool:
    return (
        e.forwarding_algorithm == ForwardingAlgorithm.SP_ECMP
        and not e.min_nexthop
        and not e.weight
    )


def build_elect_view(entries: dict, name_to_id: dict, gen) -> ElectView:
    """Classify prefix -> {node: PrefixEntry} into the election view."""
    plain_p: list = []
    plain_n: list = []
    plain_e: list = []
    orig: list = []
    m_prefixes: list = []
    m_counts: list = []
    m_adv: list = []
    m_known: list = []
    m_keys: list = []
    m_entries: list = []
    m_names: list = []
    complex_items: list = []
    for prefix, per_node in sorted(entries.items()):
        if len(per_node) == 1:
            (node, entry), = per_node.items()
            nid = name_to_id.get(node)
            if nid is not None and _entry_plain(entry):
                plain_p.append(prefix)
                plain_n.append(node)
                plain_e.append(entry)
                orig.append(nid)
                continue
            complex_items.append((prefix, dict(per_node)))
            continue
        if all(_entry_plain(e) for e in per_node.values()):
            known_rows = sorted(
                (n, name_to_id[n]) for n in per_node if n in name_to_id
            )
            unknown_rows = sorted(n for n in per_node if n not in name_to_id)
            m_prefixes.append(prefix)
            m_counts.append(len(per_node))
            for n, nid in known_rows:
                e = per_node[n]
                m_adv.append(nid)
                m_known.append(True)
                m_keys.append(
                    (
                        e.metrics.path_preference,
                        e.metrics.source_preference,
                        -e.metrics.distance,
                    )
                )
                m_entries.append(e)
                m_names.append(n)
            for n in unknown_rows:
                m_adv.append(0)
                m_known.append(False)
                m_keys.append((0, 0, 0))
                m_entries.append(per_node[n])
                m_names.append(n)
            continue
        complex_items.append((prefix, dict(per_node)))

    multi: MultiTable | None = None
    if m_prefixes:
        counts = np.asarray(m_counts, dtype=np.int64)
        keys = np.asarray(m_keys, dtype=np.int64).reshape(-1, 3)
        # lexicographic row order == metric-key order, so the inverse
        # index is the dense rank
        _, rank = np.unique(keys, axis=0, return_inverse=True)
        multi = MultiTable(
            prefixes=m_prefixes,
            indptr=np.concatenate(([0], np.cumsum(counts))),
            seg=np.repeat(np.arange(len(m_prefixes), dtype=np.int64), counts),
            adv=np.asarray(m_adv, dtype=np.int64),
            known=np.asarray(m_known, dtype=bool),
            rank=rank.astype(np.int64).ravel(),
            entries=m_entries,
            names=m_names,
        )
    return ElectView(
        plain_p=plain_p,
        plain_n=plain_n,
        plain_e=plain_e,
        orig=np.asarray(orig, dtype=np.int64),
        multi=multi,
        complex_items=complex_items,
        gen=gen,
    )


def multi_items(t: MultiTable) -> list:
    """The multi table as `(prefix, {node: entry})` rows, for the general
    per-prefix path (LFA assembly)."""
    return [
        (
            t.prefixes[i],
            {
                t.names[s]: t.entries[s]
                for s in range(int(t.indptr[i]), int(t.indptr[i + 1]))
            },
        )
        for i in range(len(t.prefixes))
    ]


def elect_multi_np(
    t: MultiTable, d_vec: np.ndarray, reach_vec: np.ndarray, my_id: int
) -> MultiElection:
    """NumPy election over the multi table: eligible = reachable (finite
    distance and a first hop) or self; best = masked argmax over the
    metric-key ranks; local = self among the best; chosen = masked
    argmin over `d_vec` within the best set."""
    is_me = t.known & (t.adv == my_id)
    elig = (t.known & reach_vec[t.adv]) | is_me
    r_eff = np.where(elig, t.rank, np.int64(-1))
    best_r = np.maximum.reduceat(r_eff, t.indptr[:-1])
    has = best_r >= 0
    is_best = elig & (r_eff == best_r[t.seg])
    m = len(t.prefixes)
    local = np.zeros(m, dtype=bool)
    np.logical_or.at(local, t.seg[is_best & is_me], True)
    d_adv = np.where(is_best, d_vec[t.adv].astype(np.int64), INF64)
    min_igp = np.minimum.reduceat(d_adv, t.indptr[:-1])
    chosen = is_best & (d_adv == min_igp[t.seg])
    return MultiElection(
        survive=has & ~local,
        local=local,
        is_best=is_best,
        chosen=chosen,
        min_igp=min_igp,
    )


def iter_multi_winners(t: MultiTable, res: MultiElection):
    """Per surviving prefix: `(prefix, best_names, chosen_ids,
    chosen_names, igp, best_entry)`, names in slot (name) order and
    best_entry the first chosen slot's PrefixEntry."""
    for i in np.nonzero(res.survive)[0].tolist():
        lo, hi = int(t.indptr[i]), int(t.indptr[i + 1])
        best_rows = [s for s in range(lo, hi) if res.is_best[s]]
        chosen_rows = [s for s in best_rows if res.chosen[s]]
        yield (
            t.prefixes[i],
            tuple(t.names[s] for s in best_rows),
            t.adv[chosen_rows],
            [t.names[s] for s in chosen_rows],
            int(res.min_igp[i]),
            t.entries[chosen_rows[0]],
        )
