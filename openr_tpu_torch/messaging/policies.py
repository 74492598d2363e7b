"""Coalesce functions for the bounded messaging seams (the port's copy
of `openr_tpu/messaging/policies.py`).

The ``coalesce`` overflow policy needs a merge for each mergeable delta
type. Both merges build a new object: the tail item is replicated to
every reader of a ReplicateQueue, so mutating it in one reader's backlog
would corrupt the others'.

A node's publication stream is emitted in merge-acceptance order, so for
any key the later publication carries a value at least as new: "newest
wins" at the tail is the version-dominant merge. Route updates compose
as Fib folds them: a FULL_SYNC resets the state, deltas apply over it.
"""

from __future__ import annotations

from openr_tpu_torch.types.kvstore import Publication
from openr_tpu_torch.types.routes import RouteUpdate, RouteUpdateType

# traces kept on a coalesced route update: an overload burst must not
# grow the trace list
_PERF_CAP = 64


def coalesce_publications(
    tail: Publication, new: Publication
) -> Publication | None:
    """Merge ``new`` into a copy of ``tail``; ``None`` when unmergeable
    (different areas: the caller admits the item past the bound and
    counts the overflow)."""
    if tail.area != new.area:
        return None
    kv = dict(tail.key_vals)
    expired = dict.fromkeys(tail.expired_keys)  # ordered set
    for k, v in new.key_vals.items():
        kv[k] = v
        expired.pop(k, None)  # re-advertised after expiry: alive again
    for k in new.expired_keys:
        kv.pop(k, None)  # expired after an update: dead is the final word
        expired[k] = None
    node_ids = list(tail.node_ids)
    node_ids.extend(n for n in new.node_ids if n not in node_ids)
    pe = tail.perf_events
    if new.perf_events is not None:
        pe = (
            new.perf_events.copy()
            if pe is None
            else pe.merge(new.perf_events)  # merge() returns a new trace
        )
    return Publication(
        area=tail.area,
        key_vals=kv,
        expired_keys=list(expired),
        node_ids=node_ids,
        perf_events=pe,
    )


def coalesce_route_updates(
    tail: RouteUpdate, new: RouteUpdate
) -> RouteUpdate:
    """Merge ``new`` into a copy of ``tail`` (always succeeds).

    A FULL_SYNC ``new`` supersedes everything pending; otherwise the
    delta folds over the tail as Fib would fold the two in sequence, and
    the merged update keeps the tail's type (a pending FULL_SYNC stays a
    FULL_SYNC with the delta applied)."""
    perf = list(tail.perf_events)
    for pe in new.perf_events:
        if len(perf) >= _PERF_CAP:
            break
        perf.append(pe)
    if new.type == RouteUpdateType.FULL_SYNC:
        return RouteUpdate(
            type=RouteUpdateType.FULL_SYNC,
            unicast_to_update=dict(new.unicast_to_update),
            mpls_to_update=dict(new.mpls_to_update),
            perf_events=perf,
        )
    u_upd = dict(tail.unicast_to_update)
    u_del = dict.fromkeys(tail.unicast_to_delete)
    m_upd = dict(tail.mpls_to_update)
    m_del = dict.fromkeys(tail.mpls_to_delete)
    for p, e in new.unicast_to_update.items():
        u_upd[p] = e
        u_del.pop(p, None)
    for p in new.unicast_to_delete:
        u_upd.pop(p, None)
        if tail.type != RouteUpdateType.FULL_SYNC:
            u_del[p] = None
    for label, e in new.mpls_to_update.items():
        m_upd[label] = e
        m_del.pop(label, None)
    for label in new.mpls_to_delete:
        m_upd.pop(label, None)
        if tail.type != RouteUpdateType.FULL_SYNC:
            m_del[label] = None
    return RouteUpdate(
        type=tail.type,
        unicast_to_update=u_upd,
        unicast_to_delete=list(u_del),
        mpls_to_update=m_upd,
        mpls_to_delete=list(m_del),
        perf_events=perf,
    )
