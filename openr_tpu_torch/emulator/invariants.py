"""Post-quiescence cluster invariant checker for the emulator (the port's
copy of `openr_tpu/emulator/invariants.py`).

Six invariant classes over a quiesced Cluster (storm over, rate faults
off, structural faults healed):

  1. **KvStore consistency**: every node's KvStoreDb in an area is
     key/version/originator/hash-identical.
  2. **FIB/oracle parity**: every node's programmed FIB equals a fresh
     from-scratch solve of the port's host oracle over that node's own
     LinkState, whatever backend the node solved on (the card, its CPU
     twins or the oracle), which catches stale reuse of the
     dirty-scoped caches after fault-driven invalidation.
  3. **No stuck state**: no pending publication backlogs, flood queues
     or desired-vs-programmed FIB deltas; no lingering retry backoffs;
     all peers synced with live sessions.
  4. **Counter sanity**: the rebuild-path counters sum to the rebuild
     count, peer add/remove deltas match the live peer set, no residual
     failure streaks.
  5. **Bounded seam depth**: no policied messaging queue's depth
     watermark exceeded its configured cap.
  6. **Work proportionality**: once the work ledger is marked warm,
     every delta-proportional stage keeps each steady round's touched
     count within k*delta + floor; a breach lands a
     ``work.ratio_breach`` flight-recorder event on every node.

`wait_quiescent` polls until all of these hold on two consecutive
checks, or raises with the chaos replay hint and the flight-recorder
dump directory.
"""

from __future__ import annotations

import asyncio
import json
import os
import tempfile
import time
from dataclasses import dataclass

from openr_tpu_torch.decision.decision import merge_area_ribs
from openr_tpu_torch.decision.oracle import compute_routes as oracle_compute_routes

_DETAIL_CAP = 3  # sample size for mismatch listings


@dataclass(frozen=True)
class Violation:
    kind: str  # e.g. "kvstore.divergence", "fib.oracle_mismatch"
    node: str | None
    detail: str

    def __str__(self) -> str:
        where = f"[{self.node}] " if self.node else ""
        return f"{self.kind}: {where}{self.detail}"


# ------------------------------------------------------- 1. kvstore identical


def check_kvstore_consistency(cluster) -> list[Violation]:
    """All live nodes in an area hold the identical key/version/hash set
    (TTL countdowns are per-store clocks and excluded by design)."""
    out: list[Violation] = []
    areas: set[str] = set()
    for node in cluster.nodes.values():
        areas.update(node.kvstore.dbs)
    for area in sorted(areas):
        digests: dict[str, dict] = {}
        for name, node in cluster.nodes.items():
            db = node.kvstore.dbs.get(area)
            if db is None:
                continue
            digests[name] = {
                k: (v.version, v.originator_id, v.with_hash().hash)
                for k, v in db.kv.items()
            }
        if not digests:
            continue
        ref_name = min(digests)
        ref = digests[ref_name]
        for name, d in digests.items():
            if d == ref:
                continue
            diff_keys = sorted(
                k
                for k in set(d) | set(ref)
                if d.get(k) != ref.get(k)
            )
            out.append(
                Violation(
                    "kvstore.divergence",
                    name,
                    f"area {area}: {len(diff_keys)} keys differ from "
                    f"{ref_name}'s store, e.g. {diff_keys[:_DETAIL_CAP]}",
                )
            )
    return out


# ------------------------------------------------------ 2. fib == oracle rib


def check_fib_oracle_parity(cluster) -> list[Violation]:
    """Each node's programmed FIB must equal a from-scratch host-oracle
    rebuild over that node's own LSDB, whatever the node's own backend
    and every incremental or dirty-scoped cache the live pipeline used.
    Nodes with an installed RibPolicy are skipped (the policy mutates
    routes after the solve)."""
    out: list[Violation] = []
    for name, node in cluster.nodes.items():
        dec = node.decision
        if dec.rib_policy is not None:
            continue
        dcfg = node.config.node.decision
        link_states = dec.link_states  # property: drains pending pubs
        prefix_states = dec.prefix_states
        per_area = {
            a: oracle_compute_routes(
                link_states[a].snapshot(),
                prefix_states[a].snapshot(),
                name,
                enable_lfa=dcfg.enable_lfa,
                ksp_k=dcfg.ksp_paths,
            )
            for a in link_states
        }
        want = merge_area_ribs(per_area, name)
        want_u = {
            p: e.to_unicast_route() for p, e in want.unicast_routes.items()
        }
        want_m = {
            l: e.to_mpls_route() for l, e in want.mpls_routes.items()
        }
        got_u = node.fib.programmed_unicast
        got_m = node.fib.programmed_mpls
        if got_u != want_u:
            diff = sorted(
                str(p)
                for p in set(got_u) | set(want_u)
                if got_u.get(p) != want_u.get(p)
            )
            out.append(
                Violation(
                    "fib.oracle_mismatch",
                    name,
                    f"{len(diff)} unicast routes differ from the "
                    f"host-oracle rebuild, e.g. {diff[:_DETAIL_CAP]}",
                )
            )
        if got_m != want_m:
            diff_l = sorted(
                l
                for l in set(got_m) | set(want_m)
                if got_m.get(l) != want_m.get(l)
            )
            out.append(
                Violation(
                    "fib.oracle_mismatch_mpls",
                    name,
                    f"{len(diff_l)} mpls routes differ from the "
                    f"host-oracle rebuild, e.g. {diff_l[:_DETAIL_CAP]}",
                )
            )
    return out


# ----------------------------------------------------------- 3. nothing stuck


def check_no_stuck_state(cluster) -> list[Violation]:
    out: list[Violation] = []
    for name, node in cluster.nodes.items():
        if not node.initialized:
            out.append(
                Violation("node.uninitialized", name, "init gates not passed")
            )
        dec = node.decision
        if dec._pending_kvs or dec.debounce.pending:
            out.append(
                Violation(
                    "decision.pending",
                    name,
                    f"{len(dec._pending_kvs)} buffered kvs, "
                    f"debounce pending={dec.debounce.pending}",
                )
            )
        pc = node.fib.pending_changes()
        if not pc["converged"]:
            out.append(
                Violation(
                    "fib.unconverged",
                    name,
                    f"{pc['pending']} desired-vs-programmed deltas, "
                    f"e.g. {pc['stale'][:_DETAIL_CAP]}",
                )
            )
        fib_cfg = node.config.node.fib
        if node.fib.backoff.current_ms >= fib_cfg.max_retry_ms:
            out.append(
                Violation(
                    "fib.backoff_saturated",
                    name,
                    f"program backoff pinned at {fib_cfg.max_retry_ms} ms",
                )
            )
        elif node.fib.backoff.has_error:
            out.append(
                Violation(
                    "fib.backoff_pending",
                    name,
                    f"retry backoff at {node.fib.backoff.current_ms} ms",
                )
            )
        for (area, pname), peer in node.kvstore.peers.items():
            if not peer.synced:
                out.append(
                    Violation(
                        "kvstore.peer_unsynced",
                        name,
                        f"peer {pname} (area {area}) not synced",
                    )
                )
            if peer.session is None:
                out.append(
                    Violation(
                        "kvstore.peer_sessionless",
                        name,
                        f"peer {pname} (area {area}) has no session",
                    )
                )
            if peer.pending_keys or peer.pending_expired:
                out.append(
                    Violation(
                        "kvstore.peer_flood_backlog",
                        name,
                        f"peer {pname}: {len(peer.pending_keys)} keys / "
                        f"{len(peer.pending_expired)} expiries queued",
                    )
                )
            if peer.backoff.has_error:
                out.append(
                    Violation(
                        "kvstore.peer_backoff",
                        name,
                        f"peer {pname} sync backoff at "
                        f"{peer.backoff.current_ms} ms",
                    )
                )
    return out


# ---------------------------------------------------------- 4. counter sanity


def check_counter_sanity(cluster) -> list[Violation]:
    out: list[Violation] = []
    for name, node in cluster.nodes.items():
        c = node.counters
        full = c.get("decision.rebuild.full")
        pfx = c.get("decision.rebuild.prefix_only")
        delta = c.get("decision.rebuild.topo_delta")
        runs = c.get("decision.spf_runs")
        if full + pfx + delta != runs:
            out.append(
                Violation(
                    "counters.rebuild_sum",
                    name,
                    f"rebuild.full({full}) + rebuild.prefix_only({pfx}) "
                    f"+ rebuild.topo_delta({delta}) != spf_runs({runs})",
                )
            )
        live_peers = len(node.kvstore.peers)
        added = c.get("kvstore.peers_added")
        removed = c.get("kvstore.peers_removed")
        if added - removed != live_peers:
            out.append(
                Violation(
                    "counters.peer_ledger",
                    name,
                    f"peers_added({added}) - peers_removed({removed}) "
                    f"!= live peers({live_peers})",
                )
            )
        streak = c.get("fib.program_fail_streak")
        if streak:
            out.append(
                Violation(
                    "counters.fib_fail_streak",
                    name,
                    f"fib.program_fail_streak={streak} after quiescence",
                )
            )
    return out


# ------------------------------------------------------ 5. bounded seam depth


def check_queue_bounds(cluster) -> list[Violation]:
    """Overload-control invariant: no policied inter-module queue's depth
    WATERMARK may have exceeded the node's configured cap — the overflow
    policies (coalesce / shed-oldest / block, `messaging/`) must have
    absorbed every burst at the bound. A node built with
    `messaging.enforce_bounds=False` keeps its cap configured but its
    queues unbounded, so this check failing on it is the control case
    that proves the watermark detector works."""
    out: list[Violation] = []
    for name, node in cluster.nodes.items():
        cap = node.config.node.messaging.queue_maxsize
        if cap <= 0:
            continue
        for key, q in getattr(node, "queues", {}).items():
            if q.policy is None:
                continue  # control-event seams are unbounded by design
            for r in q.readers:
                # COALESCE deliberately admits unmergeable items past
                # the bound, one per counted overflow — those admissions
                # are designed behavior, not a breach
                if r.highwater > cap + r.overflow:
                    out.append(
                        Violation(
                            "queue.depth_breach",
                            name,
                            f"{key} reader {r.name}: watermark "
                            f"{r.highwater} > cap {cap} "
                            f"(+{r.overflow} counted overflow)",
                        )
                    )
    return out


# ------------------------------------------------- 6. work proportionality


#: stages that are super-delta by design and exempt from the
#: proportionality gate: spf_full is O(area), spf_warm O(region),
#: merge_full the fallback fold (O(routes)), full_sync O(store),
#: fib_resync the full-table reprogram, and under topology dirt the
#: route diff is O(tables) (a metric change can move any route).
#: `merge` and `redistribute` are delta-native and not exempt.
WORK_EXEMPT_STAGES = (
    "spf_full",
    "spf_warm",
    "merge_full",
    "full_sync",
    "fib_resync",
    "diff",
)


def check_work_ratios(cluster) -> list[Violation]:
    """Delta-proportionality gate over the process-global work ledger
    (`monitor/work_ledger.py`): once a soak round has marked the
    ledger warm, no delta-proportional stage (dirt / election / assembly
    / merge / fib / redistribute) may have a steady round whose
    touched-entity count exceeds
    k*delta + floor. Inactive until ``mark_warm()`` — a single-shot
    ``assert_invariants`` on a fresh cluster never trips on warmup work.
    The ledger is per-process, so in the emulator a breach is a
    cluster-wide fact (node=None); the flight-recorder event lands on
    every node so any post-mortem dump carries it."""
    from openr_tpu_torch.monitor import work_ledger

    if not work_ledger.ledger().warm_marked:
        return []
    out: list[Violation] = []
    for v in work_ledger.steady_violations(exempt=WORK_EXEMPT_STAGES):
        out.append(
            Violation(
                "work.ratio_breach",
                None,
                f"stage {v['stage']}: worst steady round touched "
                f"{v['touched']} entities for delta {v['delta']} "
                f"(ratio {v['ratio']:.1f}, bound {v['bound']:.0f}) — "
                "a full-table walk crept into a delta-proportional stage",
            )
        )
        for node in cluster.nodes.values():
            fr = getattr(node.counters, "flight_record", None)
            if fr is not None:
                fr(
                    "work.ratio_breach",
                    stage=v["stage"],
                    touched=v["touched"],
                    delta=v["delta"],
                    ratio=round(v["ratio"], 2),
                    bound=v["bound"],
                )
    return out


# ------------------------------------------------- flight-recorder dumps


def dump_flight_recorders(
    cluster, violations=None, label: str = "invariant-failure"
) -> str | None:
    """Write every involved node's flight-recorder ring (plus its raw
    counter snapshot) as one JSON file per node under a fresh dump
    directory, and return that directory — the post-mortem artifact a
    failing soak attaches next to its replay seed.

    "Involved" = the nodes the violations name; violations that name no
    node (cluster-wide checks) widen the dump to every live node. Nodes
    without a recorder (bare clusters built outside OpenrNode) are
    skipped; returns None when nothing was dumpable."""
    names = sorted({v.node for v in (violations or []) if v.node})
    if not names or any(v.node is None for v in (violations or [])):
        names = sorted(cluster.nodes)
    targets = [
        (n, cluster.nodes[n])
        for n in names
        if n in cluster.nodes
        and getattr(cluster.nodes[n], "flight", None) is not None
    ]
    if not targets:
        return None
    dump_dir = tempfile.mkdtemp(prefix="openr-flight-")
    for name, node in targets:
        payload = {
            "node": name,
            "label": label,
            "wrote_at": time.time(),
            "violations": [
                str(v) for v in (violations or []) if v.node in (name, None)
            ],
            "events": node.flight.dump(),
            # raw counters only (no expanded stat percentiles — they
            # triple the file for no post-mortem value)
            "counters": dict(node.counters.counters),
        }
        path = os.path.join(dump_dir, f"{name}.json")
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, default=str)
    return dump_dir


def _flight_hint(cluster, violations, label: str) -> str:
    try:
        d = dump_flight_recorders(cluster, violations, label=label)
    except Exception:  # noqa: BLE001 - the dump must never mask the failure
        return ""
    return f"\nflight-recorder dumps: {d}" if d else ""


# -------------------------------------------------------------- entry points


def check_cluster(cluster) -> list[Violation]:
    """All six invariant classes; cheap checks first so the poll loop
    fails fast while the cluster is still settling."""
    out = check_no_stuck_state(cluster)
    out += check_queue_bounds(cluster)
    out += check_work_ratios(cluster)
    out += check_kvstore_consistency(cluster)
    out += check_counter_sanity(cluster)
    out += check_fib_oracle_parity(cluster)
    return out


def assert_invariants(cluster, context: str = "") -> None:
    """Single-shot assertion; `context` (e.g. the ChaosPlan replay hint)
    is embedded in the failure message so any failing run is replayable
    from its seed."""
    violations = check_cluster(cluster)
    if violations:
        hint = f" (replay: {context})" if context else ""
        lines = "\n  ".join(str(v) for v in violations)
        flight = _flight_hint(cluster, violations, label=context or "assert")
        raise AssertionError(
            f"{len(violations)} cluster invariant violation(s){hint}:\n"
            f"  {lines}{flight}"
        )


async def wait_quiescent(
    cluster,
    timeout_s: float = 30.0,
    poll_s: float = 0.25,
    context: str = "",
) -> None:
    """Poll until the cluster converges AND all invariants hold on two
    consecutive checks; on timeout raise with the last violations and
    the replay context. This is the post-storm gate every chaos soak
    ends with."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout_s
    clean = 0
    last: list[Violation] = []
    while True:
        if not cluster.converged():
            last = [
                Violation(
                    "cluster.unconverged",
                    None,
                    "cluster.converged() is False",
                )
            ]
            clean = 0
        else:
            last = check_cluster(cluster)
            clean = 0 if last else clean + 1
            if clean >= 2:
                return
        if loop.time() >= deadline:
            hint = f" (replay: {context})" if context else ""
            lines = "\n  ".join(str(v) for v in last[:8])
            flight = _flight_hint(
                cluster, last, label=context or "quiesce-timeout"
            )
            raise AssertionError(
                f"cluster failed to quiesce within {timeout_s:.0f}s"
                f"{hint}; last violations:\n  {lines}{flight}"
            )
        await asyncio.sleep(poll_s)
