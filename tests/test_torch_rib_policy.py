"""The port's policy engines (`openr_tpu_torch.policy`) and the port
Decision's RibPolicy, held against the JAX package's on the CPU.

* The cases of `tests/test_policy.py` run on both packages and give equal
  results. The RibPolicy cases start from each package's own RIB of the
  same LSDB (the JAX oracle's, the port's `TorchSpfSolver` on the CPU),
  and the policy-applied RIBs are equal across the packages too.
  (`test_origination_policy_wired_through_config` drives the JAX
  package's emulator, which the port does not have yet.)
* A Decision behind a KvStore in each package, as
  `tests/test_torch_decision_module.py` pairs the Decisions: a fabric
  store holds every node's keys and floods them (binary codec) into the
  node's store, whose publications feed its Decision. Both are fed the
  same full sync, flaps, prefix changes and TTL expiries; a RibPolicy is
  installed, flapped under, removed, re-installed and left to expire.
  RIBs, RouteUpdates and rebuild paths are equal every round, and the
  port's RIB equals a fresh solver's (with the policy applied to it while
  one is installed): a route the policy dropped comes back, and no
  weight outlives it.
"""

import asyncio
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import openr_tpu.kvstore as rkvs
import openr_tpu.kvstore.kvstore as rkvstore
import openr_tpu.policy as rpolicy
import openr_tpu.policy.policy as rpolicy_mod
import openr_tpu.types.kvstore as rkv
import openr_tpu.types.network as ref_network
import openr_tpu.types.routes as ref_routes
import openr_tpu.types.topology as ref_topology
from openr_tpu.common.constants import DEFAULT_AREA, prefix_key
from openr_tpu.config import AreaConfig as RefAreaConfig
from openr_tpu.config import Config as RefConfig
from openr_tpu.config import DecisionConfig as RefDecisionConfig
from openr_tpu.config import NodeConfig as RefNodeConfig
from openr_tpu.config.config import RouteMapTermConfig
from openr_tpu.decision import decision as ref_decision
from openr_tpu.decision.linkstate import LinkState as RefLinkState
from openr_tpu.decision.linkstate import PrefixState as RefPrefixState
from openr_tpu.decision.oracle import compute_routes as ref_compute_routes
from openr_tpu.messaging import ReplicateQueue as RefQueue
from openr_tpu.monitor import Counters as RefCounters
from openr_tpu.types import serde as rserde
from openr_tpu.utils import topogen
from openr_tpu_torch import config as pconfig
from openr_tpu_torch import kvstore as pkvs
from openr_tpu_torch import policy as ppolicy
from openr_tpu_torch.decision import decision as pdecision
from openr_tpu_torch.decision import hook
from openr_tpu_torch.decision.linkstate import LinkState, PrefixState
from openr_tpu_torch.decision.spf_backend import TorchSpfSolver
from openr_tpu_torch.kvstore import kvstore as pkvstore
from openr_tpu_torch.messaging import ReplicateQueue
from openr_tpu_torch.monitor import Counters
from openr_tpu_torch.policy import policy as ppolicy_mod
from openr_tpu_torch.types import kvstore as pkv
from openr_tpu_torch.types import network as pnetwork
from openr_tpu_torch.types import serde as pserde
from openr_tpu_torch.types import topology as ptopology
from tests.test_rebuild_scoped import adj_pub, prefix_pub
from tests.test_torch_decision_module import port_pub

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)

PKGS = {
    "jax": dict(policy=rpolicy, policy_mod=rpolicy_mod,
                IpPrefix=ref_network.IpPrefix,
                PrefixEntry=ref_topology.PrefixEntry,
                PrefixMetrics=ref_topology.PrefixMetrics,
                PrefixDatabase=ref_topology.PrefixDatabase, serde=rserde),
    "port": dict(policy=ppolicy, policy_mod=ppolicy_mod,
                 IpPrefix=pnetwork.IpPrefix,
                 PrefixEntry=ptopology.PrefixEntry,
                 PrefixMetrics=ptopology.PrefixMetrics,
                 PrefixDatabase=ptopology.PrefixDatabase, serde=pserde),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return request.param, PKGS[request.param]


def entry(p, pfx, tags=(), pp=1000, sp=100, dist=0):
    return p["PrefixEntry"](
        prefix=p["IpPrefix"].make(pfx), tags=tuple(tags),
        metrics=p["PrefixMetrics"](path_preference=pp, source_preference=sp,
                                   distance=dist))


def rib_with_ecmp(name):
    """`tests/test_policy.py`'s ring(4) RIB at node-0, from the package's
    own solver."""
    p = PKGS[name]
    db = p["PrefixDatabase"](this_node_name="node-2", prefix_entries=(
        entry(p, "10.9.0.0/16", tags=["anycast"]),))
    if name == "jax":
        adj_dbs, _ = topogen.ring(4)
        ls, ps = RefLinkState(), RefPrefixState()
        for a in adj_dbs:
            ls.update_adjacency_db(a)
        ps.update_prefix_db(db)
        return ref_compute_routes(ls, ps, "node-0")
    from openr_tpu_torch.utils import topogen as ptopogen

    adj_dbs, _ = ptopogen.ring(4)
    ls, ps = LinkState(), PrefixState()
    for a in adj_dbs:
        ls.update_adjacency_db(a)
    ps.update_prefix_db(db)
    return TorchSpfSolver(device="cpu").compute_routes(ls, ps, "node-0")


# ---- origination policy (tests/test_policy.py) ----------------------------


def test_policy_statement_tag_match_and_transform(pkg):
    _n, p = pkg
    st = p["policy"].PolicyStatement(
        name="bump-bgp", match_tags=("bgp",), set_path_preference=700,
        add_tags=("redistributed",))
    out = st.apply(entry(p, "10.0.0.0/24", tags=["bgp"]))
    assert out.metrics.path_preference == 700
    assert "redistributed" in out.tags
    assert not st.matches(entry(p, "10.0.0.0/24", tags=["ospf"]))


def test_policy_prefix_match_subnet(pkg):
    _n, p = pkg
    P = p["policy"]
    mgr = P.PolicyManager(statements=(P.PolicyStatement(
        match_prefixes=("10.0.0.0/8",), action_accept=False),))
    assert mgr.apply(entry(p, "10.1.2.0/24")) is None
    assert mgr.apply(entry(p, "192.168.0.0/24")) is not None


def test_policy_first_match_wins(pkg):
    _n, p = pkg
    P = p["policy"]
    mgr = P.PolicyManager(statements=(
        P.PolicyStatement(match_tags=("a",), set_source_preference=10),
        P.PolicyStatement(match_tags=("a", "b"), set_source_preference=99)))
    out = mgr.apply(entry(p, "10.0.0.0/24", tags=["a", "b"]))
    assert out.metrics.source_preference == 10


def test_policy_default_deny(pkg):
    _n, p = pkg
    mgr = p["policy"].PolicyManager(statements=(), default_accept=False)
    assert mgr.apply(entry(p, "10.0.0.0/24")) is None


def test_route_map_ordered_first_match_wins_and_shadowing(pkg):
    _n, p = pkg
    P = p["policy"]
    rm = P.RouteMap(terms=(
        P.RouteMapTerm(seq=20, action="deny", match_tags_any=("blue",)),
        P.RouteMapTerm(seq=10, action="permit",
                       match_tags_all=("blue", "prod"),
                       add_tags=("matched-10",))))
    got = rm.apply(entry(p, "10.1.0.0/24", tags=("blue", "prod")))
    assert got is not None and "matched-10" in got.tags
    assert rm.apply(entry(p, "10.1.0.0/24", tags=("blue",))) is None
    assert rm.apply(entry(p, "10.1.0.0/24", tags=("green",))) is None
    rm2 = P.RouteMap(terms=rm.terms, default_accept=True)
    assert (rm2.apply(entry(p, "10.1.0.0/24", tags=("green",)))
            == entry(p, "10.1.0.0/24", tags=("green",)))


def test_route_map_prefix_ge_le_bounds(pkg):
    _n, p = pkg
    P = p["policy"]
    rm = P.RouteMap(terms=(P.RouteMapTerm(
        seq=5, match_prefixes=(("10.0.0.0/8", 24, 28),)),),
        default_accept=False)
    assert rm.apply(entry(p, "10.1.2.0/24")) is not None
    assert rm.apply(entry(p, "10.1.2.0/28")) is not None
    assert rm.apply(entry(p, "10.1.0.0/16")) is None
    assert rm.apply(entry(p, "10.1.2.0/30")) is None
    assert rm.apply(entry(p, "192.168.0.0/24")) is None


def test_route_map_tag_set_algebra(pkg):
    _n, p = pkg
    P = p["policy"]
    rm = P.RouteMap(terms=(P.RouteMapTerm(
        seq=1, set_tags=("base",), add_tags=("x", "y"),
        remove_tags=("y", "nope"), set_path_preference=7,
        set_distance_increment=3),))
    got = rm.apply(entry(p, "10.1.0.0/24", tags=("old-a", "old-b"), dist=10))
    assert got.tags == ("base", "x")
    assert got.metrics.path_preference == 7
    assert got.metrics.distance == 13


def test_route_map_duplicate_seq_rejected(pkg):
    _n, p = pkg
    P = p["policy"]
    with pytest.raises(ValueError):
        P.RouteMap(terms=(P.RouteMapTerm(seq=1), P.RouteMapTerm(seq=1)))
    with pytest.raises(ValueError):
        P.RouteMap(terms=(P.RouteMapTerm(seq=1, action="accept"),))


def test_route_map_at_origination_via_prefix_manager_seam(pkg):
    _n, p = pkg
    P = p["policy"]
    pm = P.PolicyManager(route_map=P.RouteMap(terms=(
        P.RouteMapTerm(seq=10, action="deny", match_tags_any=("no-export",)),
        P.RouteMapTerm(seq=20, action="permit", add_tags=("exported",)))))
    assert pm.apply(entry(p, "10.1.0.0/24", tags=("no-export",))) is None
    got = pm.apply(entry(p, "10.1.0.0/24", tags=("ok",)))
    assert got is not None and "exported" in got.tags


def test_route_map_config_assembly(pkg):
    _n, p = pkg
    pm = p["policy_mod"]
    assert pm.parse_prefix_match("10.0.0.0/8 ge 24 le 28") == (
        "10.0.0.0/8", 24, 28)
    assert pm.parse_prefix_match("10.0.0.0/8") == ("10.0.0.0/8", 0, 0)
    for bad in ("10.0.0.0/8 ge", "10.0.0.0/8 ge 28 le 24"):
        with pytest.raises(ValueError):
            pm.parse_prefix_match(bad)
    rm = pm.build_route_map((RouteMapTermConfig(
        seq=10, match_prefixes=("10.0.0.0/8 ge 24",), add_tags=("t",)),),
        default_accept=False)
    assert rm.apply(entry(p, "10.5.5.0/24")).tags == ("t",)
    assert rm.apply(entry(p, "10.0.0.0/8")) is None


@pytest.mark.parametrize("trial", range(100))
def test_route_map_random_terms_agree(trial):
    """Seeded random route-maps and entries (`tests/test_policy.py`'s
    property case): the two packages answer alike."""
    rng = np.random.default_rng(20260521 + trial)
    tags = ["a", "b", "c", "d"]
    pfx = [("10.0.0.0/8", 0, 0), ("10.1.0.0/16", 20, 28),
           ("192.168.0.0/16", 0, 24)]

    def pick(seq, k_max):
        return tuple(str(x) for x in rng.choice(
            seq, size=int(rng.integers(0, k_max + 1)), replace=False))

    terms = []
    for i in range(int(rng.integers(0, 6))):
        terms.append(dict(
            seq=(i + 1) * 10, action=str(rng.choice(["permit", "deny"])),
            match_tags_any=pick(tags, 2), match_tags_all=pick(tags, 1),
            match_not_tags=pick(tags, 1),
            match_prefixes=tuple(pfx[j] for j in rng.choice(
                3, size=int(rng.integers(0, 3)), replace=False)),
            add_tags=pick(tags, 1), remove_tags=pick(tags, 1),
            set_distance_increment=[None, 1, 5][int(rng.integers(0, 3))]))
    default = bool(rng.random() < 0.5)
    e = dict(pfx=str(rng.choice(["10.1.2.0/24", "10.1.0.0/16", "10.2.3.0/26",
                                 "192.168.5.0/24", "192.168.0.0/18",
                                 "172.16.0.0/12"])),
             tags=pick(tags, 3), dist=int(rng.integers(0, 6)))
    got = {}
    for name, p in PKGS.items():
        P = p["policy"]
        rm = P.RouteMap(terms=tuple(P.RouteMapTerm(**t) for t in terms),
                        default_accept=default)
        out = rm.apply(entry(p, e["pfx"], tags=e["tags"], dist=e["dist"]))
        got[name] = None if out is None else p["serde"].to_wire(out)
    assert got["jax"] == got["port"]


# ---- RibPolicy (tests/test_policy.py) --------------------------------------


def rib_bytes(name, rdb):
    return PKGS[name]["serde"].to_wire(rdb)


def both_ribs(apply):
    """Each package's ring RIB with `apply(name, rdb)` run on it; the two
    must be equal."""
    out = {}
    for name in PKGS:
        rdb = rib_with_ecmp(name)
        res = apply(name, rdb)
        out[name] = (rdb, res)
    assert rib_bytes("jax", out["jax"][0]) == rib_bytes("port", out["port"][0])
    assert out["jax"][1] == out["port"][1]
    return out


def policy(name, ttl=300.0, **st):
    P = PKGS[name]["policy"]
    return P.RibPolicy(statements=(P.RibPolicyStatement(**st),), ttl_secs=ttl)


def test_rib_policy_neighbor_weights():
    def apply(name, rdb):
        p = PKGS[name]["IpPrefix"].make("10.9.0.0/16")
        assert {nh.neighbor_node for nh in rdb.unicast_routes[p].nexthops} \
            == {"node-1", "node-3"}
        n = policy(name, match_prefixes=("10.9.0.0/16",),
                   neighbor_to_weight={"node-1": 4, "node-3": 2}).apply(rdb)
        return n, {nh.neighbor_node: nh.weight
                   for nh in rdb.unicast_routes[p].nexthops}

    out = both_ribs(apply)
    assert out["port"][1] == (1, {"node-1": 2, "node-3": 1})


def test_rib_policy_zero_weight_drops_nexthop():
    def apply(name, rdb):
        policy(name, match_tags=("anycast",), neighbor_to_weight={"node-1": 0},
               default_weight=1).apply(rdb)
        p = PKGS[name]["IpPrefix"].make("10.9.0.0/16")
        return {nh.neighbor_node for nh in rdb.unicast_routes[p].nexthops}

    assert both_ribs(apply)["port"][1] == {"node-3"}


def test_rib_policy_all_zero_removes_route():
    def apply(name, rdb):
        policy(name, match_prefixes=("10.9.0.0/16",),
               default_weight=0).apply(rdb)
        return PKGS[name]["IpPrefix"].make("10.9.0.0/16") in rdb.unicast_routes

    assert both_ribs(apply)["port"][1] is False


def test_rib_policy_ttl_expiry():
    pols = {name: PKGS[name]["policy"].RibPolicy(statements=(), ttl_secs=0.01)
            for name in PKGS}
    time.sleep(0.02)

    def apply(name, rdb):
        assert pols[name].expired
        return pols[name].apply(rdb)

    assert both_ribs(apply)["port"][1] == 0


def test_rib_policy_nonmatching_untouched():
    def apply(name, rdb):
        n = policy(name, match_prefixes=("172.16.0.0/12",),
                   default_weight=7).apply(rdb)
        p = PKGS[name]["IpPrefix"].make("10.9.0.0/16")
        return n, [nh.weight for nh in rdb.unicast_routes[p].nexthops]

    assert both_ribs(apply)["port"][1] == (0, [0, 0])


def test_rib_policy_ttl_restamps_on_deserialize(pkg):
    _n, p = pkg
    pol = p["policy"].RibPolicy(statements=(), ttl_secs=300.0)
    raw = p["serde"].to_jsonable(pol)
    assert "_expires_at" not in raw
    got = p["serde"].from_jsonable(raw, p["policy"].RibPolicy)
    assert not got.expired
    assert got._expires_at - time.monotonic() > 299.0


def test_rib_policy_wire_bytes_agree():
    for name in PKGS:
        pol = policy(name, match_prefixes=("10.9.0.0/16",), match_tags=("x",),
                     area_to_weight={"0": 2}, neighbor_to_weight={"n": 0})
        PKGS[name]["bytes"] = (PKGS[name]["serde"].to_wire(pol),
                               PKGS[name]["serde"].to_wire_bin(pol))
    assert PKGS["jax"].pop("bytes") == PKGS["port"].pop("bytes")


# ---- the Decision's RibPolicy behind a KvStore -----------------------------

ME = "node-12"  # a ToR of fat_tree(4): two uplinks, ECMP to other pods
# debounce windows no round outlasts: every rebuild here is driven by
# hand, so that both Decisions rebuild over the same publications
SLOW_DEBOUNCE = dict(debounce_min_ms=600_000, debounce_max_ms=600_000)


class Side:
    """One package's fabric store F, node store N and Decision at ME:
    keys set on F flood into N, whose publications feed the Decision."""

    def __init__(self, name: str):
        self.name = name
        jax = name == "jax"
        kvs, kvmod, kv = ((rkvs, rkvstore, rkv) if jax
                          else (pkvs, pkvstore, pkv))
        self.kv, self.kvmod = kv, kvmod
        self.t = kvs.InProcKvTransport(codec="bin")
        if jax:
            cfg_f, cfg_n = RefConfig.default("fabric"), RefConfig.default(ME)
            q_f, q_n, counters = (RefQueue(name="f"), RefQueue(name="n"),
                                  RefCounters)
        else:
            cfg_f = pconfig.Config.default("fabric")
            cfg_n = pconfig.Config.default(ME)
            q_f, q_n, counters = (ReplicateQueue(name="f"),
                                  ReplicateQueue(name="n"), Counters)
        self.f = kvmod.KvStore(cfg_f, self.t, q_f, counters=counters())
        self.n = kvmod.KvStore(cfg_n, self.t, q_n, counters=counters())
        self.t.register("fabric", self.f)
        self.t.register(ME, self.n)
        reader = q_n.get_reader()
        if jax:
            cfg = RefConfig(RefNodeConfig(
                node_name=ME, areas=(RefAreaConfig(area_id=DEFAULT_AREA),),
                decision=RefDecisionConfig(native_rib="off", **SLOW_DEBOUNCE)))
            routes = RefQueue(name="routes")
            self.routes = routes.get_reader()
            self.d = ref_decision.Decision(
                cfg, reader, routes, solver="tpu", counters=RefCounters(),
                initial_sync_event=self.n.initial_sync_done)
        else:
            cfg = pconfig.Config(pconfig.NodeConfig(
                node_name=ME, decision=pconfig.DecisionConfig(
                    **SLOW_DEBOUNCE)))
            routes = ReplicateQueue(name="routes")
            self.routes = routes.get_reader()
            self.d = pdecision.Decision(
                cfg, reader, routes, counters=Counters(), device="cpu",
                initial_sync_event=self.n.initial_sync_done)

    async def start(self):
        for m in (self.f, self.n, self.d):
            await m.start()

    async def stop(self):
        for m in (self.d, self.n, self.f):
            await m.stop()

    def set_pub(self, pub, ttl=None):
        """Each key of a JAX-package publication set on F, as this
        package's Value with the same bytes."""
        for k, v in pub.key_vals.items():
            self.f.set_key(pub.area, k, self.kv.Value(
                version=v.version, originator_id=v.originator_id,
                value=v.value,
                ttl=self.kv.TTL_INFINITY if ttl is None else ttl,
            ).with_hash())


async def settle(cond, timeout=10.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, "did not settle"
        await asyncio.sleep(0.01)


def flap_pub(rng, adj_cur, names, version):
    name = names[int(rng.integers(0, len(names)))]
    db = adj_cur[name]
    adjs = list(db.adjacencies)
    k = int(rng.integers(0, len(adjs)))
    adjs[k] = dataclasses.replace(adjs[k], metric=int(rng.integers(1, 32)))
    adj_cur[name] = db = dataclasses.replace(db, adjacencies=tuple(adjs))
    return adj_pub([db], version=version)


def rib_policies(name, ttl):
    """The test's RibPolicy in one package: weights 3 / 1 on the two
    uplinks for pod 2's loopbacks, the second uplink's next hop dropped
    (weight 0) for pod 3's, and every next hop dropped for one loopback
    of pod 1 (the route removed)."""
    P = PKGS[name]["policy"]
    return P.RibPolicy(statements=(
        P.RibPolicyStatement(name="drop", match_prefixes=("10.0.0.14/32",),
                             default_weight=0),
        P.RibPolicyStatement(name="pod2",
                             match_prefixes=("10.0.0.16/31", "10.0.0.8/31"),
                             neighbor_to_weight={"node-4": 3, "node-5": 1}),
        P.RibPolicyStatement(name="pod3",
                             match_prefixes=("10.0.0.18/31", "10.0.0.10/31"),
                             neighbor_to_weight={"node-5": 0}),
    ), ttl_secs=ttl)


def test_decision_rib_policy_through_kvstore_matches_the_jax_pair():
    conv = hook.RouteConverter(ref_routes, ref_network,
                               topology_types=ref_topology)
    adj_dbs, prefix_dbs = topogen.fat_tree(4)
    names = [db.this_node_name for db in adj_dbs]
    rng = np.random.default_rng(20260522)
    adj_cur = {db.this_node_name: db for db in adj_dbs}

    async def body():
        sides = {name: Side(name) for name in ("jax", "port")}
        jax, port = sides["jax"], sides["port"]
        for s in sides.values():
            s.set_pub(adj_pub(adj_dbs))
            s.set_pub(prefix_pub(prefix_dbs))
            await s.start()
            s.n.add_peer_sync(s.kvmod.PeerSpec(node_name="fabric"))
            s.f.add_peer_sync(s.kvmod.PeerSpec(node_name=ME))
        want_keys = len(jax.f.dump(DEFAULT_AREA))
        assert want_keys == len(port.f.dump(DEFAULT_AREA)) == 40
        rounds = []

        async def step(tag, expect_policy):
            for s in sides.values():
                await settle(lambda s=s: s.n.dbs[DEFAULT_AREA].store_hash()
                             == s.f.dbs[DEFAULT_AREA].store_hash())
                await settle(lambda s=s: not s.d.pub_reader.qsize())
            await jax.d._rebuild_routes()
            await port.d._rebuild_routes()
            assert port.d._rebuild_path == jax.d._rebuild_path, tag
            got = conv.route_db(port.d.rib)
            assert got.unicast_routes == jax.d.rib.unicast_routes, tag
            assert got.mpls_routes == jax.d.rib.mpls_routes, tag
            u_jax = [jax.routes.get_nowait() for _ in
                     range(jax.routes.qsize())]
            u_port = [port.routes.get_nowait() for _ in
                      range(port.routes.qsize())]
            assert [conv.update(u) for u in u_port] == u_jax, tag
            assert (port.d.get_rib_policy() is not None) == expect_policy
            assert (jax.d.get_rib_policy() is not None) == expect_policy
            # the port's RIB is a fresh solve's, with the policy on it
            ls = port.d.link_states[DEFAULT_AREA]
            ps = port.d.prefix_states[DEFAULT_AREA]
            fresh = TorchSpfSolver(device="cpu").compute_routes(ls, ps, ME)
            if expect_policy:
                rib_policies("port", 300.0).apply(fresh)
            assert pserde.to_wire(port.d.rib) == pserde.to_wire(fresh), tag
            rounds.append((tag, port.d._rebuild_path, len(u_port)))

        await settle(lambda: port.n.initial_sync_done.is_set()
                     and jax.n.initial_sync_done.is_set())
        await step("full sync", False)
        version = 2
        for _ in range(4):  # flaps with no policy: warm or full rebuilds
            pub = flap_pub(rng, adj_cur, names, version)
            for s in sides.values():
                s.set_pub(pub)
            version += 1
            await step(f"flap {version}", False)
        for name, s in sides.items():
            s.d.set_rib_policy(rib_policies(name, 300.0))
        await step("policy installed", True)
        pfx = PKGS["port"]["IpPrefix"].make("10.0.0.14/32")
        assert pfx not in port.d.rib.unicast_routes
        weights = {nh.weight for e in port.d.rib.unicast_routes.values()
                   for nh in e.nexthops}
        assert weights >= {1, 3}, weights
        for _ in range(3):  # flaps under the policy: full path each
            pub = flap_pub(rng, adj_cur, names, version)
            for s in sides.values():
                s.set_pub(pub)
            version += 1
            await step(f"flap {version} under the policy", True)
            assert port.d._rebuild_path == "full"
        for s in sides.values():
            s.d.set_rib_policy(None)
        await step("policy removed", False)
        assert pfx in port.d.rib.unicast_routes
        assert {nh.weight for e in port.d.rib.unicast_routes.values()
                for nh in e.nexthops} == {0}
        pub = flap_pub(rng, adj_cur, names, version)
        for s in sides.values():
            s.set_pub(pub)
        version += 1
        await step("flap after the removal", False)
        # a TTL-expiring prefix key, then the policy re-installed with a
        # short TTL and left to expire
        short = prefix_pub([ref_topology.PrefixDatabase(
            this_node_name="node-17", prefix_entries=(
                ref_topology.PrefixEntry(prefix=ref_network.IpPrefix.make(
                    "10.77.0.0/24")),))], version=1)
        for s in sides.values():
            s.set_pub(short, ttl=1500)
        await step("short-lived prefix added", False)
        for name, s in sides.items():
            s.d.set_rib_policy(rib_policies(name, 0.5))
        await step("policy re-installed", True)
        key = prefix_key("node-17", DEFAULT_AREA, "10.77.0.0/24")
        await settle(lambda: all(
            s.d.get_rib_policy() is None
            and s.n.get_key(DEFAULT_AREA, key) is None
            for s in sides.values()), timeout=10.0)
        await step("policy and prefix expired", False)
        assert pfx in port.d.rib.unicast_routes
        assert PKGS["port"]["IpPrefix"].make("10.77.0.0/24") \
            not in port.d.rib.unicast_routes
        for s in sides.values():
            await s.stop()
        return rounds

    rounds = asyncio.run(body())
    assert len(rounds) == 14
    assert {p for _t, p, _n in rounds} >= {"full", "topo_delta"}


def test_policy_removed_while_a_rebuild_solves():
    """The policy is cleared on the event loop while the rebuild's solve
    is held in its worker thread: the rebuild applies the policy it read
    when it began and raises nothing, and the rebuild that the removal
    pokes solves without it."""
    adj_dbs, prefix_dbs = topogen.fat_tree(4)
    cfg = pconfig.Config(pconfig.NodeConfig(
        node_name=ME, decision=pconfig.DecisionConfig(**SLOW_DEBOUNCE)))
    routes = ReplicateQueue(name="routes")
    counters = Counters()
    d = pdecision.Decision(
        cfg, ReplicateQueue(name="pubs").get_reader(), routes,
        counters=counters, device="cpu")
    for pub in (adj_pub(adj_dbs), prefix_pub(prefix_dbs)):
        d.process_publication(port_pub(pub, traced=False))
    ls = d.link_states[DEFAULT_AREA]
    ps = d.prefix_states[DEFAULT_AREA]
    plain = TorchSpfSolver(device="cpu").compute_routes(ls, ps, ME)
    policied = TorchSpfSolver(device="cpu").compute_routes(ls, ps, ME)
    rib_policies("port", 300.0).apply(policied)
    assert pserde.to_wire(policied) != pserde.to_wire(plain)
    solving, release = threading.Event(), threading.Event()
    solve = d._compute_area

    def held_solve(*a, **k):
        solving.set()
        assert release.wait(10.0)
        return solve(*a, **k)

    async def body():
        await d.start()
        d.set_rib_policy(rib_policies("port", 300.0))
        d._compute_area = held_solve
        rebuild = asyncio.create_task(d._rebuild_routes())
        assert await asyncio.to_thread(solving.wait, 10.0)
        d.set_rib_policy(None)  # lands while the worker solves
        release.set()
        await rebuild
        assert d._rebuild_path == "full"
        assert pserde.to_wire(d.rib) == pserde.to_wire(policied)
        d._compute_area = solve
        await d._rebuild_routes()
        assert d._rebuild_path == "full"
        assert pserde.to_wire(d.rib) == pserde.to_wire(plain)
        await d.stop()

    asyncio.run(body())
    assert counters.get(f"{d.name}.task_exceptions") == 0
