"""In-process cluster of full OpenrNodes over mock I/O (the port's copy
of `openr_tpu/emulator/cluster.py`): the whole module graph per
emulated node, N nodes in one process and one asyncio loop, Spark over a
`MockIoHub`, KvStore peering over `InProcKvTransport`, routes into a
`MockFibHandler` each.

`device=` takes the place of the JAX package's `solver=`: None (the
default) means every node's Decision solves on the current CUDA card,
and raises without one; "cpu" the CPU twins. The host oracle is chosen
only through the node config (`decision.use_tpu_solver=False`, e.g.
with `node_config_transform`), never by default.

The Spark timers and the Decision debounce scale with the node count
(`scaled_spark`, `Cluster.build`), since all nodes share one host core.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field

from openr_tpu_torch.config import (
    Config,
    NodeConfig,
    OriginatedPrefix,
    SparkConfig,
    WatchdogConfig,
)
from openr_tpu_torch.kvstore import InProcKvTransport
from openr_tpu_torch.node import OpenrNode
from openr_tpu_torch.spark import MockIoHub

log = logging.getLogger(__name__)


# fast timers so integration tests converge in fractions of a second
FAST_SPARK = SparkConfig(
    hello_time_ms=60,
    fastinit_hello_time_ms=20,
    handshake_time_ms=20,
    keepalive_time_ms=40,
    hold_time_ms=400,
    graceful_restart_time_ms=1200,
)


def scaled_spark(n_nodes: int) -> SparkConfig:
    """Spark timers scaled to the emulation's CPU oversubscription.

    N routers share one host core, so hello/keepalive SERVICE latency
    grows with N: during a convergence wave every node rebuilds
    (~10-20 ms each, serialized), and with FAST_SPARK's 400 ms hold a
    ~100-node cluster's holds expire mid-wave → neighbors withdrawn →
    re-flood → more rebuilds → a self-sustaining flap storm (observed:
    route counts oscillating 98→56→99 forever at n=100 while n=81
    converged in 6 s — congestion collapse, not a protocol bug; real
    deployments tune hold timers to platform service latency for the
    same reason). Scale hold with N, keeping the small-cluster
    defaults untouched below 64 nodes."""
    if n_nodes <= 64:
        return FAST_SPARK
    f = FAST_SPARK  # single source of truth for the small-cluster base
    factor = n_nodes / 64
    return SparkConfig(
        hello_time_ms=int(f.hello_time_ms * factor),
        fastinit_hello_time_ms=int(f.fastinit_hello_time_ms * factor),
        handshake_time_ms=int(f.handshake_time_ms * factor),
        keepalive_time_ms=int(f.keepalive_time_ms * factor),
        hold_time_ms=int(f.hold_time_ms * factor * 2),
        graceful_restart_time_ms=int(
            f.graceful_restart_time_ms * factor * 2
        ),
    )


@dataclass
class ClusterNodeSpec:
    name: str
    loopback: str | None = None  # originated prefix, e.g. "10.0.0.1/32"
    config: NodeConfig | None = None  # full override


@dataclass
class LinkSpec:
    a: str
    b: str
    metric: int = 1  # applied symmetrically via LinkMonitor metric override
    latency_ms: float = 0.0
    a_if: str = ""
    b_if: str = ""

    def __post_init__(self):
        self.a_if = self.a_if or f"if-{self.a}-{self.b}"
        self.b_if = self.b_if or f"if-{self.b}-{self.a}"


def loopback_of(i: int) -> str:
    return f"10.{(i >> 8) & 0xFF}.{i & 0xFF}.1/32"


@dataclass
class Cluster:
    """N full nodes + links, one asyncio loop."""

    nodes: dict[str, OpenrNode] = field(default_factory=dict)
    hub: MockIoHub = field(default_factory=MockIoHub)
    transport: InProcKvTransport = field(default_factory=InProcKvTransport)
    links: list[LinkSpec] = field(default_factory=list)
    device: object = None  # None: the current CUDA card; "cpu": the twins
    enable_ctrl: bool = False
    # chaos wiring (emulator/chaos.py): when set, the hub is a
    # ChaosIoHub, each node's kv transport is a per-node ChaosKvTransport
    # and its fib handler a plan-gated ChaosFibHandler
    chaos: object | None = None
    # crashed-but-restartable nodes: name -> (Config, fib_handler) — the
    # handler IS the emulated dataplane, surviving the control-plane
    # crash so restart_node exercises Fib warm boot
    crashed: dict[str, tuple] = field(default_factory=dict)
    _partitioned: list[LinkSpec] = field(default_factory=list)

    @staticmethod
    def build(
        node_specs: list[ClusterNodeSpec],
        link_specs: list[LinkSpec],
        device=None,
        debounce_ms: tuple[int, int] | None = None,
        enable_ctrl: bool = False,
        chaos=None,
        node_config_transform=None,
        wire_codec: str = "bin",
    ) -> "Cluster":
        c = Cluster(device=device, enable_ctrl=enable_ctrl, chaos=chaos)
        # wire codec for the whole emulated cluster:
        # "bin" = serialize-once compact binary floods + binary Spark
        # packets (the production path chaos/soak validate); "json" =
        # the legacy per-peer text framing (bench_churn --flood-bench's
        # measured baseline)
        c.transport = InProcKvTransport(codec=wire_codec)
        if chaos is not None:
            from openr_tpu_torch.emulator.chaos import ChaosIoHub

            c.hub = ChaosIoHub(chaos)
        spark_cfg = scaled_spark(len(node_specs))
        if debounce_ms is None:
            # Decision debounce scales with CPU oversubscription for
            # the same reason the Spark timers do (scaled_spark): in a
            # convergence wave every node receives ~N publications, and
            # a 60 ms coalescing cap on one shared core means hundreds
            # of redundant full rebuilds competing with the hello
            # service — rebuild starvation is the 256-node collapse
            # mode. Small clusters keep the responsive default.
            n = len(node_specs)
            debounce_ms = (
                (10, 60) if n <= 64 else (10, int(60 * (n / 64) * 2))
            )
        for spec in node_specs:
            ncfg = spec.config
            if (
                ncfg is not None
                and ncfg.spark.hold_time_ms < spark_cfg.hold_time_ms
            ):
                # explicit configs are honored verbatim, but a hold
                # below the oversubscription-scaled value silently
                # reintroduces the flap storm scaled_spark exists to
                # prevent — say so
                log.warning(
                    "%s: explicit spark hold %d ms is below the %d ms "
                    "scaled for a %d-node emulation; hello starvation "
                    "may flap this node's adjacencies",
                    spec.name, ncfg.spark.hold_time_ms,
                    spark_cfg.hold_time_ms, len(node_specs),
                )
            if ncfg is None:
                originated = ()
                if spec.loopback:
                    originated = (OriginatedPrefix(prefix=spec.loopback),)
                # the port has no watchdog yet (an enabled one raises in
                # OpenrNode), so the configs the cluster makes run without
                ncfg = NodeConfig(
                    node_name=spec.name,
                    spark=spark_cfg,
                    originated_prefixes=originated,
                    watchdog=WatchdogConfig(enable=False),
                )
            # copy-on-write: never mutate a caller-supplied NodeConfig
            from dataclasses import replace

            ncfg = replace(
                ncfg,
                decision=replace(
                    ncfg.decision,
                    debounce_min_ms=debounce_ms[0],
                    debounce_max_ms=debounce_ms[1],
                ),
                spark=replace(ncfg.spark, wire_codec=wire_codec),
            )
            if node_config_transform is not None:
                # last word on every node's config (e.g. the soak's
                # unbounded-control case flips messaging.enforce_bounds)
                # — keeps callers out of the per-node wiring below
                ncfg = node_config_transform(ncfg)
            cfg = Config(ncfg)
            node = OpenrNode(
                cfg,
                c.hub.io_for(spec.name),
                c._transport_for(spec.name),
                fib_handler=c._fib_handler_for(spec.name),
                device=device,
                enable_ctrl=enable_ctrl,
            )
            c.transport.register(spec.name, node.kvstore)
            c.nodes[spec.name] = node
        for ls in link_specs:
            c.links.append(ls)
        return c

    @staticmethod
    def from_edges(
        edges: list[tuple[str, str]] | list[LinkSpec],
        device=None,
        enable_ctrl: bool = False,
        chaos=None,
        node_config_transform=None,
        wire_codec: str = "bin",
    ) -> "Cluster":
        links = [
            e if isinstance(e, LinkSpec) else LinkSpec(a=e[0], b=e[1])
            for e in edges
        ]
        names = sorted({l.a for l in links} | {l.b for l in links})
        specs = [
            ClusterNodeSpec(name=n, loopback=loopback_of(i))
            for i, n in enumerate(names)
        ]
        return Cluster.build(
            specs, links, device=device, enable_ctrl=enable_ctrl, chaos=chaos,
            node_config_transform=node_config_transform,
            wire_codec=wire_codec,
        )

    def _transport_for(self, name: str):
        """Per-node kv transport view: the chaos wrapper needs to know
        which node OWNS the outgoing sessions (partition blocking is a
        pair property); without chaos the shared registry is used as-is."""
        if self.chaos is None:
            return self.transport
        from openr_tpu_torch.emulator.chaos import ChaosKvTransport

        return ChaosKvTransport(self.transport, self.chaos, name)

    def _fib_handler_for(self, name: str):
        """Plan-gated fault-injecting FibService per node, or None to
        let OpenrNode build its default MockFibHandler."""
        if self.chaos is None or self.chaos.fib_faults.fail_rate <= 0:
            return None
        from openr_tpu_torch.emulator.chaos import ChaosFibHandler

        return ChaosFibHandler(self.chaos, name)

    # ------------------------------------------------------------ lifecycle

    async def start(self) -> None:
        for node in self.nodes.values():
            await node.start()
        for ls in self.links:
            self.hub.link(ls.a, ls.a_if, ls.b, ls.b_if, latency_ms=ls.latency_ms)
            if ls.metric != 1:
                self.nodes[ls.a].linkmonitor.set_link_metric(ls.a_if, ls.metric)
                self.nodes[ls.b].linkmonitor.set_link_metric(ls.b_if, ls.metric)
            self.nodes[ls.a].set_interface(ls.a_if, up=True)
            self.nodes[ls.b].set_interface(ls.b_if, up=True)

    async def stop(self) -> None:
        for node in self.nodes.values():
            await node.stop()

    # ----------------------------------------------------------- assertions

    def converged(self) -> bool:
        """Every node initialized and programs a route to every other
        node's loopback."""
        n_remote = len(self.nodes) - 1
        for node in self.nodes.values():
            if not node.initialized:
                return False
            if len(node.fib.programmed_unicast) < n_remote:
                return False
        return True

    async def wait_converged(self, timeout: float = 30.0) -> None:
        t0 = asyncio.get_event_loop().time()
        while not self.converged():
            if asyncio.get_event_loop().time() - t0 > timeout:
                detail = {
                    name: (
                        node.initialized,
                        len(node.fib.programmed_unicast),
                    )
                    for name, node in self.nodes.items()
                }
                raise TimeoutError(f"cluster did not converge: {detail}")
            await asyncio.sleep(0.02)

    def fleet_counters(self, prefix: str = "") -> dict:
        """Cluster-wide counter distributions: every live node's Counters
        snapshot folded into per-key cross-node min/p50/p99/max
        (`monitor/fleet.py`)."""
        from openr_tpu_torch.monitor.fleet import aggregate_counters

        return aggregate_counters(
            {
                name: node.counters.snapshot()
                for name, node in self.nodes.items()
            },
            prefix=prefix,
        )

    # -------------------------------------------------------------- control

    def _links_between(self, a: str, b: str) -> list[LinkSpec]:
        found = [ls for ls in self.links if {ls.a, ls.b} == {a, b}]
        if not found:
            raise ValueError(f"no link between {a!r} and {b!r}")
        return found

    def fail_link(self, a: str, b: str) -> None:
        """Silent packet loss on the (a, b) link: the hub stops
        delivering, and the adjacency dies by Spark hold-timer expiry —
        neither endpoint is told. Raises ValueError when no such link
        exists (a typo'd pair must not be a silent no-op)."""
        for ls in self._links_between(a, b):
            self.hub.set_link(ls.a, ls.a_if, up=False)
            self.hub.set_link(ls.b, ls.b_if, up=False)

    def heal_link(self, a: str, b: str) -> None:
        """Undo fail_link. Asymmetric with it by design: fail models
        silent loss (hold-timer detection, no interface event), while
        heal re-ups the hub AND re-injects interface-up events on both
        endpoints so Spark restarts fast-init discovery immediately.
        Raises ValueError when no such link exists."""
        for ls in self._links_between(a, b):
            self.hub.set_link(ls.a, ls.a_if, up=True)
            self.hub.set_link(ls.b, ls.b_if, up=True)
            if ls.a in self.nodes:
                self.nodes[ls.a].set_interface(ls.a_if, up=True)
            if ls.b in self.nodes:
                self.nodes[ls.b].set_interface(ls.b_if, up=True)

    # ------------------------------------------------------- chaos: crash/GR

    async def crash_node(self, name: str, graceful: bool = False) -> None:
        """Control-plane crash: stop every module, drop the node's
        Spark inbox, and unregister its KvStore from the in-proc
        transport so peers' floods/full_syncs to it now FAIL (exercising
        their flood-failure → full-sync repair path). The MockFibHandler
        — the emulated dataplane — survives in `self.crashed`, so a
        later restart_node exercises Fib warm boot. With graceful=True
        the node first announces a Spark graceful restart, so neighbors
        hold the adjacency for gr_time instead of withdrawing at
        hold-timer expiry."""
        node = self.nodes.pop(name)  # KeyError: unknown or already crashed
        if graceful:
            # hub delivery is synchronous, so the GR hellos sit in peer
            # inboxes when this returns; stop() follows with NO
            # intervening yield — a hello tick sneaking in between
            # would send restarting=False and cancel the GR hold on
            # the receivers
            await node.spark.announce_restart()
        await node.stop()
        self.transport.unregister(name)
        self.hub.drop_node(name)
        self.crashed[name] = (node.config, node.fib_handler)

    async def restart_node(self, name: str) -> None:
        """Rebuild a crashed node from its retained Config and start it:
        KvStore re-syncs the LSDB from peers, Decision recomputes, and
        Fib warm-boots off the surviving MockFibHandler — the first
        program pass is an incremental delta against the adopted kernel
        state, so surviving prefixes see zero route-withdrawal gap."""
        cfg, handler = self.crashed.pop(name)
        node = OpenrNode(
            cfg,
            self.hub.io_for(name),
            self._transport_for(name),
            fib_handler=handler,
            device=self.device,
            enable_ctrl=self.enable_ctrl,
        )
        self.transport.register(name, node.kvstore)
        self.nodes[name] = node
        await node.start()
        for ls in self.links:
            if name not in (ls.a, ls.b):
                continue
            my_if = ls.a_if if ls.a == name else ls.b_if
            if ls.metric != 1:
                # mirror Cluster.start: a restarted node must rejoin
                # with its configured link weights, not the default
                node.linkmonitor.set_link_metric(my_if, ls.metric)
            node.set_interface(my_if, up=True)

    # ------------------------------------------------------ chaos: partition

    def partition(self, groups) -> None:
        """Split the cluster: every link whose endpoints belong to
        DIFFERENT groups — including one grouped endpoint vs one
        ungrouped — goes down at the packet layer; a link between two
        ungrouped nodes is untouched. When the cluster is
        chaos-wrapped, the KvStore transport additionally refuses the
        same cross-group pairs immediately, so established kv sessions
        break like real sockets would instead of lingering until Spark
        hold expiry. Unknown names raise ValueError (same contract as
        fail_link). Repeated partitions compose; `heal_partition`
        heals them all."""
        all_names = set(self.nodes) | set(self.crashed)
        membership: dict[str, int] = {}
        for gi, group in enumerate(groups):
            for n in group:
                if n not in all_names:
                    # same contract as fail_link: a typo'd name must not
                    # silently reshape the split
                    raise ValueError(f"partition group names unknown node {n!r}")
                membership[n] = gi
        for ls in self.links:
            ga, gb = membership.get(ls.a), membership.get(ls.b)
            if ga == gb and ga is not None:
                continue
            if ga is None and gb is None:
                continue  # both outside every group: untouched
            self.hub.set_link(ls.a, ls.a_if, up=False)
            self.hub.set_link(ls.b, ls.b_if, up=False)
            self._partitioned.append(ls)
        if self.chaos is not None:
            names = sorted(all_names)
            for i, a in enumerate(names):
                for b in names[i + 1 :]:
                    ga, gb = membership.get(a), membership.get(b)
                    if ga == gb and ga is not None:
                        continue
                    if ga is None and gb is None:
                        continue
                    self.chaos.block_kv(a, b)

    def heal_partition(self) -> None:
        """Re-up every partition-downed link (and re-inject interface-up
        on live endpoints, mirroring heal_link), and lift all KvStore
        pair blocks."""
        healed, self._partitioned = self._partitioned, []
        for ls in healed:
            self.hub.set_link(ls.a, ls.a_if, up=True)
            self.hub.set_link(ls.b, ls.b_if, up=True)
            if ls.a in self.nodes:
                self.nodes[ls.a].set_interface(ls.a_if, up=True)
            if ls.b in self.nodes:
                self.nodes[ls.b].set_interface(ls.b_if, up=True)
        if self.chaos is not None:
            self.chaos.unblock_kv_all()

    # ----------------------------------------------------- chaos: flap storm

    def make_storm(
        self,
        plan,
        *,
        duration_s: float = 2.0,
        n_flaps: int = 0,
        n_crashes: int = 0,
        n_partitions: int = 0,
        heal_after_s: float = 0.6,
        n_disk_faults: int = 0,
    ):
        """Flap-storm generator: build this cluster's deterministic
        fault schedule on `plan` (a ChaosPlan) from its own link/node
        sets. Run it with chaos.run_schedule(cluster, plan)."""
        return plan.build_storm(
            [(ls.a, ls.b) for ls in self.links],
            sorted(set(self.nodes) | set(self.crashed)),
            duration_s=duration_s,
            n_flaps=n_flaps,
            n_crashes=n_crashes,
            n_partitions=n_partitions,
            heal_after_s=heal_after_s,
            n_disk_faults=n_disk_faults,
        )
