"""OpenrNode: the full module graph of one router (the port's copy of
`openr_tpu/node.py`).

It builds every typed queue, then every module in dependency order,
starts each (asyncio tasks on one loop; the Decision's rebuilds run in
worker threads with the card current), and exposes the initialization
gates KVSTORE_SYNCED -> RIB_COMPUTED -> FIB_SYNCED (`wait_initialized`).

Three boundaries are swappable: packet I/O (`io_provider`: a
`spark.MockIoHub`'s `MockIo` or a `spark.UdpIoProvider`), KvStore peer
transport (`kv_transport`: `InProcKvTransport` or `TcpKvTransport`) and
route programming (`fib_handler`, a `MockFibHandler` by default).

`device` takes the place of the JAX package's `solver=`: None is the
current CUDA card (the Decision's solver raises without one), "cpu"
the CPU twins; a config with `decision.use_tpu_solver=False` solves in
the host oracle. `enable_ctrl=True` serves the ctrl API
(`ctrl.CtrlServer`) on `endpoint_host`:`ctrl_port` (0: an ephemeral
port, read back from `node.ctrl.port` once started), last in the start
order. The modules the port does not have yet raise
`NotImplementedError` naming them: `store_path` (configstore),
`persist_dir` / `persist` (persist) and `watchdog.enable` (watchdog).
The config's `watchdog.enable` defaults to True, as in the JAX package,
so a port node's config turns it off. The JAX package's
`watchdog_abort_fn` argument is not taken at all until the watchdog
comes: passing it is a `TypeError`, never a setting silently ignored.
"""

from __future__ import annotations

import asyncio
import logging

from openr_tpu_torch.allocators import PrefixAllocator
from openr_tpu_torch.config import Config
from openr_tpu_torch.decision.decision import Decision
from openr_tpu_torch.fib import Fib, MockFibHandler
from openr_tpu_torch.kvstore import KvStore, KvStoreClient
from openr_tpu_torch.linkmonitor import LinkMonitor
from openr_tpu_torch.messaging import COALESCE, SHED_OLDEST, ReplicateQueue
from openr_tpu_torch.messaging.policies import (
    coalesce_publications,
    coalesce_route_updates,
)
from openr_tpu_torch.monitor import Counters, Monitor
from openr_tpu_torch.monitor.flight import FlightRecorder
from openr_tpu_torch.prefixmgr import PrefixManager
from openr_tpu_torch.spark import Spark
from openr_tpu_torch.types.events import InterfaceEvent, InterfaceInfo
from openr_tpu_torch.types.wirelock import locked_version

log = logging.getLogger(__name__)


def _not_ported(what: str, module: str) -> NotImplementedError:
    return NotImplementedError(
        f"OpenrNode: {what} needs the JAX package's {module}, which is "
        "not part of the port yet"
    )


class OpenrNode:
    """One complete Open/R instance (all modules, all queues)."""

    def __init__(
        self,
        config: Config,
        io_provider,
        kv_transport,
        fib_handler=None,
        device=None,
        kvstore_port: int = 0,
        endpoint_host: str = "127.0.0.1",
        enable_ctrl: bool = False,
        ctrl_port: int = 0,
        store_path: str | None = None,
        persist_dir: str | None = None,
        persist=None,
    ):
        if store_path is not None:
            raise _not_ported("store_path", "configstore/")
        if persist is not None or persist_dir is not None:
            raise _not_ported("persist / persist_dir", "persist/")
        if config.node.watchdog.enable:
            raise _not_ported(
                "watchdog.enable (set it False in the config)", "watchdog/"
            )
        self.config = config
        self.name = config.node_name
        self.counters = Counters()
        self.persist = None
        # per-node flight recorder, reached by every module through the
        # Counters it already holds
        self.flight = FlightRecorder(node=self.name)
        self.counters.flight = self.flight
        # the wire schema lock's version as a gauge: a version-skewed
        # node shows before its peers mis-decode its frames
        lockv = locked_version()
        if lockv is not None:
            self.counters.set("wire.schema_lock_version", lockv)

        # ---- queues -----------------------------------------------------
        # every seam is depth-gauged; the policied ones are bounded with
        # an overflow discipline matched to their payload: mergeable
        # deltas coalesce at the bound, telemetry sheds its oldest,
        # control events stay unbounded (losing one breaks a protocol
        # state machine)
        mcfg = config.node.messaging
        bound = mcfg.queue_maxsize if mcfg.enforce_bounds else 0

        def _q(short: str, policy=None, coalesce_fn=None) -> ReplicateQueue:
            return ReplicateQueue(
                name=f"{self.name}.{short}",
                maxsize=bound if policy is not None else 0,
                policy=policy,
                coalesce_fn=coalesce_fn,
                counters=self.counters,
                counter_key=short,
            )

        self.neighbor_events = _q("neighbor_events")
        self.interface_events = _q("interface_events")
        self.peer_events = _q("peer_events")
        self.kvstore_pubs = _q(
            "kvstore_pubs", COALESCE, coalesce_publications
        )
        self.prefix_events = _q("prefix_events")
        self.route_updates = _q(
            "route_updates", COALESCE, coalesce_route_updates
        )
        self.fib_updates = _q(
            "fib_updates", COALESCE, coalesce_route_updates
        )
        self.log_samples = _q("log_samples", SHED_OLDEST)
        # completed convergence traces: Fib -> Monitor
        self.perf_events = _q("perf_events", SHED_OLDEST)
        self.queues: dict[str, ReplicateQueue] = {
            "neighbor_events": self.neighbor_events,
            "interface_events": self.interface_events,
            "peer_events": self.peer_events,
            "kvstore_pubs": self.kvstore_pubs,
            "prefix_events": self.prefix_events,
            "route_updates": self.route_updates,
            "fib_updates": self.fib_updates,
            "log_samples": self.log_samples,
            "perf_events": self.perf_events,
        }

        # ---- modules, dependency order ----------------------------------
        self.store = None
        self.monitor = Monitor(
            config,
            self.log_samples.get_reader(),
            perf_events_reader=self.perf_events.get_reader(),
            counters=self.counters,
        )
        self.kvstore = KvStore(
            config,
            kv_transport,
            self.kvstore_pubs,
            peer_events_reader=self.peer_events.get_reader(),
            counters=self.counters,
        )
        self.kv_client = KvStoreClient(
            self.kvstore,
            self.name,
            self.kvstore_pubs.get_reader(),
            counters=self.counters,
        )
        self.decision = Decision(
            config,
            self.kvstore_pubs.get_reader(),
            self.route_updates,
            counters=self.counters,
            # the first rebuild sees a fully synced store
            initial_sync_event=self.kvstore.initial_sync_done,
            device=device,
        )
        self.fib_handler = (
            fib_handler if fib_handler is not None else MockFibHandler()
        )
        self.fib = Fib(
            config,
            self.route_updates.get_reader(),
            self.fib_handler,
            fib_updates_queue=self.fib_updates,
            perf_events_queue=self.perf_events,
            counters=self.counters,
        )
        self.spark = Spark(
            config,
            io_provider,
            self.neighbor_events,
            kvstore_port=kvstore_port,
            endpoint_host=endpoint_host,
            counters=self.counters,
        )
        self.linkmonitor = LinkMonitor(
            config,
            self.spark,
            self.kv_client,
            self.neighbor_events.get_reader(),
            self.peer_events,
            interface_events_reader=self.interface_events.get_reader(),
            log_samples_queue=self.log_samples,
            counters=self.counters,
        )
        origination_policy = None
        if config.node.prefix_route_map:
            from openr_tpu_torch.policy import PolicyManager
            from openr_tpu_torch.policy.policy import build_route_map

            origination_policy = PolicyManager(
                route_map=build_route_map(
                    config.node.prefix_route_map,
                    config.node.prefix_route_map_default_accept,
                )
            )
        elif (
            config.node.prefix_policy_statements
            or not config.node.prefix_policy_default_accept
        ):
            from dataclasses import asdict

            from openr_tpu_torch.policy import PolicyManager, PolicyStatement

            origination_policy = PolicyManager(
                statements=tuple(
                    PolicyStatement(**asdict(s))
                    for s in config.node.prefix_policy_statements
                ),
                default_accept=config.node.prefix_policy_default_accept,
            )
        self.prefixmgr = PrefixManager(
            config,
            self.kv_client,
            prefix_events_reader=self.prefix_events.get_reader(),
            fib_updates_reader=self.fib_updates.get_reader(),
            # only an ABR (more than one area) reads this stream: a
            # reader made unconditionally would buffer RouteUpdates forever
            route_updates_reader=(
                self.route_updates.get_reader()
                if len(config.area_ids()) > 1 else None
            ),
            policy=origination_policy,
            counters=self.counters,
        )
        self.prefix_allocator = None
        if config.node.prefix_allocation is not None:
            self.prefix_allocator = PrefixAllocator(
                config,
                self.kvstore,
                self.kvstore_pubs.get_reader(),
                self.prefix_events,
                counters=self.counters,
            )

        self.ctrl = None
        if enable_ctrl:
            # built before start, so its queue readers see every message
            from openr_tpu_torch.ctrl import CtrlServer

            self.ctrl = CtrlServer(self, host=endpoint_host, port=ctrl_port)
        self.watchdog = None
        # start order: discovery last; shutdown is the reverse
        self._modules = [
            self.monitor,
            self.kvstore,
            self.kv_client,
            self.decision,
            self.fib,
            self.prefixmgr,
            self.spark,
            self.linkmonitor,
        ]
        if self.prefix_allocator is not None:
            self._modules.append(self.prefix_allocator)
        if self.ctrl is not None:
            self._modules.append(self.ctrl)
        self._started = False

    # ------------------------------------------------------------ lifecycle

    async def start(self) -> None:
        assert not self._started
        self._started = True
        for m in self._modules:
            await m.start()
        log.info("node %s started (%d modules)", self.name, len(self._modules))

    async def stop(self) -> None:
        if not self._started:
            return
        self._started = False
        for m in reversed(self._modules):
            await m.stop()
        for q in self.queues.values():
            q.close()

    async def wait_initialized(self, timeout: float = 30.0) -> None:
        """Wait until the three init gates pass (KVSTORE_SYNCED ->
        RIB_COMPUTED -> FIB_SYNCED), one deadline over all three."""
        deadline = asyncio.get_event_loop().time() + timeout
        for gate in (
            self.kvstore.initial_sync_done,
            self.decision.rib_computed,
            self.fib.synced,
        ):
            remaining = deadline - asyncio.get_event_loop().time()
            await asyncio.wait_for(gate.wait(), max(remaining, 0.001))

    @property
    def initialized(self) -> bool:
        return (
            self.kvstore.initial_sync_done.is_set()
            and self.decision.rib_computed.is_set()
            and self.fib.synced.is_set()
        )

    # ------------------------------------------------------------ operator

    def set_interface(self, name: str, up: bool = True) -> None:
        """Inject an interface event (the netlink seam)."""
        self.interface_events.push(
            InterfaceEvent(interfaces=[InterfaceInfo(name=name, is_up=up)])
        )

    def get_route_db(self):
        return self.decision.get_route_db()

    def get_programmed_routes(self):
        return self.fib.get_programmed_unicast()
