"""The node configuration the port's modules read (the port's copy of
`openr_tpu/config/config.py`): every section of `NodeConfig` but the
three fields no module reads (`enable_v4`, `enable_best_route_selection`,
`dry_run`), `SegmentRoutingConfig.sr_local_range` and
`OriginatedPrefix.install_to_fib` (the adjacency labels come from the
`SR_LOCAL_RANGE` constant in both packages). `Config.from_json`,
`from_file` and `to_json` read and write the same JSON document as the
JAX package's.

`DecisionConfig` has every knob of the JAX package's with the same
defaults. On the port the table knobs (`use_dense_kernel`,
`use_pallas_kernel`, `spf_kernel`) pick `TorchSpfSolver`'s tables,
`use_tpu_solver=False` selects the host oracle (`decision/oracle.py`)
in place of the card, `native_rib="on"` (the JAX package's host C++
engine) is not part of the port, and `mesh_sources` x `mesh_graph`
shape the solver's mesh of CUDA devices.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, replace

from openr_tpu_torch.common import constants as C
from openr_tpu_torch.types.network import IpPrefix
from openr_tpu_torch.types.serde import from_wire, to_jsonable
from openr_tpu_torch.types.topology import ForwardingAlgorithm, ForwardingType


class ConfigError(ValueError):
    """Invalid configuration."""


@dataclass
class SparkConfig:
    hello_time_ms: int = C.SPARK_HELLO_INTERVAL_MS
    fastinit_hello_time_ms: int = C.SPARK_FASTINIT_HELLO_INTERVAL_MS
    handshake_time_ms: int = C.SPARK_HANDSHAKE_INTERVAL_MS
    keepalive_time_ms: int = C.SPARK_HEARTBEAT_INTERVAL_MS
    hold_time_ms: int = C.SPARK_HOLD_TIME_MS
    graceful_restart_time_ms: int = C.SPARK_GR_HOLD_TIME_MS
    # the codec Spark sends in: "bin" (compact binary) or "json"; every
    # packet received is sniffed, so neighbours of either codec interoperate
    wire_codec: str = "bin"


@dataclass
class KvstoreConfig:
    key_ttl_ms: int = C.KVSTORE_DEFAULT_TTL_MS
    sync_interval_s: int = C.KVSTORE_SYNC_INTERVAL_S
    flood_rate_msgs_per_sec: int = C.KVSTORE_FLOOD_RATE_MSGS_PER_SEC
    flood_rate_burst_size: int = C.KVSTORE_FLOOD_RATE_BURST
    # bound on a peer's coalesced pending-flood buffer; overflow drops
    # the backlog and schedules a full sync (backpressure)
    flood_pending_max_keys: int = C.KVSTORE_FLOOD_PENDING_MAX_KEYS
    # floods restricted to a DUAL spanning tree of the peers
    enable_flood_optimization: bool = False
    # flood-root eligibility: this node, or the nodes named in
    # flood_root_candidates (the same list on every node; it overrides
    # is_flood_root)
    is_flood_root: bool = False
    flood_root_candidates: tuple[str, ...] = ()
    # grace before a store with no peer declares its initial sync done
    initial_sync_grace_s: float = 2.0
    # cross-node flood-span sampling (every Nth local origination); the
    # port's KvStore carries spans but does not stamp them, so it
    # refuses trace_sample_every > 0
    trace_sample_every: int = 0


@dataclass
class MessagingConfig:
    """The bounds of the inter-module queues: the publications and route
    updates coalesce at the bound, telemetry sheds its oldest items."""

    # per-reader depth cap of the policied queues; 0 = unbounded
    queue_maxsize: int = C.QUEUE_MAXSIZE
    # False keeps queue_maxsize but builds the queues unbounded
    enforce_bounds: bool = True


@dataclass
class LinkMonitorConfig:
    linkflap_initial_backoff_ms: int = C.LINK_FLAP_INITIAL_BACKOFF_MS
    linkflap_max_backoff_ms: int = C.LINK_FLAP_MAX_BACKOFF_MS
    # metric from the neighbour's RTT (rtt_us // 100) instead of 1 a hop
    use_rtt_metric: bool = False
    include_interface_regexes: tuple[str, ...] = ()
    exclude_interface_regexes: tuple[str, ...] = ()


@dataclass
class DecisionConfig:
    debounce_min_ms: int = C.DECISION_DEBOUNCE_MIN_MS
    debounce_max_ms: int = C.DECISION_DEBOUNCE_MAX_MS
    # False selects the host oracle: no solver, no device
    use_tpu_solver: bool = True
    use_dense_kernel: bool | None = None  # None = auto
    # the dense tables on kernel A (the reference's Pallas relax kernel)
    use_pallas_kernel: bool = False
    # batched kernel implementation: "split" (the default) or "dense"
    spf_kernel: str = "split"
    # the JAX package's host C++ engine: "auto" and "off" solve on the
    # port's device, "on" is not part of the port
    native_rib: str = "auto"
    enable_lfa: bool = False
    # edge-disjoint paths per SR-MPLS KSP prefix
    ksp_paths: int = 2
    # mesh of positions for the batched solves (sources x graph); 0 = off
    mesh_sources: int = 0
    mesh_graph: int = 1
    # metric-only link churn warm-starts from the cached solve
    # (REBUILD_TOPO_DELTA); False sends every topology change down the
    # full path
    enable_topo_delta: bool = True
    # a warm start is refused when the changed edges exceed this share of
    # the graph's edges
    topo_delta_max_frac: float = 0.25


@dataclass
class FibConfig:
    initial_retry_ms: int = C.FIB_INITIAL_RETRY_MS
    max_retry_ms: int = C.FIB_MAX_RETRY_MS
    sync_interval_s: int = C.FIB_SYNC_INTERVAL_S
    dry_run: bool = False
    # adopt the handler's table at start and program only the delta
    # against the first RIB
    enable_warm_boot: bool = True
    # most routes a FibService add or delete call on the delta path
    program_batch_size: int = 4096


@dataclass
class SegmentRoutingConfig:
    enable: bool = False
    node_segment_label: int = 0  # 0: picked from sr_global_range
    sr_global_range: tuple[int, int] = C.SR_GLOBAL_RANGE


@dataclass
class WatchdogConfig:
    enable: bool = True
    interval_s: int = C.WATCHDOG_INTERVAL_S
    thread_timeout_s: int = C.WATCHDOG_THREAD_TIMEOUT_S


@dataclass
class AreaConfig:
    """An area: its id and its interface and neighbour membership
    regexes (Spark negotiates a neighbour into the first area whose
    `neighbor_regexes` match its name)."""

    area_id: str = C.DEFAULT_AREA
    include_interface_regexes: tuple[str, ...] = (".*",)
    neighbor_regexes: tuple[str, ...] = (".*",)


@dataclass
class OriginatedPrefix:
    """A prefix the node originates from its config; with
    `minimum_supporting_routes`, only while that many more-specific
    routes are programmed."""

    prefix: str = ""
    forwarding_type: ForwardingType = ForwardingType.IP
    forwarding_algorithm: ForwardingAlgorithm = ForwardingAlgorithm.SP_ECMP
    path_preference: int = 1000
    source_preference: int = 100
    minimum_supporting_routes: int = 0
    tags: tuple[str, ...] = ()


@dataclass(frozen=True)
class PolicyStatementConfig:
    """A `policy.PolicyStatement` as the config holds it (OpenrNode
    converts it)."""

    name: str = ""
    match_tags: tuple[str, ...] = ()
    match_prefixes: tuple[str, ...] = ()
    action_accept: bool = True
    set_path_preference: int | None = None
    set_source_preference: int | None = None
    set_distance_increment: int | None = None
    add_tags: tuple[str, ...] = ()


@dataclass
class RouteMapTermConfig:
    """One term of an ordered route-map as the config holds it;
    `match_prefixes` entries are "PREFIX [ge N] [le N]" strings."""

    seq: int = 0
    action: str = "permit"
    match_tags_any: tuple[str, ...] = ()
    match_tags_all: tuple[str, ...] = ()
    match_not_tags: tuple[str, ...] = ()
    match_prefixes: tuple[str, ...] = ()
    set_path_preference: int | None = None
    set_source_preference: int | None = None
    set_distance_increment: int | None = None
    set_tags: tuple[str, ...] | None = None
    add_tags: tuple[str, ...] = ()
    remove_tags: tuple[str, ...] = ()


@dataclass
class PrefixAllocationConfig:
    """Carve `seed_prefix` into /alloc_prefix_len blocks; each node
    elects one through KvStore (or pins `static_index`)."""

    seed_prefix: str = ""
    alloc_prefix_len: int = 0
    static_index: int | None = None


@dataclass
class UdpInterfaceConfig:
    """One point-to-point UDP "interface" of a standalone node: Spark's
    packets for `if_name` leave from `local_port` (0: any free port) to
    the peer's address."""

    if_name: str
    local_port: int
    peer_host: str
    peer_port: int


@dataclass
class TlsConfig:
    """TLS of the KvStore peering (and of the ctrl API): contexts built
    by `rpc.tls`."""

    enabled: bool = False
    cert_path: str = ""
    key_path: str = ""
    ca_path: str = ""  # the trust anchor both sides verify against
    # a verified client certificate is required (mutual auth)
    require_client_cert: bool = True


@dataclass
class NodeConfig:
    """The root config document, as far as the port's modules read
    it."""

    node_name: str = ""
    areas: tuple[AreaConfig, ...] = (AreaConfig(),)
    spark: SparkConfig = field(default_factory=SparkConfig)
    kvstore: KvstoreConfig = field(default_factory=KvstoreConfig)
    messaging: MessagingConfig = field(default_factory=MessagingConfig)
    link_monitor: LinkMonitorConfig = field(default_factory=LinkMonitorConfig)
    decision: DecisionConfig = field(default_factory=DecisionConfig)
    fib: FibConfig = field(default_factory=FibConfig)
    segment_routing: SegmentRoutingConfig = field(
        default_factory=SegmentRoutingConfig
    )
    watchdog: WatchdogConfig = field(default_factory=WatchdogConfig)
    originated_prefixes: tuple[OriginatedPrefix, ...] = ()
    # PrefixManager's origination policy: statements (empty: accept
    # everything), or an ordered route-map, which takes precedence
    prefix_policy_statements: tuple["PolicyStatementConfig", ...] = ()
    prefix_policy_default_accept: bool = True
    prefix_route_map: tuple["RouteMapTermConfig", ...] = ()
    prefix_route_map_default_accept: bool = False
    prefix_allocation: PrefixAllocationConfig | None = None
    # listener ports (0: any free port)
    ctrl_port: int = C.CTRL_PORT
    kvstore_port: int = C.KVSTORE_PORT
    # a standalone node's Spark links (`python -m openr_tpu_torch`)
    udp_interfaces: tuple[UdpInterfaceConfig, ...] = ()
    # the host the listeners bind and Spark advertises to neighbours
    endpoint_host: str = "127.0.0.1"
    tls: TlsConfig = field(default_factory=TlsConfig)


class Config:
    """Validated accessor wrapper."""

    def __init__(self, node: NodeConfig):
        self.node = node
        self._validate()

    @staticmethod
    def from_json(text: str | bytes) -> "Config":
        return Config(from_wire(text, NodeConfig))

    @staticmethod
    def from_file(path: str) -> "Config":
        with open(path, "rb") as f:
            return Config.from_json(f.read())

    @staticmethod
    def default(node_name: str, **overrides) -> "Config":
        return Config(replace(NodeConfig(node_name=node_name), **overrides))

    def to_json(self) -> str:
        return json.dumps(to_jsonable(self.node), indent=2)

    def _validate(self) -> None:
        n = self.node
        try:
            C.validate_name(n.node_name, "node_name")
        except ValueError as e:
            raise ConfigError(str(e)) from e
        if not n.areas:
            raise ConfigError("at least one area required")
        seen = set()
        for a in n.areas:
            try:
                C.validate_name(a.area_id, "area_id")
            except ValueError as e:
                raise ConfigError(str(e)) from e
            if a.area_id in seen:
                raise ConfigError(f"duplicate area {a.area_id!r}")
            seen.add(a.area_id)
        s = n.spark
        if not (0 < s.fastinit_hello_time_ms <= s.hello_time_ms):
            raise ConfigError("spark: fastinit must be <= hello interval")
        if s.hold_time_ms < 3 * s.keepalive_time_ms:
            raise ConfigError("spark: hold_time must be >= 3x keepalive")
        if s.wire_codec not in ("bin", "json"):
            raise ConfigError("spark: wire_codec must be bin|json")
        d = n.decision
        if not (0 < d.debounce_min_ms <= d.debounce_max_ms):
            raise ConfigError("decision: debounce min must be <= max")
        if not (1 <= d.ksp_paths <= 16):
            raise ConfigError("decision: ksp_paths must be in 1..16")
        if d.spf_kernel not in ("split", "dense"):
            raise ConfigError("decision: spf_kernel must be split|dense")
        if d.native_rib not in ("auto", "on", "off"):
            raise ConfigError("decision: native_rib must be auto|on|off")
        if d.mesh_sources < 0 or d.mesh_graph < 1:
            raise ConfigError(
                "decision: mesh_sources must be >= 0 and mesh_graph >= 1"
            )
        if n.kvstore.key_ttl_ms <= 0:
            raise ConfigError("kvstore: key_ttl_ms must be positive")
        if n.messaging.queue_maxsize < 0:
            raise ConfigError("messaging: queue_maxsize must be >= 0")
        f = n.fib
        if not (0 < f.initial_retry_ms <= f.max_retry_ms):
            raise ConfigError("fib: retry bounds invalid")
        sr = n.segment_routing
        if sr.enable:
            lo, hi = sr.sr_global_range
            if not (C.MPLS_LABEL_MIN <= lo <= hi <= C.MPLS_LABEL_MAX):
                raise ConfigError("segment_routing: bad global label range")
        for p in n.originated_prefixes:
            try:
                IpPrefix.make(p.prefix)
            except ValueError as e:
                raise ConfigError(f"bad originated prefix {p.prefix!r}") from e
        pa = n.prefix_allocation
        if pa is not None:
            try:
                seed = IpPrefix.make(pa.seed_prefix)
            except ValueError as e:
                raise ConfigError(f"bad seed prefix {pa.seed_prefix!r}") from e
            top = 32 if seed.is_v4 else 128
            if not (seed.prefix_len < pa.alloc_prefix_len <= top):
                raise ConfigError(
                    "prefix_allocation: alloc_prefix_len must be within "
                    f"({seed.prefix_len}, {top}]"
                )

    @property
    def node_name(self) -> str:
        return self.node.node_name

    @property
    def areas(self) -> tuple[AreaConfig, ...]:
        return self.node.areas

    def area_ids(self) -> list[str]:
        return [a.area_id for a in self.node.areas]
