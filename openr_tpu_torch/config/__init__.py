"""The node configuration the port's modules read."""

from openr_tpu_torch.config.config import (  # noqa: F401
    AreaConfig,
    Config,
    ConfigError,
    DecisionConfig,
    FibConfig,
    KvstoreConfig,
    LinkMonitorConfig,
    MessagingConfig,
    NodeConfig,
    OriginatedPrefix,
    PolicyStatementConfig,
    PrefixAllocationConfig,
    RouteMapTermConfig,
    SegmentRoutingConfig,
    SparkConfig,
    TlsConfig,
    UdpInterfaceConfig,
    WatchdogConfig,
)
