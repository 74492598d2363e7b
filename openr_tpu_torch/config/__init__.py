"""The node configuration the port's KvStore and Decision read."""

from openr_tpu_torch.config.config import (  # noqa: F401
    AreaConfig,
    Config,
    ConfigError,
    DecisionConfig,
    KvstoreConfig,
    NodeConfig,
)
