"""The node configuration a Decision reads."""

from openr_tpu_torch.config.config import (  # noqa: F401
    AreaConfig,
    Config,
    ConfigError,
    DecisionConfig,
    NodeConfig,
)
