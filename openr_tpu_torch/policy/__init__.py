"""Route policy: origination policy and Decision's RibPolicy."""

from openr_tpu_torch.policy.policy import (  # noqa: F401
    PolicyManager,
    PolicyStatement,
    RibPolicy,
    RibPolicyStatement,
    RouteMap,
    RouteMapTerm,
)
