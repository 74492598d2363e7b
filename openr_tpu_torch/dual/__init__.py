"""DUAL, the diffusing update algorithm, for flood-root election: KvStore
floods along a spanning tree per root, O(V) messages an update instead of
O(E)."""

from openr_tpu_torch.dual.dual import (
    DUAL_INF,
    DualMsg,
    DualNode,
    RootStatus,
)

__all__ = ["DUAL_INF", "DualMsg", "DualNode", "RootStatus"]
