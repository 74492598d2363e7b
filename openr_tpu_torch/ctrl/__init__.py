"""The ctrl API (the port's copy of `openr_tpu/ctrl/`): `CtrlServer`,
the RPC service over one node's module graph that `OpenrNode(enable_ctrl=
True)` and the daemon serve. Query it with `rpc.RpcClient`."""

from openr_tpu_torch.ctrl.server import CtrlServer  # noqa: F401
