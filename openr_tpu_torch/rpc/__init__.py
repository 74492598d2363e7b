"""The RPC layer's error classes (the port's copy of `RpcError` and
`RpcTransportError` of `openr_tpu/rpc/core.py`; the RPC client, server
and framing come with the port's `rpc/`).

KvStore's sync loop tells them apart: a plain `RpcError` means the peer's
handler answered with an error (an older peer rejecting the compact
full-sync digest), a `RpcTransportError` that the connection failed.
"""


class RpcError(Exception):
    """The remote handler raised, or the transport failed."""


class RpcTransportError(RpcError):
    """The connection failed (refused, reset, closed, timed out): the
    remote handler never answered."""
