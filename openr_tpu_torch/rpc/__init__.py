"""Async RPC (the port's copy of `openr_tpu/rpc/`): request / response
calls, notifications and server-push streams over TCP, in JSON lines or
binary frames negotiated per connection (`core.py`), optionally over TLS
(`tls.py`). KvStore peers over it (`kvstore.TcpKvTransport`,
`KvStore.register_rpc`).

KvStore's sync loop tells the two error classes apart: a plain
`RpcError` means the peer's handler answered with an error (an older
peer rejecting the compact full-sync digest), a `RpcTransportError` that
the connection failed.
"""

from openr_tpu_torch.rpc.core import (  # noqa: F401
    WIRE_CODEC_BIN,
    RpcClient,
    RpcError,
    RpcServer,
    RpcTransportError,
    StreamWriter,
    WireFrameError,
    bin_frame,
)
