"""KvStore: the eventually-consistent replicated key-value store (the
port's copy of `openr_tpu/kvstore/`): versioned values resolved by
(version, originator, hash), a full sync on peer-up, incremental flooding
with split horizon, TTL expiry with originator refresh, one database an
area, peering in process (`InProcKvTransport`) or over TCP
(`TcpKvTransport`, with `KvStore.register_rpc` on the listener's side).
"""

from openr_tpu_torch.kvstore.store import KvStoreDb, merge_key_values  # noqa: F401
from openr_tpu_torch.kvstore.kvstore import KvStore  # noqa: F401
from openr_tpu_torch.kvstore.client import KvStoreClient  # noqa: F401
from openr_tpu_torch.kvstore.transport import (  # noqa: F401
    InProcKvTransport,
    TcpKvTransport,
)
