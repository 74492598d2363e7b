"""TLS of the RPC listeners and dialers (the port's copy of
`openr_tpu/rpc/tls.py`): `ssl.SSLContext`s built from a `TlsConfig`'s
cert / key / CA triple, with mutual authentication on by default (a
router mesh is the peer-to-peer case client certificates exist for).
"""

from __future__ import annotations

import ssl

# cfg is openr_tpu_torch.config.TlsConfig (duck-typed)


def server_ssl_context(cfg) -> ssl.SSLContext | None:
    if not cfg.enabled:
        return None
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_cert_chain(cfg.cert_path, cfg.key_path)
    if cfg.ca_path:
        ctx.load_verify_locations(cfg.ca_path)
    if cfg.require_client_cert:
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def client_ssl_context(cfg) -> ssl.SSLContext | None:
    if not cfg.enabled:
        return None
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    if cfg.ca_path:
        ctx.load_verify_locations(cfg.ca_path)
    # routers dial each other by IP; identity comes from the CA-signed
    # cert (and mutual auth), not DNS hostnames
    ctx.check_hostname = False
    if cfg.cert_path:
        ctx.load_cert_chain(cfg.cert_path, cfg.key_path)
    return ctx
