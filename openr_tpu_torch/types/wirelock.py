"""The wire-schema lock's reader (the port's copy of `load_lock` and
`locked_version` of `openr_tpu/types/wirelock.py`).

`wire_schema.lock.json` beside this file is the committed schema of the
wire: every registered dataclass and enum and the RPC names. The port
speaks the same wire as the JAX package, so it keeps the same lock and
its `lock_version` is the JAX package's (`tests/test_torch_node.py`
holds the copy byte-equal to that lock). OpenrNode stamps it as the
`wire.schema_lock_version` gauge. The lock's extraction, drift check and
golden frames are not part of the port.
"""

from __future__ import annotations

import json
import pathlib

LOCK_FILENAME = "wire_schema.lock.json"
LOCK_PATH = pathlib.Path(__file__).resolve().parent / LOCK_FILENAME


def load_lock(path: pathlib.Path | None = None) -> dict | None:
    p = path or LOCK_PATH
    try:
        return json.loads(p.read_text())
    except FileNotFoundError:
        return None


_VERSION_CACHE: list = []


def locked_version() -> int | None:
    """`lock_version` of the committed lock, read once a process; None
    only when the lock is missing."""
    if not _VERSION_CACHE:
        lock = load_lock()
        _VERSION_CACHE.append(
            None if lock is None else lock["lock_version"]
        )
    return _VERSION_CACHE[0]
