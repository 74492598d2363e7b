"""Canonical JSON wire codec for the schema dataclasses (the port's copy
of the JSON half of `openr_tpu/types/serde.py`; its compact binary codec
and type registry are not part of the port).

`to_wire` sorts keys and drops spaces, so equal objects encode to
identical bytes: KvStore hashes them, and Decision's byte-splice decode
compares them. The port's bytes equal the JAX package's for equal
objects of the same schema. Encoders and decoders are compiled from the
dataclass type hints once per type; fields whose name starts with an
underscore are transient and never encoded. Unknown field names are
ignored on decode.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import types
import typing
from typing import Any, Type, TypeVar, get_args, get_origin, get_type_hints

T = TypeVar("T")

_HINTS_CACHE: dict[type, dict[str, Any]] = {}


def _hints(cls: type) -> dict[str, Any]:
    h = _HINTS_CACHE.get(cls)
    if h is None:
        h = get_type_hints(cls)
        _HINTS_CACHE[cls] = h
    return h


_ENC_FIELDS: dict[type, tuple[str, ...]] = {}


def _enc_fields(cls: type) -> tuple[str, ...]:
    names = _ENC_FIELDS.get(cls)
    if names is None:
        # leading-underscore fields are transient (e.g. Publication's
        # encoded-frame cache) — never serialized by either codec
        names = tuple(
            f.name
            for f in dataclasses.fields(cls)
            if not f.name.startswith("_")
        )
        _ENC_FIELDS[cls] = names
    return names


def _wire_fields(cls: type):
    """Dataclass fields that travel on the wire, in declaration order
    (the binary codec's positional contract — append-only evolution)."""
    return [
        f for f in dataclasses.fields(cls) if not f.name.startswith("_")
    ]


def _encode(obj: Any) -> Any:
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, bytes):
        return {"__bytes__": obj.hex()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            name: _encode(getattr(obj, name))
            for name in _enc_fields(type(obj))
        }
    if isinstance(obj, (list, tuple)):
        return [_encode(x) for x in obj]
    if isinstance(obj, dict):
        return {str(k): _encode(v) for k, v in obj.items()}
    raise TypeError(f"cannot encode {type(obj)!r}")


# Compiled decoders: all the reflective dispatch (get_origin/get_args/
# dataclass fields) runs ONCE per hint, producing a closure tree; the
# per-message work is plain dict/closure calls. Measured ~3x on the
# churn hot path (Decision re-parsing AdjacencyDatabases per flap).
_DECODERS: dict[Any, Any] = {}


def _identity(raw):
    """Marker decoder for pass-through fields: _build_decoder returns
    THIS object so dec_dc can skip the call entirely (identity fields
    dominate real messages — all-primitive dataclasses like Adjacency
    then decode with one dict-splat construction)."""
    return raw


def _decoder(hint: Any):
    try:
        d = _DECODERS.get(hint)
    except TypeError:  # unhashable hint — fall back to a fresh build
        return _build_decoder(hint)
    if d is None:
        d = _build_decoder(hint)
        _DECODERS[hint] = d
    return d


def _build_decoder(hint: Any):
    origin = get_origin(hint)
    if origin in (typing.Union, types.UnionType):  # Optional[X] and unions
        args = [a for a in get_args(hint) if a is not type(None)]
        if len(args) == 1:
            inner = _decoder(args[0])

            def dec_opt(raw):
                return None if raw is None else inner(raw)

            return dec_opt
        return _identity  # heterogeneous unions: pass through
    if hint is bytes:

        def dec_bytes(raw):
            if raw is None:
                return None
            if isinstance(raw, dict) and "__bytes__" in raw:
                return bytes.fromhex(raw["__bytes__"])
            raise TypeError(f"expected bytes payload, got {raw!r}")

        return dec_bytes
    if isinstance(hint, type) and issubclass(hint, enum.Enum):
        return lambda raw: None if raw is None else hint(raw)
    if dataclasses.is_dataclass(hint):
        hints = _hints(hint)
        field_decs = [
            (f.name, _decoder(hints[f.name])) for f in _wire_fields(hint)
        ]
        conv = [(n, fd) for n, fd in field_decs if fd is not _identity]
        if not conv:
            # every field decodes as-is: one dict-splat construction.
            # Unknown keys (a newer peer's extra field) TypeError out of
            # __init__ — fall back to the filtering path for those.
            known = frozenset(n for n, _fd in field_decs)

            def dec_dc_fast(raw):
                if raw is None:
                    return None
                try:
                    return hint(**raw)
                except TypeError:
                    return hint(
                        **{k: v for k, v in raw.items() if k in known}
                    )

            return dec_dc_fast

        ident = [n for n, fd in field_decs if fd is _identity]

        def dec_dc(raw):
            if raw is None:
                return None
            kwargs = {n: raw[n] for n in ident if n in raw}
            for name, fd in conv:
                if name in raw:
                    kwargs[name] = fd(raw[name])
            return hint(**kwargs)

        return dec_dc
    if origin in (list, tuple):
        args = [a for a in get_args(hint) if a is not Ellipsis] or [Any]
        if origin is tuple and len(args) > 1:  # heterogeneous tuple
            elem_decs = [_decoder(a) for a in args]

            def dec_htuple(raw):
                if raw is None:
                    return None
                return tuple(d(x) for x, d in zip(raw, elem_decs))

            return dec_htuple
        item = _decoder(args[0])
        if item is _identity:
            if origin is tuple:
                return lambda raw: None if raw is None else tuple(raw)
            return lambda raw: None if raw is None else list(raw)
        if origin is tuple:
            return lambda raw: (
                None if raw is None else tuple([item(x) for x in raw])
            )
        return lambda raw: (
            None if raw is None else [item(x) for x in raw]
        )
    if origin is dict:
        args = get_args(hint)
        key_hint, val_hint = args if args else (str, Any)
        val_dec = _decoder(val_hint)

        def dec_dict(raw):
            if raw is None:
                return None
            return {
                _decode_key(k, key_hint): val_dec(v)
                for k, v in raw.items()
            }

        return dec_dict
    return _identity


def _decode(raw: Any, hint: Any) -> Any:
    return _decoder(hint)(raw)


def _decode_key(k: str, hint: Any) -> Any:
    if hint is int:
        return int(k)
    # Frozen single-str-field dataclasses (e.g. IpPrefix) encode as str(obj);
    # reconstruct from that string so dataclass-keyed dicts round-trip. Use
    # the type's canonicalizing `make` when it has one, so a non-canonical
    # key from a peer can't create a second unequal key for the same object.
    if dataclasses.is_dataclass(hint):
        if hasattr(hint, "make"):
            return hint.make(k)
        flds = dataclasses.fields(hint)
        if len(flds) == 1:
            return hint(**{flds[0].name: k})
        raise TypeError(f"cannot decode dict key {k!r} as {hint!r}")
    return k


# Compiled encoders, symmetric with the decoders: hint-driven closure
# trees built once per type. Values come from our own schema dataclasses,
# so the type hints are trustworthy; anything surprising falls back to
# the generic reflective _encode.
_ENCODERS: dict[Any, Any] = {}


def _encoder(hint: Any):
    try:
        e = _ENCODERS.get(hint)
    except TypeError:
        return _encode
    if e is None:
        e = _build_encoder(hint)
        _ENCODERS[hint] = e
    return e


def _build_encoder(hint: Any):
    origin = get_origin(hint)
    if hint in (int, str, bool, float) or hint is Any:
        return lambda v: v
    if origin in (typing.Union, types.UnionType):
        args = [a for a in get_args(hint) if a is not type(None)]
        if len(args) == 1:
            inner = _encoder(args[0])
            return lambda v: None if v is None else inner(v)
        return _encode
    if hint is bytes:
        return lambda v: None if v is None else {"__bytes__": v.hex()}
    if isinstance(hint, type) and issubclass(hint, enum.Enum):
        return lambda v: None if v is None else v.value
    if dataclasses.is_dataclass(hint) and isinstance(hint, type):
        hints = _hints(hint)
        field_encs = [
            (f.name, _encoder(hints[f.name])) for f in _wire_fields(hint)
        ]

        def enc_dc(v):
            if v is None:
                return None
            return {name: fe(getattr(v, name)) for name, fe in field_encs}

        return enc_dc
    if origin in (list, tuple):
        args = [a for a in get_args(hint) if a is not Ellipsis] or [Any]
        if origin is tuple and len(args) > 1:
            elem_encs = [_encoder(a) for a in args]
            return lambda v: (
                None if v is None
                else [e(x) for x, e in zip(v, elem_encs)]
            )
        item = _encoder(args[0])
        return lambda v: None if v is None else [item(x) for x in v]
    if origin is dict:
        args = get_args(hint)
        val_enc = _encoder(args[1]) if args else _encode
        return lambda v: (
            None if v is None
            else {str(k): val_enc(x) for k, x in v.items()}
        )
    return _encode


def to_jsonable(obj: Any) -> Any:
    """Dataclass → plain JSON-ready dict/list tree (no string encoding).

    Use this when embedding a schema object inside a larger RPC message —
    the transport serializes once at the socket boundary instead of
    round-tripping every nested object through its own JSON string.
    """
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _encoder(type(obj))(obj)
    return _encode(obj)


def to_wire(obj: Any) -> bytes:
    """Serialize a schema dataclass to canonical JSON bytes.

    Canonical: sorted keys, compact separators — equal objects always
    produce identical bytes, which KvStore hashes for conflict resolution
    (reference: openr/kvstore/KvStore.cpp † mergeKeyValues hash tiebreak).
    """
    return json.dumps(
        to_jsonable(obj), sort_keys=True, separators=(",", ":")
    ).encode()


def from_wire(data: bytes | str, cls: Type[T]) -> T:
    """Deserialize canonical JSON bytes into a schema dataclass."""
    raw = json.loads(data)
    return _decode(raw, cls)


def decoder_for(cls: Type[T]):
    """The compiled raw→object decoder closure for `cls` (the same one
    `from_wire` dispatches through). Exposed for callers that decode
    many sibling objects from pre-parsed JSON and want to skip the
    per-call registry lookup — e.g. Decision's churn-path adjacency
    decode, which reuses unchanged sub-objects across versions."""
    return _decoder(cls)
