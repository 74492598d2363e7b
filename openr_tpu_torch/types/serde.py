"""Wire codecs for the schema dataclasses (the port's copy of
`openr_tpu/types/serde.py`): canonical JSON and compact binary.

  * canonical JSON (`to_wire` / `from_wire`): sorted keys, no spaces, so
    equal objects encode to identical bytes. KvStore hashes them, and
    Decision's byte-splice decode compares them: a `Value`'s payload is
    always canonical JSON.
  * compact binary (`to_wire_bin` / `from_wire_bin`): a (magic, version)
    header, then tag-length-value with varint ints and raw bytes, and
    dataclass fields by position. KvStore's floods and full syncs travel
    in it.

The port's bytes equal the JAX package's for equal objects of the same
schema in both codecs, so peers and journals of either package read each
other. Encoders and decoders are compiled from the dataclass type hints
once per type; fields whose name starts with an underscore are transient
and never encoded. Both codecs are forward-compatible: JSON ignores
unknown field names, binary skips extra trailing fields and defaults
missing ones, so a schema evolves by appending fields with defaults.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import struct
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


def from_jsonable(raw: Any, cls: Type[T]) -> T:
    """Inverse of `to_jsonable`."""
    return _decode(raw, cls)


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


# ====================================================================
# Compact binary codec
#
# Blob layout:   [0xB1 magic][0x01 version][value]
# Value grammar (one tag byte then payload):
#   0x00 None | 0x01 False | 0x02 True
#   0x03 int    zigzag uvarint (arbitrary precision)
#   0x04 float  8-byte IEEE754 big-endian
#   0x05 str    uvarint len + utf-8
#   0x06 bytes  uvarint len + RAW bytes (no hex/base64 detour)
#   0x07 list   uvarint n + n values          (tuples too)
#   0x08 dict   uvarint n + n × (key value)   (keys emitted as str)
#   0x09 dc     uvarint nfields + field values in declaration order
#
# Forward compat: a decoder reading a dataclass with MORE fields than
# it knows skips the extras (values are self-describing); with FEWER,
# the missing trailing fields take their dataclass defaults. Schema
# evolution is therefore append-only — new fields go at the END and
# must carry defaults.
# ====================================================================

WIRE_BIN_MAGIC = 0xB1  # cannot begin a JSON text (and is invalid UTF-8)
WIRE_BIN_VERSION = 0x01

_T_NONE = 0x00
_T_FALSE = 0x01
_T_TRUE = 0x02
_T_INT = 0x03
_T_FLOAT = 0x04
_T_STR = 0x05
_T_BYTES = 0x06
_T_LIST = 0x07
_T_DICT = 0x08
_T_DC = 0x09


class WireDecodeError(ValueError):
    """Malformed binary frame — controlled failure, callers treat it
    exactly like a JSON decode error (ValueError family)."""


def _w_uvarint(out: bytearray, n: int) -> None:
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)


def _r_uvarint(buf, pos: int) -> tuple[int, int]:
    n = 0
    shift = 0
    blen = len(buf)
    while True:
        if pos >= blen:
            raise WireDecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7
        if shift > 70:  # > 10 continuation bytes: corrupt, not just big
            raise WireDecodeError("varint too long")


# the frame layer's length prefixes (rpc/core.py) use this writer
write_uvarint = _w_uvarint


_pack_f8 = struct.Struct(">d").pack
_unpack_f8 = struct.Struct(">d").unpack_from


# ---------------------------------------------------------- generic encode


def _bin_encode_any(v: Any, out: bytearray) -> None:
    """Runtime-typed encoder: used for Any-typed fields and whole RPC
    envelopes (dict/list/primitive trees with raw-bytes leaves)."""
    if v is None:
        out.append(_T_NONE)
    elif v is True:
        out.append(_T_TRUE)
    elif v is False:
        out.append(_T_FALSE)
    elif isinstance(v, int):
        u = v << 1 if v >= 0 else (-v << 1) - 1
        if u >> 77:
            # the decoder's corrupt-stream guard rejects varints past
            # 11 bytes (77 payload bits) — fail at the SENDER with a
            # typed error instead of emitting a frame every receiver
            # silently drops. No schema int comes near this (hashes
            # are 63-bit); only a hand-built RPC envelope can
            raise TypeError(f"int exceeds binary wire range: {v!r}")
        out.append(_T_INT)
        _w_uvarint(out, u)
    elif isinstance(v, float):
        out.append(_T_FLOAT)
        out += _pack_f8(v)
    elif isinstance(v, str):
        b = v.encode()
        out.append(_T_STR)
        _w_uvarint(out, len(b))
        out += b
    elif isinstance(v, (bytes, bytearray, memoryview)):
        out.append(_T_BYTES)
        _w_uvarint(out, len(v))
        out += v
    elif isinstance(v, enum.Enum):
        _bin_encode_any(v.value, out)
    elif dataclasses.is_dataclass(v) and not isinstance(v, type):
        _bin_encoder(type(v))(v, out)
    elif isinstance(v, (list, tuple)):
        out.append(_T_LIST)
        _w_uvarint(out, len(v))
        for x in v:
            _bin_encode_any(x, out)
    elif isinstance(v, dict):
        out.append(_T_DICT)
        _w_uvarint(out, len(v))
        for k, x in v.items():
            ks = str(k).encode()
            out.append(_T_STR)
            _w_uvarint(out, len(ks))
            out += ks
            _bin_encode_any(x, out)
    else:
        raise TypeError(f"cannot binary-encode {type(v)!r}")


# ---------------------------------------------------------- generic decode


def _bin_decode_any(buf, pos: int) -> tuple[Any, int]:
    # tags ordered by frequency (ints and strings dominate Publication
    # and Value trees), 1-byte varint lengths inlined: this runs once per
    # value per flood delivery
    blen = len(buf)
    if pos >= blen:
        raise WireDecodeError("truncated value")
    tag = buf[pos]
    pos += 1
    if tag == _T_INT:
        if pos < blen and buf[pos] < 0x80:  # 1-byte varint fast path
            u = buf[pos]
            pos += 1
        else:
            u, pos = _r_uvarint(buf, pos)
        return (u >> 1) if not u & 1 else -((u + 1) >> 1), pos
    if tag == _T_STR:
        if pos < blen and buf[pos] < 0x80:
            n = buf[pos]
            pos += 1
        else:
            n, pos = _r_uvarint(buf, pos)
        if pos + n > blen:
            raise WireDecodeError("truncated str")
        try:
            return buf[pos : pos + n].decode(), pos + n
        except UnicodeDecodeError as e:
            raise WireDecodeError("bad utf-8 in str") from e
    if tag == _T_BYTES:
        if pos < blen and buf[pos] < 0x80:
            n = buf[pos]
            pos += 1
        else:
            n, pos = _r_uvarint(buf, pos)
        if pos + n > blen:
            raise WireDecodeError("truncated bytes")
        return bytes(buf[pos : pos + n]), pos + n
    if tag == _T_NONE:
        return None, pos
    if tag == _T_TRUE:
        return True, pos
    if tag == _T_FALSE:
        return False, pos
    if tag == _T_FLOAT:
        if pos + 8 > blen:
            raise WireDecodeError("truncated float")
        return _unpack_f8(buf, pos)[0], pos + 8
    if tag in (_T_LIST, _T_DC):
        n, pos = _r_uvarint(buf, pos)
        if n > len(buf) - pos:  # each element needs ≥ 1 byte
            raise WireDecodeError("oversized container count")
        items = []
        for _ in range(n):
            v, pos = _bin_decode_any(buf, pos)
            items.append(v)
        return items, pos
    if tag == _T_DICT:
        n, pos = _r_uvarint(buf, pos)
        if n > (len(buf) - pos) // 2:  # key + value ≥ 2 bytes each
            raise WireDecodeError("oversized dict count")
        d = {}
        for _ in range(n):
            k, pos = _bin_decode_any(buf, pos)
            v, pos = _bin_decode_any(buf, pos)
            d[k] = v
        return d, pos
    raise WireDecodeError(f"unknown tag 0x{tag:02x}")


def _bin_skip(buf, pos: int) -> int:
    """Skip one self-describing value (forward-compat extra fields)."""
    _, pos = _bin_decode_any(buf, pos)
    return pos


# ---------------------------------------------------------- typed encoders

_BIN_ENCODERS: dict[Any, Any] = {}


def _bin_encoder(hint: Any):
    try:
        e = _BIN_ENCODERS.get(hint)
    except TypeError:  # unhashable hint
        return _bin_encode_any
    if e is None:
        e = _build_bin_encoder(hint)
        _BIN_ENCODERS[hint] = e
    return e


def _build_bin_encoder(hint: Any):
    origin = get_origin(hint)
    if origin in (typing.Union, types.UnionType):
        args = [a for a in get_args(hint) if a is not type(None)]
        if len(args) == 1:
            inner = _bin_encoder(args[0])

            def enc_opt(v, out):
                if v is None:
                    out.append(_T_NONE)
                else:
                    inner(v, out)

            return enc_opt
        return _bin_encode_any
    if dataclasses.is_dataclass(hint) and isinstance(hint, type):
        hints = _hints(hint)
        field_encs = [
            (f.name, _bin_encoder(hints[f.name]))
            for f in _wire_fields(hint)
        ]
        nfields = len(field_encs)

        def enc_dc(v, out):
            if v is None:
                out.append(_T_NONE)
                return
            out.append(_T_DC)
            _w_uvarint(out, nfields)
            for name, fe in field_encs:
                fe(getattr(v, name), out)

        return enc_dc
    if origin in (list, tuple):
        args = [a for a in get_args(hint) if a is not Ellipsis] or [Any]
        if origin is tuple and len(args) > 1:
            elem_encs = [_bin_encoder(a) for a in args]
            arity = len(elem_encs)

            def enc_htuple(v, out):
                if v is None:
                    out.append(_T_NONE)
                    return
                out.append(_T_LIST)
                # the emitted count must match the emitted values: a
                # runtime tuple longer than the hint (the codec is as
                # lax as the JSON one about hint/value drift) encodes
                # its extras by runtime type — truncating the zip would
                # desync the count and corrupt every following field
                _w_uvarint(out, len(v))
                for i, x in enumerate(v):
                    if i < arity:
                        elem_encs[i](x, out)
                    else:
                        _bin_encode_any(x, out)

            return enc_htuple
        item = _bin_encoder(args[0])

        def enc_seq(v, out):
            if v is None:
                out.append(_T_NONE)
                return
            out.append(_T_LIST)
            _w_uvarint(out, len(v))
            for x in v:
                item(x, out)

        return enc_seq
    if origin is dict:
        args = get_args(hint)
        val_enc = _bin_encoder(args[1]) if args else _bin_encode_any

        def enc_dict(v, out):
            if v is None:
                out.append(_T_NONE)
                return
            out.append(_T_DICT)
            _w_uvarint(out, len(v))
            for k, x in v.items():
                ks = str(k).encode()
                out.append(_T_STR)
                _w_uvarint(out, len(ks))
                out += ks
                val_enc(x, out)

        return enc_dict
    # primitives / enums / Any: runtime dispatch (cheap, and as lax as
    # the JSON codec about hint-vs-value mismatches)
    return _bin_encode_any


# ---------------------------------------------------------- typed decoders

_BIN_DECODERS: dict[Any, Any] = {}


def _bin_decoder(hint: Any):
    try:
        d = _BIN_DECODERS.get(hint)
    except TypeError:
        return _bin_decode_any
    if d is None:
        d = _build_bin_decoder(hint)
        _BIN_DECODERS[hint] = d
    return d


def _build_bin_decoder(hint: Any):
    origin = get_origin(hint)
    if origin in (typing.Union, types.UnionType):
        args = [a for a in get_args(hint) if a is not type(None)]
        if len(args) == 1:
            inner = _bin_decoder(args[0])

            def dec_opt(buf, pos):
                if pos < len(buf) and buf[pos] == _T_NONE:
                    return None, pos + 1
                return inner(buf, pos)

            return dec_opt
        return _bin_decode_any
    if isinstance(hint, type) and issubclass(hint, enum.Enum):

        def dec_enum(buf, pos):
            v, pos = _bin_decode_any(buf, pos)
            if v is None:
                return None, pos
            try:
                return hint(v), pos
            except ValueError as e:
                raise WireDecodeError(f"bad enum value {v!r}") from e

        return dec_enum
    if dataclasses.is_dataclass(hint):
        hints = _hints(hint)
        field_decs = [
            (f.name, _bin_decoder(hints[f.name]))
            for f in _wire_fields(hint)
        ]
        dec_fns = [fd for _, fd in field_decs]
        nfields = len(dec_fns)
        # positional construction is measurably faster than kwargs, but
        # only valid when the wire fields are exactly the leading
        # __init__ parameters (no transient/init=False field interleaved)
        init_names = [
            f.name for f in dataclasses.fields(hint) if f.init
        ]
        positional = init_names[:nfields] == [n for n, _ in field_decs]

        def dec_dc(buf, pos):
            blen = len(buf)
            if pos >= blen:
                raise WireDecodeError("truncated dataclass")
            tag = buf[pos]
            pos += 1
            if tag == _T_NONE:
                return None, pos
            if tag != _T_DC:
                raise WireDecodeError(
                    f"expected dataclass tag, got 0x{tag:02x}"
                )
            if pos < blen and buf[pos] < 0x80:  # 1-byte count fast path
                n = buf[pos]
                pos += 1
            else:
                n, pos = _r_uvarint(buf, pos)
            if n > blen - pos:
                raise WireDecodeError("oversized field count")
            try:
                if positional:
                    args = []
                    for i in range(n):
                        if i < nfields:
                            v, pos = dec_fns[i](buf, pos)
                            args.append(v)
                        else:  # newer peer appended unknown fields
                            pos = _bin_skip(buf, pos)
                    return hint(*args), pos
                kwargs = {}
                for i in range(n):
                    if i < nfields:
                        name, fd = field_decs[i]
                        kwargs[name], pos = fd(buf, pos)
                    else:
                        pos = _bin_skip(buf, pos)
                return hint(**kwargs), pos
            except TypeError as e:  # older peer omitted a required field
                raise WireDecodeError(f"bad {hint.__name__}: {e}") from e

        return dec_dc
    if origin in (list, tuple):
        args = [a for a in get_args(hint) if a is not Ellipsis] or [Any]
        if origin is tuple and len(args) > 1:
            elem_decs = [_bin_decoder(a) for a in args]

            def dec_htuple(buf, pos):
                items, pos = _read_list_header(buf, pos)
                if items is None:
                    return None, pos
                n = items
                out = []
                for i in range(n):
                    if i < len(elem_decs):
                        v, pos = elem_decs[i](buf, pos)
                        out.append(v)
                    else:
                        pos = _bin_skip(buf, pos)
                return tuple(out), pos

            return dec_htuple
        item = _bin_decoder(args[0])
        wrap = tuple if origin is tuple else list

        def dec_seq(buf, pos):
            n, pos = _read_list_header(buf, pos)
            if n is None:
                return None, pos
            out = []
            for _ in range(n):
                v, pos = item(buf, pos)
                out.append(v)
            return wrap(out), pos

        return dec_seq
    if origin is dict:
        args = get_args(hint)
        key_hint, val_hint = args if args else (str, Any)
        val_dec = _bin_decoder(val_hint)

        str_keys = key_hint is str

        def dec_dict(buf, pos):
            blen = len(buf)
            if pos >= blen:
                raise WireDecodeError("truncated dict")
            tag = buf[pos]
            pos += 1
            if tag == _T_NONE:
                return None, pos
            if tag != _T_DICT:
                raise WireDecodeError(f"expected dict, got 0x{tag:02x}")
            n, pos = _r_uvarint(buf, pos)
            if n > (blen - pos) // 2:
                raise WireDecodeError("oversized dict count")
            d = {}
            for _ in range(n):
                # keys are emitted as str: inline the short-string
                # decode (the flood hot path walks one per key_val)
                if (
                    str_keys
                    and pos + 1 < blen
                    and buf[pos] == _T_STR
                    and buf[pos + 1] < 0x80
                ):
                    kn = buf[pos + 1]
                    kend = pos + 2 + kn
                    if kend > blen:
                        raise WireDecodeError("truncated str")
                    try:
                        k = buf[pos + 2 : kend].decode()
                    except UnicodeDecodeError as e:
                        raise WireDecodeError("bad utf-8 in str") from e
                    pos = kend
                else:
                    k, pos = _bin_decode_any(buf, pos)
                    k = _decode_key(k, key_hint)
                v, pos = val_dec(buf, pos)
                d[k] = v
            return d, pos

        return dec_dict
    # primitives / Any: self-describing (same laxness as the JSON codec)
    return _bin_decode_any


def _read_list_header(buf, pos):
    if pos >= len(buf):
        raise WireDecodeError("truncated list")
    tag = buf[pos]
    pos += 1
    if tag == _T_NONE:
        return None, pos
    if tag != _T_LIST:
        raise WireDecodeError(f"expected list, got 0x{tag:02x}")
    n, pos = _r_uvarint(buf, pos)
    if n > len(buf) - pos:
        raise WireDecodeError("oversized list count")
    return n, pos


# ------------------------------------------------------------ entry points

_BIN_HEADER = bytes((WIRE_BIN_MAGIC, WIRE_BIN_VERSION))


def to_wire_bin(obj: Any) -> bytes:
    """Serialize to the compact binary wire form (magic + version +
    TLV value). Schema dataclasses encode positionally; generic trees
    (RPC envelopes) encode by runtime type."""
    out = bytearray(_BIN_HEADER)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        _bin_encoder(type(obj))(obj, out)
    else:
        _bin_encode_any(obj, out)
    return bytes(out)


def from_wire_bin(data: bytes, cls: Type[T] | None = None) -> T:
    """Inverse of :func:`to_wire_bin`. With `cls`, decodes through the
    compiled schema decoders; without, returns the generic value tree
    (dicts/lists/primitives/bytes — RPC envelopes). Every failure mode
    raises :class:`WireDecodeError` (a ValueError)."""
    if len(data) < 2:
        raise WireDecodeError("short frame")
    if data[0] != WIRE_BIN_MAGIC:
        raise WireDecodeError(f"bad magic 0x{data[0]:02x}")
    if data[1] != WIRE_BIN_VERSION:
        raise WireDecodeError(f"unsupported wire version {data[1]}")
    try:
        if cls is None:
            val, pos = _bin_decode_any(data, 2)
        else:
            val, pos = _bin_decoder(cls)(data, 2)
    except WireDecodeError:
        raise
    except (IndexError, struct.error, OverflowError, RecursionError,
            TypeError, ValueError) as e:
        raise WireDecodeError(f"corrupt frame: {e}") from e
    if pos != len(data):
        raise WireDecodeError(f"{len(data) - pos} trailing bytes")
    return val


def from_wire_auto(data: bytes, cls: Type[T]) -> T:
    """Codec-sniffing decode for seams that accept either framing:
    binary frames lead with the magic byte, which can never begin a JSON
    text."""
    if data[:1] == _BIN_HEADER[:1]:
        return from_wire_bin(data, cls)
    return from_wire(data, cls)


# ------------------------------------------------ wire type registry
#
# Every dataclass that travels through either codec, and a canonical
# rendering of each type's positional contract (`wire_schema_of`), which
# the JAX package commits as its wire-schema lock. Modules that define
# wire types register them at import time; `registered_wire_types` adds
# every nested dataclass or enum a registered type references.

_WIRE_TYPES: dict[str, type] = {}


def register_wire_types(*classes: type) -> None:
    """Declare dataclasses as wire schema types."""
    for cls in classes:
        if not (isinstance(cls, type) and dataclasses.is_dataclass(cls)):
            raise TypeError(f"not a dataclass type: {cls!r}")
        prev = _WIRE_TYPES.get(cls.__name__)
        if prev is not None and prev is not cls:
            raise ValueError(
                f"wire type name collision: {cls.__name__} "
                f"({prev.__module__} vs {cls.__module__})"
            )
        _WIRE_TYPES[cls.__name__] = cls


def _reachable_schema_types(hint: Any) -> list[type]:
    """Dataclass / Enum classes inside a field hint, through Optional,
    union, list/tuple/dict nesting."""
    found: list[type] = []
    stack = [hint]
    seen: set[int] = set()
    while stack:
        h = stack.pop()
        if id(h) in seen:
            continue
        seen.add(id(h))
        if isinstance(h, type):
            if dataclasses.is_dataclass(h) or issubclass(h, enum.Enum):
                found.append(h)
            continue
        stack.extend(get_args(h))
    return found


def registered_wire_types() -> dict[str, type]:
    """Every registered wire type plus every dataclass/enum reachable
    through registered types' field hints, sorted by name. Reachability
    is what makes lock coverage structural: a nested type joins the
    lock the moment any registered type references it."""
    out: dict[str, type] = {}
    stack = list(_WIRE_TYPES.values())
    while stack:
        cls = stack.pop()
        if cls.__name__ in out:
            continue
        out[cls.__name__] = cls
        if dataclasses.is_dataclass(cls):
            hints = _hints(cls)
            for f in _wire_fields(cls):
                stack.extend(
                    t
                    for t in _reachable_schema_types(hints[f.name])
                    if t.__name__ not in out
                )
    return dict(sorted(out.items()))


def normalize_type_str(ann: Any) -> str:
    """Canonical rendering of a field annotation for the lock: the
    source annotation string (PEP 563 — every schema module uses
    ``from __future__ import annotations``) with whitespace and quote
    characters stripped, so formatting churn can never read as drift."""
    if not isinstance(ann, str):
        ann = getattr(ann, "__name__", None) or repr(ann)
    return ann.replace(" ", "").replace('"', "").replace("'", "")


def _default_token(f: dataclasses.Field) -> str | None:
    """Stable token for a field's default: None means REQUIRED (no
    default — appends without one are a breaking schema change)."""
    if f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
        return f"factory:{getattr(f.default_factory, '__name__', '?')}"
    if f.default is dataclasses.MISSING:
        return None
    v = f.default
    if isinstance(v, enum.Enum):
        return f"{type(v).__name__}.{v.name}"
    return repr(v)


def wire_schema_of(cls: type) -> dict:
    """Canonical schema dict of one registered type, as committed in
    ``wire_schema.lock.json``: positional field order, normalized type
    strings, default presence, transient-underscore exclusions; enums
    lock their member→value map (renumbering is wire drift too)."""
    if isinstance(cls, type) and issubclass(cls, enum.Enum):
        return {
            "kind": "enum",
            "module": cls.__module__,
            "members": {m.name: int(m.value) for m in cls},
        }
    return {
        "kind": "dataclass",
        "module": cls.__module__,
        "fields": [
            {
                "name": f.name,
                "type": normalize_type_str(f.type),
                "default": _default_token(f),
            }
            for f in _wire_fields(cls)
        ],
        "transient": [
            f.name for f in dataclasses.fields(cls) if f.name.startswith("_")
        ],
    }
