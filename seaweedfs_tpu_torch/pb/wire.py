"""A small protobuf message runtime: classes from field tables, wire codec.

The card's machine has no protobuf package, so the port carries the JAX
package's ``master_pb``/``volume_server_pb`` messages itself. Each message
is a class built by ``message(name, fields)`` from one table of
``(name, number, kind[, REPEATED | SINGLE, message class name])``; the
names, numbers and kinds are those of the JAX package's ``_pb2``
descriptors (a test holds them equal), and ``SerializeToString`` gives
the bytes protobuf gives for the same values.

proto3 semantics kept:
  - scalars default to zero / "" / b"" / False and are not written when
    they hold that default (a float or double is written unless its bits
    are all zero, so -0.0 goes out);
  - repeated fields default to an empty list; repeated numeric fields are
    written packed and read packed or not;
  - a singular message field reads as an empty message until set; it is
    written once it has been assigned, or once anything below it was
    assigned, even if it is then empty;
  - fields go out in field-number order; unknown fields are skipped on
    read;
  - a map field (``("name", n, "map", key kind, value kind or message
    class name)``) reads and writes as a dict; each pair goes out as one
    entry message with its key (1) and its value (2) both written, in
    protobuf's deterministic order (``_map_order``); a message value is
    made on first access, as protobuf's maps do.

proto2 (``message(..., syntax="proto2")``, for ``hbase_pb2``): a field is
optional unless its label says ``REQUIRED`` or ``REPEATED``, and a
sixth entry of its row is its ``[default = ...]``. A singular field that
was assigned is present and written even when it holds its default, and
``HasField`` says so; one never assigned reads as its default and is not
written. Repeated numbers are written unpacked. ``SerializeToString``
raises ``EncodeError`` naming every required field that is missing, as
protobuf does (``ByteSize`` and parsing do not check). An ``"enum"``
field is a varint read as int32; ``enum_type`` makes the enum's class,
whose values ``resolve`` also sets on the message or module that holds
it.
"""

from __future__ import annotations

import functools
import struct
from typing import Dict, List, Tuple

REPEATED = "repeated"
SINGLE = "single"
REQUIRED = "required"

_VARINT = {"bool", "uint32", "uint64", "int32", "int64", "enum"}
_DEFAULTS = {"string": "", "bytes": b"", "bool": False, "uint32": 0,
             "uint64": 0, "int32": 0, "int64": 0, "float": 0.0,
             "double": 0.0, "fixed32": 0, "enum": 0}
_WIRE_TYPE = {"float": 5, "double": 1, "fixed32": 5, "string": 2,
              "bytes": 2, "message": 2, "map": 2}
_FIXED = {"float": ("<f", 4), "double": ("<d", 8), "fixed32": ("<I", 4)}
_MASK64 = (1 << 64) - 1


class DecodeError(ValueError):
    pass


class EncodeError(ValueError):
    pass


class _Field:
    __slots__ = ("name", "number", "kind", "repeated", "required",
                 "default", "has_default", "type_name", "cls", "key",
                 "packed_key", "map_key", "map_value")

    def __init__(self, name, number, kind, label=None, type_name=None,
                 default=None):
        if kind not in _DEFAULTS and kind not in ("message", "map"):
            raise ValueError(f"field {name}: unsupported kind {kind!r}")
        self.name = name
        self.number = number
        self.kind = kind
        self.map_key = self.map_value = None
        if kind == "map":
            # ("name", n, "map", key kind, value kind | message class)
            self.map_key = label
            self.map_value = type_name if type_name in _DEFAULTS \
                else "message"
            label = None
        self.repeated = label == REPEATED
        self.required = label == REQUIRED
        # an enum without [default] reads as its first value (resolve)
        self.has_default = default is not None
        self.default = _DEFAULTS.get(kind) if default is None else default
        self.type_name = type_name
        self.cls = None          # resolved message or enum class
        wt = 0 if kind in _VARINT else _WIRE_TYPE[kind]
        self.key = _varint((number << 3) | wt)
        self.packed_key = _varint((number << 3) | 2)


def _varint(v: int) -> bytes:
    v &= _MASK64
    out = bytearray()
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _read_varint(buf, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & _MASK64, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint too long")


def _signed(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _scalar_bytes(kind: str, v) -> bytes:
    if kind in _VARINT:
        return _varint(int(v))
    if kind in _FIXED:
        return struct.pack(_FIXED[kind][0], v)
    if kind == "string":
        b = v.encode("utf-8")
        return _varint(len(b)) + b
    b = bytes(v)
    return _varint(len(b)) + b


def _is_default(kind: str, v) -> bool:
    if kind in ("float", "double"):
        return struct.pack("<d", v) == b"\0" * 8
    return not v


def _from_varint(kind: str, v: int):
    if kind == "bool":
        return v != 0
    if kind == "uint32":
        return v & 0xFFFFFFFF
    if kind in ("int32", "enum"):
        return _signed(v, 32)
    if kind == "int64":
        return _signed(v, 64)
    return v


class _Repeated(list):
    """A repeated field: a list that marks its owner set when changed, and
    ``add(**fields)`` for repeated messages, as protobuf's containers."""

    __slots__ = ("_owner", "_cls")

    def __init__(self, owner, cls, items=()):
        super().__init__(items)
        self._owner = owner
        self._cls = cls

    def _touch(self):
        self._owner._touch()

    def add(self, **kwargs):
        m = self._cls(**kwargs)
        self.append(m)
        return m

    def append(self, v):
        super().append(v)
        self._touch()

    def extend(self, vs):
        super().extend(vs)
        self._touch()

    def __setitem__(self, i, v):
        super().__setitem__(i, v)
        self._touch()


class _Map(dict):
    """A map field: a dict that marks its owner set when changed; a
    message value is made on first access (``m[k].field = ...``)."""

    __slots__ = ("_owner", "_cls")

    def __init__(self, owner, cls, items=()):
        super().__init__(items)
        self._owner = owner
        self._cls = cls

    def __missing__(self, key):
        if self._cls is None:
            raise KeyError(key)
        v = self._cls()
        object.__setattr__(v, "_parent", self._owner)
        self[key] = v
        return v

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self._owner._touch()

    def __delitem__(self, key):
        super().__delitem__(key)
        self._owner._touch()

    def update(self, *args, **kwargs):
        super().update(*args, **kwargs)
        self._owner._touch()


class Message:
    """Base of every port message; subclasses come from ``message()``."""

    _FIELDS: Tuple[_Field, ...] = ()
    _BY_NAME: Dict[str, _Field] = {}
    _BY_NUMBER: Dict[int, _Field] = {}
    _PROTO2 = False
    FULL_NAME = ""

    __slots__ = ("_values", "_present", "_parent")

    def __init__(self, **kwargs):
        object.__setattr__(self, "_values", {})
        object.__setattr__(self, "_present", False)
        object.__setattr__(self, "_parent", None)
        for k, v in kwargs.items():
            setattr(self, k, v)

    # -- attribute access ----------------------------------------------------

    def __getattr__(self, name):
        f = self._BY_NAME.get(name)
        if f is None:
            raise AttributeError(
                f"{type(self).__name__} has no field {name!r}")
        values = self._values
        v = values.get(name)
        if v is not None:
            return v
        if f.repeated:
            v = _Repeated(self, f.cls)
            values[name] = v
            return v
        if f.kind == "map":
            v = _Map(self, f.cls)
            values[name] = v
            return v
        if f.kind == "message":
            # made on access, present only once something is set below it
            v = f.cls()
            object.__setattr__(v, "_parent", self)
            values[name] = v
            return v
        return f.default

    def __setattr__(self, name, value):
        f = self._BY_NAME.get(name)
        if f is None:
            raise AttributeError(
                f"{type(self).__name__} has no field {name!r}")
        if f.repeated:
            value = _Repeated(self, f.cls, value)
        elif f.kind == "map":
            value = _Map(self, f.cls, value)
        elif f.kind == "message":
            if value is not None and not isinstance(value, f.cls):
                raise TypeError(f"{name}: expected {f.cls.__name__}, "
                                f"got {type(value).__name__}")
            if value is not None:
                object.__setattr__(value, "_present", True)
        elif f.kind in _VARINT:
            value = bool(value) if f.kind == "bool" else int(value)
        elif f.kind in ("float", "double"):
            value = float(value)
        elif f.kind == "fixed32":
            value = int(value)
        elif f.kind == "string" and not isinstance(value, str):
            raise TypeError(f"{name}: expected str, got "
                            f"{type(value).__name__}")
        self._values[name] = value
        self._touch()

    def _touch(self):
        """Something below this message was set: it, and every message
        above it, is now present."""
        m = self
        while m is not None and not m._present:
            object.__setattr__(m, "_present", True)
            m = m._parent

    def HasField(self, name: str) -> bool:
        f = self._BY_NAME[name]
        if f.repeated or f.kind == "map":
            raise ValueError(f"{name} is repeated")
        v = self._values.get(name)
        if f.kind == "message":
            return v is not None and v._present
        if self._PROTO2:
            return v is not None
        return v is not None and not _is_default(f.kind, v)

    def IsInitialized(self) -> bool:
        return not self._missing("")

    def _missing(self, prefix: str) -> List[str]:
        """The paths of the required fields left unset, in protobuf's
        order: this message's own first, then those below each set
        message field (``get``, ``region.type``, ``column[0].family``)."""
        if not self._PROTO2:
            return []
        values = self._values
        out = [prefix + f.name for f in self._FIELDS
               if f.required and not self.HasField(f.name)]
        for f in self._FIELDS:
            v = values.get(f.name)
            if f.kind != "message" or v is None:
                continue
            if f.repeated:
                for i, m in enumerate(v):
                    out += m._missing(f"{prefix}{f.name}[{i}].")
            elif v._present:
                out += v._missing(f"{prefix}{f.name}.")
        return out

    # -- codec ---------------------------------------------------------------

    def SerializeToString(self) -> bytes:
        if self._PROTO2:
            missing = self._missing("")
            if missing:
                raise EncodeError(f"Message {self.FULL_NAME} is missing "
                                  f"required fields: {','.join(missing)}")
        return self._bytes()

    def _bytes(self) -> bytes:
        out: List[bytes] = []
        self._encode(out)
        return b"".join(out)

    def ByteSize(self) -> int:
        return len(self._bytes())

    def CopyFrom(self, other: "Message") -> None:
        """Make this message equal to ``other`` (a deep copy)."""
        if other is self:
            return
        if type(other) is not type(self):
            raise TypeError(f"CopyFrom: expected {type(self).__name__}, "
                            f"got {type(other).__name__}")
        self._values.clear()
        self._decode(memoryview(other._bytes()))
        self._touch()

    def MergeFromString(self, data) -> int:
        self._decode(memoryview(data))
        self._touch()
        return len(data)

    def ParseFromString(self, data) -> int:
        self._values.clear()
        return self.MergeFromString(data)

    def _encode(self, out: List[bytes]) -> None:
        values = self._values
        for f in self._FIELDS:
            v = values.get(f.name)
            if v is None:
                continue
            kind = f.kind
            if f.repeated:
                if not v:
                    continue
                if kind == "message":
                    for m in v:
                        body = m._bytes()
                        out.append(f.key + _varint(len(body)) + body)
                elif kind in ("string", "bytes") or self._PROTO2:
                    for s in v:
                        out.append(f.key + _scalar_bytes(kind, s))
                else:
                    body = b"".join(_scalar_bytes(kind, s) for s in v)
                    out.append(f.packed_key + _varint(len(body)) + body)
            elif kind == "map":
                for k in _map_order(v, f.map_key):
                    body = _entry_bytes(f, k, v[k])
                    out.append(f.key + _varint(len(body)) + body)
            elif kind == "message":
                if v._present:
                    body = v._bytes()
                    out.append(f.key + _varint(len(body)) + body)
            elif self._PROTO2 or not _is_default(kind, v):
                out.append(f.key + _scalar_bytes(kind, v))

    @classmethod
    def FromString(cls, data) -> "Message":
        m = cls()
        m._decode(memoryview(data))
        return m

    def _decode(self, buf: memoryview) -> None:
        pos, end = 0, len(buf)
        values = self._values
        while pos < end:
            key, pos = _read_varint(buf, pos)
            number, wt = key >> 3, key & 7
            f = self._BY_NUMBER.get(number)
            if wt == 0:
                v, pos = _read_varint(buf, pos)
                raw = None
            elif wt == 1:
                raw, pos = buf[pos:pos + 8], pos + 8
            elif wt == 5:
                raw, pos = buf[pos:pos + 4], pos + 4
            elif wt == 2:
                n, pos = _read_varint(buf, pos)
                raw, pos = buf[pos:pos + n], pos + n
            else:
                raise DecodeError(f"unsupported wire type {wt}")
            if pos > end:
                raise DecodeError("truncated message")
            if f is None:
                continue            # unknown field
            kind = f.kind
            if kind == "map":
                k, val = _read_entry(f, raw)
                m = values.get(f.name)
                if m is None:
                    m = values[f.name] = _Map(self, f.cls)
                dict.__setitem__(m, k, val)
                if f.cls is not None:
                    object.__setattr__(val, "_parent", self)
            elif kind == "message":
                sub = f.cls.FromString(raw)
                object.__setattr__(sub, "_present", True)
                if f.repeated:
                    values.setdefault(f.name, _Repeated(self, f.cls)) \
                        .append(sub)
                else:
                    values[f.name] = sub
            elif kind in ("string", "bytes"):
                s = bytes(raw)
                if kind == "string":
                    s = s.decode("utf-8")
                if f.repeated:
                    values.setdefault(f.name, _Repeated(self, None)) \
                        .append(s)
                else:
                    values[f.name] = s
            else:
                if wt == 2:          # packed
                    items = self._unpack(kind, raw)
                elif kind in _VARINT:
                    items = [_from_varint(kind, v)]
                else:
                    items = [struct.unpack(_FIXED[kind][0], raw)[0]]
                if f.repeated:
                    values.setdefault(f.name, _Repeated(self, None)) \
                        .extend(items)
                else:
                    values[f.name] = items[-1]
        object.__setattr__(self, "_present", True)

    @staticmethod
    def _unpack(kind: str, raw: memoryview) -> list:
        if kind in _FIXED:
            code, size = _FIXED[kind]
            return list(struct.unpack(f"<{len(raw) // size}{code[1]}", raw))
        items, pos = [], 0
        while pos < len(raw):
            v, pos = _read_varint(raw, pos)
            items.append(_from_varint(kind, v))
        return items

    # -- value semantics -----------------------------------------------------

    def _field_values(self):
        return tuple(
            dict(getattr(self, f.name)) if f.kind == "map"
            else list(getattr(self, f.name)) if f.repeated
            else (getattr(self, f.name) if self.HasField(f.name)
                  else None) if f.kind == "message" or self._PROTO2
            else getattr(self, f.name)
            for f in self._FIELDS)

    def __eq__(self, other):
        if type(other) is not type(self):
            return NotImplemented
        return self._field_values() == other._field_values()

    __hash__ = None

    def __str__(self):
        """protobuf's text format, as ``str()`` of a protobuf message
        gives it (fields in number order, two-space indents; strings keep
        non-ASCII characters, bytes print every byte outside printable
        ASCII in octal; map pairs in insertion order, which for one pair
        is protobuf's)."""
        out: List[str] = []
        self._text(out, "")
        return "".join(out)

    def _text(self, out: List[str], pad: str) -> None:
        for f in self._FIELDS:
            v = self._values.get(f.name)
            if v is None:
                continue
            if f.kind == "map":
                for k, item in v.items():
                    out.append(f"{pad}{f.name} {{\n")
                    out.append(f"{pad}  key: {_text_scalar(f.map_key, k)}\n")
                    if f.map_value == "message":
                        out.append(f"{pad}  value {{\n")
                        item._text(out, pad + "    ")
                        out.append(f"{pad}  }}\n")
                    else:
                        out.append(f"{pad}  value: "
                                   f"{_text_scalar(f.map_value, item)}\n")
                    out.append(f"{pad}}}\n")
            elif f.kind == "message":
                items = v if f.repeated else ([v] if v._present else [])
                for item in items:
                    out.append(f"{pad}{f.name} {{\n")
                    item._text(out, pad + "  ")
                    out.append(f"{pad}}}\n")
            elif f.repeated:
                for item in v:
                    out.append(f"{pad}{f.name}: "
                               f"{_text_scalar(f.kind, item, f.cls)}\n")
            elif self._PROTO2 or not _is_default(f.kind, v):
                out.append(f"{pad}{f.name}: "
                           f"{_text_scalar(f.kind, v, f.cls)}\n")

    def __repr__(self):
        parts = []
        for f in self._FIELDS:
            v = self._values.get(f.name)
            if v is None or ((f.repeated or f.kind == "map") and not v):
                continue
            if f.kind == "message" and not f.repeated and not v._present:
                continue
            parts.append(f"{f.name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"


def _make_text_escapes() -> Dict[int, str]:
    esc = {i: "\\%03o" % i for i in range(128) if not 32 <= i < 127}
    esc.update({ord("\t"): "\\t", ord("\n"): "\\n", ord("\r"): "\\r",
                ord('"'): '\\"', ord("'"): "\\'", ord("\\"): "\\\\"})
    return esc


_TEXT_ESCAPES = _make_text_escapes()


def _text_scalar(kind: str, v, enum_cls=None) -> str:
    if kind == "enum" and enum_cls is not None and v in enum_cls._NAMES:
        return enum_cls._NAMES[v]
    if kind == "bool":
        return "true" if v else "false"
    if kind in ("float", "double"):
        return repr(float(v))
    if kind == "string":
        return '"' + v.translate(_TEXT_ESCAPES) + '"'
    if kind == "bytes":
        return '"' + "".join(_TEXT_ESCAPES.get(c) or (
            chr(c) if c < 128 else "\\%03o" % c) for c in bytes(v)) + '"'
    return str(int(v))


def _cmp_key_bytes(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    if a[:n] != b[:n]:
        return -1 if a[:n] < b[:n] else 1
    return len(b) - len(a)          # a longer key before its prefix


def _map_order(m: dict, key_kind: str) -> list:
    """Map keys in the order of protobuf's
    ``SerializeToString(deterministic=True)`` (upb's map sorter): numbers
    ascending; strings by their bytes, a key before any key that is a
    prefix of it."""
    if key_kind not in ("string", "bytes"):
        return sorted(m)
    enc = (lambda k: k.encode("utf-8")) if key_kind == "string" \
        else bytes
    return sorted(m, key=functools.cmp_to_key(
        lambda a, b: _cmp_key_bytes(enc(a), enc(b))))


def _entry_bytes(f: _Field, key, value) -> bytes:
    """One map pair as its entry message: key (1) and value (2), both
    always written, as protobuf writes map entries."""
    kk = _varint((1 << 3) | (0 if f.map_key in _VARINT
                             else _WIRE_TYPE[f.map_key]))
    out = kk + _scalar_bytes(f.map_key, key)
    if f.map_value == "message":
        body = value._bytes()
        return out + _varint((2 << 3) | 2) + _varint(len(body)) + body
    vk = _varint((2 << 3) | (0 if f.map_value in _VARINT
                             else _WIRE_TYPE[f.map_value]))
    return out + vk + _scalar_bytes(f.map_value, value)


def _read_entry(f: _Field, raw: memoryview):
    """(key, value) of one map entry; a field left out is its default."""
    key = _DEFAULTS[f.map_key]
    value = None if f.map_value == "message" else _DEFAULTS[f.map_value]
    pos, end = 0, len(raw)
    while pos < end:
        tag, pos = _read_varint(raw, pos)
        number, wt = tag >> 3, tag & 7
        kind = f.map_key if number == 1 else f.map_value
        if wt == 0:
            v, pos = _read_varint(raw, pos)
            v = _from_varint(kind, v)
        elif wt in (1, 5):
            size = 8 if wt == 1 else 4
            chunk, pos = raw[pos:pos + size], pos + size
            v = struct.unpack(_FIXED[kind][0], chunk)[0] \
                if kind in _FIXED else None
        elif wt == 2:
            n, pos = _read_varint(raw, pos)
            chunk, pos = raw[pos:pos + n], pos + n
            if kind == "message":
                v = f.cls.FromString(chunk)
            elif kind == "string":
                v = bytes(chunk).decode("utf-8")
            else:
                v = bytes(chunk)
        else:
            raise DecodeError(f"unsupported wire type {wt}")
        if number == 1:
            key = v
        elif number == 2:
            value = v
    if value is None:
        value = f.cls()
    return key, value


def message(name: str, fields, full_name: str = "",
            syntax: str = "proto3") -> type:
    """A message class from its field table."""
    table = tuple(sorted((_Field(*f) for f in fields),
                         key=lambda f: f.number))
    return type(name, (Message,), {
        "__slots__": (), "_FIELDS": table,
        "_BY_NAME": {f.name: f for f in table},
        "_BY_NUMBER": {f.number: f for f in table},
        "_PROTO2": syntax == "proto2",
        "FULL_NAME": full_name or name})


class Enum:
    """Base of an enum's class: its values as attributes; ``_VALUES``
    maps names to numbers, ``_NAMES`` numbers to names (the first name
    of a number, as protobuf's text format prints it)."""

    _NAMES: Dict[int, str] = {}
    _VALUES: Dict[str, int] = {}
    FULL_NAME = ""


def enum_type(name: str, values: Dict[str, int]) -> type:
    """An enum's class from its ``{name: number}`` table."""
    return type(name, (Enum,), dict(
        values, _VALUES=dict(values),
        _NAMES={v: k for k, v in reversed(list(values.items()))},
        FULL_NAME=name))


def resolve(namespace: dict, package: str) -> None:
    """Bind every message and enum field of the classes in ``namespace``
    (a module's globals, nested classes included as ``Outer.Inner``) to
    its class, and set each class's full name under ``package``. An
    enum's values are set on what holds it, as protobuf's generated code
    has them (``MutationProto.PUT``; a top-level enum's in the module)."""
    classes = {}

    def collect(prefix, cls):
        classes[prefix] = cls
        cls.FULL_NAME = f"{package}.{prefix}"
        cls.__module__ = namespace["__name__"]
        cls.__qualname__ = prefix
        if issubclass(cls, Enum):
            return
        for attr, sub in list(vars(cls).items()):
            if isinstance(sub, type) and issubclass(sub, (Message, Enum)) \
                    and attr != "__class__":
                collect(f"{prefix}.{attr}", sub)
                if issubclass(sub, Enum):
                    for k, v in sub._VALUES.items():
                        setattr(cls, k, v)

    for key, cls in list(namespace.items()):
        if isinstance(cls, type) and issubclass(cls, (Message, Enum)) and \
                cls not in (Message, Enum) and "." not in cls.FULL_NAME:
            collect(key, cls)
            if issubclass(cls, Enum):
                namespace.update(cls._VALUES)
    for path, cls in classes.items():
        if issubclass(cls, Enum):
            continue
        outer = path.rsplit(".", 1)[0] if "." in path else ""
        for f in cls._FIELDS:
            if f.kind not in ("message", "enum") and \
                    f.map_value != "message":
                continue
            # a nested type first (Outer.Inner), then a top-level one
            f.cls = classes.get(f"{outer}.{f.type_name}" if outer
                                else f.type_name) \
                or classes.get(f"{path}.{f.type_name}") \
                or classes[f.type_name]
            if f.kind == "enum" and not f.has_default:
                f.default = next(iter(f.cls._VALUES.values()))
