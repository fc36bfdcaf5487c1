"""protobuf's JSON mapping for the port's messages (``pb/wire.py``).

The card's machine has no protobuf package, so the port reads and writes
the JSON form of its messages itself, with the rules of
``google.protobuf.json_format``:

  - a field is named by its lowerCamelCase JSON name or by its proto
    name; naming one field twice is an error;
  - an unknown name is an error (``ParseError``) unless
    ``ignore_unknown_fields`` is set;
  - ``null`` clears a field; a null element of a list is an error;
  - a repeated field takes a list only, a string field a string only;
  - the object of a message field is iterated as protobuf iterates it
    (a string names its characters, each an unknown field);
  - printing writes the fields that are set, in field-number order,
    under their JSON names (or their proto names).

Only string and message fields are carried: the messages that go
through JSON (``iam_pb2``) have no other kind.
"""

from __future__ import annotations

import json
import re

from seaweedfs_tpu_torch.pb.wire import Message

_UNPAIRED_SURROGATE = re.compile(
    "[\ud800-\udbff](?![\udc00-\udfff])|(?<![\ud800-\udbff])[\udc00-\udfff]")


class ParseError(ValueError):
    """A JSON document that does not fit the message."""


def json_name(name: str) -> str:
    """protobuf's lowerCamelCase JSON name of a proto field name."""
    head, *rest = name.split("_")
    return head + "".join(p[:1].upper() + p[1:] for p in rest)


def Parse(text, message: Message, ignore_unknown_fields: bool = False
          ) -> Message:
    try:
        js = json.loads(text)
    except ValueError as e:
        raise ParseError(f"Failed to load JSON: {e}.") from e
    return ParseDict(js, message, ignore_unknown_fields)


def ParseDict(js, message: Message, ignore_unknown_fields: bool = False
              ) -> Message:
    _Parser(ignore_unknown_fields).message(js, message,
                                           type(message).__name__)
    return message


class _Parser:
    def __init__(self, ignore_unknown_fields: bool):
        self.ignore_unknown = ignore_unknown_fields

    def message(self, js, message: Message, path: str) -> None:
        cls = type(message)
        by_json = {json_name(f.name): f for f in cls._FIELDS}
        names = []
        for name in js:
            field = None
            try:
                field = by_json.get(name) or cls._BY_NAME.get(name)
                if field is None:
                    if self.ignore_unknown:
                        continue
                    raise ParseError(
                        f'Message type "{cls.FULL_NAME}" has no field '
                        f'named "{name}" at "{path}".\n Available Fields'
                        f'(except extensions): "{list(by_json)}"')
                if name in names:
                    raise ParseError(
                        f'Message type "{cls.FULL_NAME}" should not have '
                        f'multiple "{name}" fields at "{path}".')
                names.append(name)
                value = js[name]
                if value is None:
                    message._values.pop(field.name, None)
                    continue
                self.field(message, field, value, f"{path}.{name}")
            except ParseError as e:
                if field is None:
                    raise
                raise ParseError(
                    f"Failed to parse {name} field: {e}.") from e
            except (ValueError, TypeError) as e:
                raise ParseError(
                    f"Failed to parse {name} field: {e}.") from e

    def field(self, message: Message, field, value, path: str) -> None:
        if field.kind not in ("string", "message"):
            raise ParseError(f"{field.kind} field {field.name} is not "
                             "carried")
        if field.repeated:
            if not isinstance(value, (list, tuple)):
                raise ParseError(f"repeated field {path.rsplit('.', 1)[1]} "
                                 f"must be in [] which is {value} at "
                                 f"{path.rsplit('.', 1)[0]}")
            setattr(message, field.name, [])
            items = getattr(message, field.name)
            for i, item in enumerate(value):
                if item is None:
                    raise ParseError(
                        "null is not allowed to be used as an element in "
                        f"a repeated field at {path}[{i}]")
                if field.kind == "message":
                    self.message(item, items.add(), f"{path}[{i}]")
                else:
                    items.append(_string(item, f"{path}[{i}]"))
            return
        if field.kind == "message":
            sub = getattr(message, field.name)
            sub._touch()
            self.message(value, sub, path)
            return
        setattr(message, field.name, _string(value, path))


def _string(value, path: str) -> str:
    if _UNPAIRED_SURROGATE.search(value):
        raise ParseError(f"Unpaired surrogate at {path}")
    return value


def MessageToDict(message: Message,
                  preserving_proto_field_name: bool = False) -> dict:
    js = {}
    for f in type(message)._FIELDS:
        if f.kind not in ("string", "message"):
            raise ValueError(f"{f.kind} field {f.name} is not carried")
        name = f.name if preserving_proto_field_name else json_name(f.name)

        def value(v):
            return MessageToDict(v, preserving_proto_field_name) \
                if f.kind == "message" else v

        if f.repeated:
            items = getattr(message, f.name)
            if items:
                js[name] = [value(v) for v in items]
        elif message.HasField(f.name):
            js[name] = value(getattr(message, f.name))
    return js


def MessageToJson(message: Message, preserving_proto_field_name: bool = False,
                  indent=2, sort_keys: bool = False,
                  ensure_ascii: bool = True) -> str:
    return json.dumps(MessageToDict(message, preserving_proto_field_name),
                      indent=indent, sort_keys=sort_keys,
                      ensure_ascii=ensure_ascii)
