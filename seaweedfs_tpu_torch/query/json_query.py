"""JSON document filter and projection: the port of
``seaweedfs_tpu.query.json_query`` (reference weed/query/json/
query_json.go:17-130, which uses gjson paths; here the stdlib json and a
dotted-path lookup).

Documents are newline-delimited JSON, the layout the volume server's
Query RPC scans (volume_grpc_query.go:52). A query is
``Query(field, op, value)`` with the operands of filterJson:
``=  !=  <  <=  >  >=  %`` (``%`` is an fnmatch pattern, in place of
gjson's pattern match). Both sides compare as numbers when both parse as
numbers, else as strings; an empty op asks only that the field exists.
"""

from __future__ import annotations

import fnmatch
import json
from typing import Any, Iterator, List, NamedTuple, Optional, Tuple


class Query(NamedTuple):
    field: str
    op: str = ""
    value: str = ""


_MISSING = object()


def get_path(doc: Any, dotted: str):
    """Dotted-path lookup with numeric segments indexing arrays:
    "a.b", "items.0.name". Returns _MISSING when absent."""
    node = doc
    if not dotted:
        return node
    for part in dotted.split("."):
        if isinstance(node, dict):
            if part not in node:
                return _MISSING
            node = node[part]
        elif isinstance(node, list):
            try:
                node = node[int(part)]
            except (ValueError, IndexError):
                return _MISSING
        else:
            return _MISSING
    return node


def _as_number(v) -> Optional[float]:
    if isinstance(v, bool):
        return None
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        try:
            return float(v)
        except ValueError:
            return None
    return None


def filter_json(doc: Any, query: Query) -> bool:
    """One document against one predicate (reference filterJson)."""
    value = get_path(doc, query.field)
    if value is _MISSING:
        return False
    if not query.op:
        return True  # existence check
    lnum, rnum = _as_number(value), _as_number(query.value)
    if lnum is not None and rnum is not None:
        left, right = lnum, rnum
    else:
        left = value if isinstance(value, str) else json.dumps(value)
        right = query.value
    if query.op == "=":
        return left == right
    if query.op == "!=":
        return left != right
    if query.op == "<":
        return left < right
    if query.op == "<=":
        return left <= right
    if query.op == ">":
        return left > right
    if query.op == ">=":
        return left >= right
    if query.op == "%":
        return fnmatch.fnmatchcase(str(left), str(right))
    raise ValueError(f"unknown operand {query.op!r}")


def query_json_line(line: str, projections: List[str],
                    query: Query) -> Tuple[bool, Optional[dict]]:
    """Filter + project one JSON line (reference QueryJson). With no
    projections the whole document passes through."""
    try:
        doc = json.loads(line)
    except json.JSONDecodeError:
        return False, None
    if not filter_json(doc, query):
        return False, None
    if not projections:
        return True, doc
    out = {}
    for p in projections:
        v = get_path(doc, p)
        if v is not _MISSING:
            out[p] = v
    return True, out


def query_json_lines(data: bytes, projections: List[str],
                     query: Query) -> Iterator[dict]:
    """Scan newline-delimited JSON bytes; yield projected records."""
    for raw in data.splitlines():
        line = raw.decode("utf-8", "replace").strip()
        if not line:
            continue
        passed, rec = query_json_line(line, projections, query)
        if passed:
            yield rec
