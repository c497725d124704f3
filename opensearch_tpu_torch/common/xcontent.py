"""Pluggable content formats: JSON, YAML, CBOR (a copy of the JAX
package's ``common/xcontent.py``; ``yaml`` is imported only where a
YAML body or response asks for it, so JSON never needs PyYAML).

Analog of the reference's x-content abstraction (ref libs/x-content/src/
main/java/org/opensearch/common/xcontent/XContentType.java:38 — JSON,
SMILE, YAML, CBOR): request bodies negotiate via Content-Type, responses
via Accept or the ``format`` query param.  SMILE is not implemented
(niche binary JSON; CBOR covers the binary use case) and is rejected
with a clear 406.

The CBOR codec is self-contained (RFC 8949 subset: the definite-length
major types JSON can express — ints, floats, text, bytes, arrays, maps,
bool/null) — no third-party dependency is available in this image.
"""

from __future__ import annotations

import json
import struct
from typing import Any

from opensearch_tpu_torch.common.errors import OpenSearchTpuError, ParsingError


class UnsupportedMediaTypeError(OpenSearchTpuError):
    status = 406


# -- CBOR (RFC 8949 subset) --------------------------------------------------

def _cbor_head(major: int, arg: int) -> bytes:
    if arg < 24:
        return bytes([(major << 5) | arg])
    for ai, fmt in ((24, ">B"), (25, ">H"), (26, ">I"), (27, ">Q")):
        if arg < (1 << (8 * struct.calcsize(fmt))):
            return bytes([(major << 5) | ai]) + struct.pack(fmt, arg)
    raise ValueError("integer too large for CBOR")


def cbor_dumps(obj: Any) -> bytes:
    out = bytearray()

    def enc(v):
        if v is None:
            out.append(0xF6)
        elif v is True:
            out.append(0xF5)
        elif v is False:
            out.append(0xF4)
        elif isinstance(v, int):
            if v >= 0:
                out.extend(_cbor_head(0, v))
            else:
                out.extend(_cbor_head(1, -1 - v))
        elif isinstance(v, float):
            out.append(0xFB)
            out.extend(struct.pack(">d", v))
        elif isinstance(v, bytes):
            out.extend(_cbor_head(2, len(v)))
            out.extend(v)
        elif isinstance(v, str):
            b = v.encode()
            out.extend(_cbor_head(3, len(b)))
            out.extend(b)
        elif isinstance(v, (list, tuple)):
            out.extend(_cbor_head(4, len(v)))
            for x in v:
                enc(x)
        elif isinstance(v, dict):
            out.extend(_cbor_head(5, len(v)))
            for k, x in v.items():
                enc(str(k))
                enc(x)
        else:
            raise ParsingError(
                f"cannot encode [{type(v).__name__}] as CBOR")

    enc(obj)
    return bytes(out)


def cbor_loads(data: bytes) -> Any:
    pos = 0
    depth = 0

    def need(n):
        nonlocal pos
        if pos + n > len(data):
            raise ParsingError("truncated CBOR input")
        chunk = data[pos:pos + n]
        pos += n
        return chunk

    def arg(ai):
        if ai < 24:
            return ai
        if ai in (24, 25, 26, 27):
            fmt = {24: ">B", 25: ">H", 26: ">I", 27: ">Q"}[ai]
            return struct.unpack(fmt, need(struct.calcsize(fmt)))[0]
        raise ParsingError(
            f"unsupported CBOR additional info [{ai}] "
            "(indefinite lengths not supported)")

    def dec():
        nonlocal depth
        depth += 1
        if depth > 256:                  # bound before RecursionError
            raise ParsingError("CBOR input nested too deeply")
        try:
            return _dec_inner()
        finally:
            depth -= 1

    def _dec_map(n):
        out = {}
        for _ in range(n):
            k = dec()
            if not isinstance(k, str):
                # JSON-compatible documents only (the reference's CBOR
                # parser surfaces into the same Map<String,Object>)
                raise ParsingError(
                    f"CBOR map keys must be text strings, got "
                    f"[{type(k).__name__}]")
            out[k] = dec()
        return out

    def _bounded(n):
        # every element takes >= 1 byte: a declared count beyond the
        # remaining input is malformed, not a reason to spin
        if n > len(data) - pos:
            raise ParsingError(
                f"CBOR container length [{n}] exceeds input size")
        return n

    def _dec_inner():
        head = need(1)[0]
        major, ai = head >> 5, head & 0x1F
        if major == 0:
            return arg(ai)
        if major == 1:
            return -1 - arg(ai)
        if major == 2:
            return bytes(need(arg(ai)))
        if major == 3:
            try:
                return need(arg(ai)).decode()
            except UnicodeDecodeError as e:
                raise ParsingError(f"invalid UTF-8 in CBOR text: {e}")
        if major == 4:
            return [dec() for _ in range(_bounded(arg(ai)))]
        if major == 5:
            return _dec_map(_bounded(arg(ai)))
        if major == 6:                   # tag: decode and drop, like
            arg(ai)                      # most lenient decoders
            return dec()
        # major 7: simple values / floats
        if ai == 20:
            return False
        if ai == 21:
            return True
        if ai in (22, 23):
            return None
        if ai == 25:                     # half float
            h = struct.unpack(">H", need(2))[0]
            sign = -1.0 if h & 0x8000 else 1.0
            exp, frac = (h >> 10) & 0x1F, h & 0x3FF
            if exp == 0:
                return sign * frac * 2.0 ** -24
            if exp == 31:
                return sign * (float("inf") if frac == 0
                               else float("nan"))
            return sign * (1 + frac / 1024.0) * 2.0 ** (exp - 15)
        if ai == 26:
            return struct.unpack(">f", need(4))[0]
        if ai == 27:
            return struct.unpack(">d", need(8))[0]
        raise ParsingError(f"unsupported CBOR simple value [{ai}]")

    v = dec()
    if pos != len(data):
        raise ParsingError("trailing bytes after CBOR value")
    return v


# -- negotiation -------------------------------------------------------------

_CT_JSON = "application/json"
_CT_YAML = "application/yaml"
_CT_CBOR = "application/cbor"
_CT_SMILE = "application/smile"


def _media_type(header: str) -> str:
    return (header or "").split(";")[0].strip().lower()


def from_bytes(data: bytes, content_type: str = "") -> Any:
    """Parse a request body per its Content-Type (JSON when absent)."""
    mt = _media_type(content_type)
    if mt == _CT_SMILE:
        raise UnsupportedMediaTypeError(
            "Content-Type [application/smile] is not supported — use "
            "json, yaml, or cbor")
    if mt == _CT_CBOR:
        return cbor_loads(data)
    if mt in (_CT_YAML, "text/yaml", "application/x-yaml"):
        import yaml
        try:
            return yaml.safe_load(data)
        except yaml.YAMLError as e:
            raise ParsingError(f"request body is not valid YAML: {e}")
    try:
        return json.loads(data)
    except json.JSONDecodeError as e:
        raise ParsingError(f"request body is not valid JSON: {e}")


def to_bytes(payload: Any, accept: str = "",
             format_param: str = "") -> tuple[bytes, str]:
    """Serialize a response per ``format`` param (wins, like the
    reference's ``?format=yaml``) or Accept header.  Returns
    (body, content-type)."""
    fmt = (format_param or "").lower() or _media_type(accept)
    if fmt in ("cbor", _CT_CBOR):
        return cbor_dumps(payload), _CT_CBOR
    if fmt in ("yaml", _CT_YAML, "text/yaml", "application/x-yaml"):
        import yaml
        return (yaml.safe_dump(payload, sort_keys=False,
                               default_flow_style=False).encode(),
                f"{_CT_YAML}; charset=UTF-8")
    if fmt in ("smile", _CT_SMILE):
        raise UnsupportedMediaTypeError(
            "format [smile] is not supported — use json, yaml, or cbor")
    return ((json.dumps(payload) + "\n").encode(),
            f"{_CT_JSON}; charset=UTF-8")
