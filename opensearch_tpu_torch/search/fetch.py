"""Fetch phase: build hit objects from winning doc ids (the port of the
JAX package's ``search/fetch.py``; only ``_source`` filtering so far —
highlight, explain, docvalue_fields and fields are not ported yet).

Analog of ``search/fetch/FetchPhase.java`` and the ``FetchSourcePhase``
sub-phase (source include/exclude filtering with wildcard patterns)."""

from __future__ import annotations

import fnmatch
from typing import Any, Optional, Union


def _match_any(path: str, patterns: list[str]) -> bool:
    for p in patterns:
        if fnmatch.fnmatchcase(path, p) or path.startswith(p + "."):
            return True
        # a pattern deeper than the path keeps the ancestor object
        if p.startswith(path + "."):
            return True
    return False


def _filter_tree(obj: Any, prefix: str, includes: Optional[list[str]],
                 excludes: list[str]):
    if not isinstance(obj, dict):
        return obj
    out = {}
    for k, v in obj.items():
        path = f"{prefix}{k}"
        if excludes and any(fnmatch.fnmatchcase(path, p)
                            or path.startswith(p + ".") for p in excludes):
            continue
        if includes is not None and not _match_any(path, includes):
            continue
        if isinstance(v, dict):
            sub_includes = includes
            if includes is not None and any(
                    fnmatch.fnmatchcase(path, p) or path.startswith(p + ".")
                    for p in includes):
                sub_includes = None  # whole subtree included
            v = _filter_tree(v, path + ".", sub_includes, excludes)
        out[k] = v
    return out


def filter_source(source: dict, spec: Union[bool, str, list, dict, None]):
    """Apply a ``_source`` request option.  Returns None when `_source`
    is disabled for the response."""
    if spec is None or spec is True:
        return source
    if spec is False:
        return None
    if isinstance(spec, str):
        spec = [spec]
    if isinstance(spec, list):
        return _filter_tree(source, "", [str(s) for s in spec], [])
    includes = spec.get("includes") or spec.get("include")
    excludes = spec.get("excludes") or spec.get("exclude") or []
    if isinstance(includes, str):
        includes = [includes]
    if isinstance(excludes, str):
        excludes = [excludes]
    return _filter_tree(source, "",
                        None if not includes else list(includes),
                        list(excludes))
