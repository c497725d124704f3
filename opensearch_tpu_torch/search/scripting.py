"""The script surface of bucket pipeline aggregations (the part of the
JAX package's ``search/scripting.py`` that ``search/pipeline_aggs.py``
reads): the whitelist pass over a Painless-subset expression, the
evaluator and the Painless-to-Python rewrite, over numpy scalars.

Score scripts (``script_score``) are not ported yet; this module holds
only what ``bucket_script`` and ``bucket_selector`` evaluate, host side:
arithmetic, comparisons, ternaries and ``Math.*`` over ``params.*`` and
bare ``buckets_path`` names.  Anything outside the subset raises
``ScriptException`` (400).
"""

from __future__ import annotations

import ast
from typing import Optional

import numpy as np

from opensearch_tpu_torch.common.errors import OpenSearchTpuError


class ScriptException(OpenSearchTpuError):
    status = 400


_MATH_FNS = {
    "log": np.log, "log10": np.log10, "sqrt": np.sqrt, "exp": np.exp,
    "abs": np.abs, "min": np.minimum, "max": np.maximum,
    "pow": np.power, "floor": np.floor, "ceil": np.ceil,
}
_BARE_FNS = {"min": np.minimum, "max": np.maximum, "abs": np.abs,
             "sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x))}
_VECTOR_FNS = ("cosineSimilarity", "dotProduct", "l2Squared")


class _FieldCollector(ast.NodeVisitor):
    """First pass: find doc[...] references and whether _score is used,
    and reject every node kind outside the whitelist."""

    _ALLOWED = (ast.Expression, ast.BinOp, ast.UnaryOp, ast.BoolOp,
                ast.Compare, ast.IfExp, ast.Call, ast.Attribute,
                ast.Subscript, ast.Name, ast.Constant, ast.Load,
                ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Mod, ast.Pow,
                ast.USub, ast.UAdd, ast.And, ast.Or, ast.Not,
                ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE,
                ast.List, ast.Tuple)

    def __init__(self):
        self.numeric: list[str] = []
        self.vectors: list[str] = []
        self.uses_score = False

    def generic_visit(self, node):
        if not isinstance(node, self._ALLOWED):
            raise ScriptException(
                f"unsupported script construct [{type(node).__name__}]")
        super().generic_visit(node)

    def visit_Name(self, node):
        if node.id == "_score":
            self.uses_score = True
        elif node.id not in ("doc", "params", "Math") and \
                node.id not in _BARE_FNS and node.id not in _VECTOR_FNS:
            raise ScriptException(f"unknown variable [{node.id}]")

    def visit_Call(self, node):
        fname = None
        if isinstance(node.func, ast.Name):
            fname = node.func.id
        if fname in _VECTOR_FNS:
            if len(node.args) != 2:
                raise ScriptException(f"[{fname}] takes (query, doc_field)")
            f = _doc_field_of(node.args[1])
            if f is None:
                raise ScriptException(
                    f"[{fname}] second argument must be doc['field']")
            self.vectors.append(f)
            self.visit(node.args[0])
            return
        self.generic_visit(node)

    def visit_Attribute(self, node):
        # doc['f'].value / doc['f'].size() / Math.fn / params.x
        f = _doc_field_of(node.value)
        if f is not None:
            if node.attr in ("value", "size"):
                self.numeric.append(f)
                return
            raise ScriptException(
                f"doc['{f}'].{node.attr} is not supported "
                "(use .value or .size())")
        self.generic_visit(node)


def _doc_field_of(node) -> Optional[str]:
    if (isinstance(node, ast.Subscript)
            and isinstance(node.value, ast.Name) and node.value.id == "doc"):
        sl = node.slice
        if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
            return sl.value
    return None


class _Evaluator(ast.NodeVisitor):
    """Second pass: evaluate over numpy values.  ``doc[...]`` reads are
    not evaluated: the whitelist pass finds them and the pipeline
    refuses the script before this runs."""

    def __init__(self, params, numeric_cols, vector_cols, score):
        self.params = params
        self.score = score

    def visit(self, node):  # noqa: D102 — dispatch only
        fn = getattr(self, f"visit_{type(node).__name__}", None)
        if fn is None:
            raise ScriptException(
                f"unsupported script construct [{type(node).__name__}]")
        return fn(node)

    def visit_Expression(self, node):
        return self.visit(node.body)

    def visit_Constant(self, node):
        if isinstance(node.value, (int, float, bool)):
            return node.value
        raise ScriptException(
            f"unsupported literal [{node.value!r}] in score script")

    def visit_Name(self, node):
        if node.id == "_score":
            return self.score
        raise ScriptException(f"unknown variable [{node.id}]")

    def visit_List(self, node):
        return np.asarray([self.visit(e) for e in node.elts],
                          np.float32)

    visit_Tuple = visit_List

    def _param(self, name):
        if name not in self.params:
            raise ScriptException(f"missing script param [{name}]")
        return self.params[name]

    def visit_Attribute(self, node):
        if isinstance(node.value, ast.Name) and node.value.id == "params":
            return self._param(node.attr)
        raise ScriptException("unsupported attribute access in script")

    def visit_Subscript(self, node):
        if isinstance(node.value, ast.Name) and node.value.id == "params":
            sl = node.slice
            if isinstance(sl, ast.Constant):
                return self._param(sl.value)
        raise ScriptException("unsupported subscript in script")

    def visit_BinOp(self, node):
        a, b = self.visit(node.left), self.visit(node.right)
        op = type(node.op)
        if op is ast.Add:
            return a + b
        if op is ast.Sub:
            return a - b
        if op is ast.Mult:
            return a * b
        if op is ast.Div:
            return a / b
        if op is ast.Mod:
            return a % b
        if op is ast.Pow:
            return a ** b
        raise ScriptException("unsupported operator")

    def visit_UnaryOp(self, node):
        v = self.visit(node.operand)
        if isinstance(node.op, ast.USub):
            return -v
        if isinstance(node.op, ast.UAdd):
            return v
        if isinstance(node.op, ast.Not):
            return np.logical_not(v)
        raise ScriptException("unsupported unary operator")

    def visit_Compare(self, node):
        if len(node.ops) != 1:
            raise ScriptException("chained comparisons are not supported")
        a, b = self.visit(node.left), self.visit(node.comparators[0])
        op = type(node.ops[0])
        table = {ast.Eq: np.equal, ast.NotEq: np.not_equal,
                 ast.Lt: np.less, ast.LtE: np.less_equal,
                 ast.Gt: np.greater, ast.GtE: np.greater_equal}
        return table[op](a, b)

    def visit_BoolOp(self, node):
        vals = [self.visit(v) for v in node.values]
        out = vals[0]
        for v in vals[1:]:
            out = (np.logical_and(out, v) if isinstance(node.op, ast.And)
                   else np.logical_or(out, v))
        return out

    def visit_IfExp(self, node):
        return np.where(self.visit(node.test), self.visit(node.body),
                        self.visit(node.orelse))

    def visit_Call(self, node):
        if isinstance(node.func, ast.Name):
            name = node.func.id
            if name in _BARE_FNS:
                args = [self.visit(a) for a in node.args]
                try:
                    return _BARE_FNS[name](*args)
                except TypeError as e:
                    raise ScriptException(
                        f"bad arguments to [{name}]: {e}") from None
        if isinstance(node.func, ast.Attribute):
            recv = node.func.value
            if isinstance(recv, ast.Name) and recv.id == "Math":
                fn = _MATH_FNS.get(node.func.attr)
                if fn is None:
                    raise ScriptException(
                        f"Math.{node.func.attr} is not supported")
                try:
                    return fn(*[self.visit(a) for a in node.args])
                except TypeError as e:
                    raise ScriptException(
                        f"bad arguments to [Math.{node.func.attr}]: "
                        f"{e}") from None
        raise ScriptException("unsupported function call in script")


def _split_ternary(src: str):
    """Find the outermost Java ternary ``cond ? a : b`` (depth 0, outside
    quotes); returns (cond, a, b) or None."""
    depth = 0
    quote = None
    for i, ch in enumerate(src):
        if quote:
            if ch == quote:
                quote = None
            continue
        if ch in "'\"":
            quote = ch
        elif ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        elif ch == "?" and depth == 0:
            level = 1
            d2, q2 = 0, None
            for j in range(i + 1, len(src)):
                c2 = src[j]
                if q2:
                    if c2 == q2:
                        q2 = None
                    continue
                if c2 in "'\"":
                    q2 = c2
                elif c2 in "([{":
                    d2 += 1
                elif c2 in ")]}":
                    d2 -= 1
                elif c2 == "?" and d2 == 0:
                    level += 1
                elif c2 == ":" and d2 == 0:
                    level -= 1
                    if level == 0:
                        return src[:i], src[i + 1: j], src[j + 1:]
            raise ScriptException("unterminated ternary in script")
    return None


def _sub_outside_quotes(src: str, fn) -> str:
    """Apply ``fn`` to each maximal unquoted chunk, leaving quoted spans
    (doc['field'] names!) byte-for-byte intact."""
    out = []
    chunk_start = 0
    quote = None
    for i, ch in enumerate(src):
        if quote:
            if ch == quote:
                out.append(src[chunk_start: i + 1])
                chunk_start = i + 1
                quote = None
        elif ch in "'\"":
            out.append(fn(src[chunk_start: i]))
            chunk_start = i
            quote = ch
    if quote:
        raise ScriptException("unterminated string literal in script")
    out.append(fn(src[chunk_start:]))
    return "".join(out)


def _painless_to_python(src: str) -> str:
    """Painless/Java surface syntax -> the equivalent Python expression:
    ``?:`` ternaries, ``&&``/``||``/``!``, true/false/null literals.
    Substitutions never touch quoted spans, so field names like
    doc['true'] survive."""
    import re as _re

    t = _split_ternary(src)
    if t is not None:
        cond, a, b = t
        return (f"(({_painless_to_python(a)}) if "
                f"({_painless_to_python(cond)}) else "
                f"({_painless_to_python(b)}))")

    def repl(chunk: str) -> str:
        chunk = _re.sub(r"&&", " and ", chunk)
        chunk = _re.sub(r"\|\|", " or ", chunk)
        chunk = _re.sub(r"!(?![=])", " not ", chunk)
        chunk = _re.sub(r"\btrue\b", "True", chunk)
        chunk = _re.sub(r"\bfalse\b", "False", chunk)
        chunk = _re.sub(r"\bnull\b", "None", chunk)
        return chunk

    return _sub_outside_quotes(src, repl)
