"""Scripts: the Painless-subset surface of the JAX package's
``search/scripting.py`` -- the whitelist pass, the Painless-to-Python
rewrite, and two evaluators.

- Score scripts (``script_score``): ``compile_score_script`` parses and
  whitelists a script into a ``ScriptProgram`` (with the k-NN plugin's
  pre-baked ``{"lang": "knn", "source": "knn_score"}`` rewritten to its
  expression: l2, cosinesimil, innerproduct; another space is a 400).
  ``ScriptProgram.eval`` runs it over torch tensors of a segment, on the
  segment's device: ``_score``, ``params.*``, ``doc['f'].value``
  (numeric doc values, missing -> 0.0), ``doc['f'].size()``, ``Math.*``,
  the bare ``min/max/abs/sigmoid``, and the vector functions
  ``dotProduct`` / ``l2Squared`` / ``cosineSimilarity(params.q,
  doc['vec'])``.  These do not compute ``vec @ q`` themselves: they read
  the per-row column the compiler's request-wide pre-pass made
  (``search/compiler.py`` ``_c_script_score``: one K1 scores launch per
  distinct (function, field, query vector) over every segment, or its
  plain version on the CPU), found through ``ScriptProgram.vector_calls``.
  Arithmetic is float32, as the reference's; the columns are float64
  sums rounded to float32 once (``ops/knn.py``).
- Bucket scripts (``bucket_script`` / ``bucket_selector``, read by
  ``search/pipeline_aggs.py``): ``_Evaluator`` over numpy scalars,
  host side: arithmetic, comparisons, ternaries and ``Math.*`` over
  ``params.*`` and bare ``buckets_path`` names.

Anything outside the subset raises ``ScriptException`` (400).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field as dc_field
from typing import Optional

import numpy as np
import torch

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


# -- score scripts ---------------------------------------------------------

@dataclass(frozen=True)
class ScriptProgram:
    """A compiled score script: hashable by (source, param NAMES) -- not
    values -- so identical scripts share one plan across queries, as in
    the reference; the values are bound per request."""

    source: str
    param_names: tuple                     # sorted numeric param names
    numeric_fields: tuple                  # doc['f'].value / size() fields
    vector_fields: tuple                   # doc['f'] vector fields used
    uses_score: bool
    _tree: object = dc_field(compare=False, hash=False, repr=False,
                             default=None)
    _params: dict = dc_field(compare=False, hash=False, repr=False,
                             default=None)

    def param_values(self, device) -> tuple:
        """The params in ``param_names`` order as float32 tensors on
        ``device`` (the reference's ``param_values``)."""
        out = []
        for name in self.param_names:
            try:
                arr = np.asarray(self._params[name], np.float32)
            except (ValueError, TypeError):
                raise ScriptException(
                    f"script param [{name}] is not numeric") from None
            out.append(torch.from_numpy(arr).to(device))
        return tuple(out)

    def vector_calls(self) -> tuple:
        """The script's vector-function calls: ``({key: (fn, field, query
        f32 [d] numpy)}, {id(call node): key})`` with ``key = (fn,
        field, query bytes)``, one entry per distinct key.  The query
        argument (``params.x`` or a literal list) is evaluated here, on
        the host, in float32."""
        calls, node_keys = {}, {}
        params = dict(zip(self.param_names,
                          self.param_values(torch.device("cpu"))))
        for node in ast.walk(self._tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id in _VECTOR_FNS:
                key = _call_key(node, params)
                node_keys[id(node)] = key
                calls[key] = (key[0], key[1],
                              np.frombuffer(key[2], np.float32))
        return calls, node_keys

    def eval(self, score, numeric_cols: dict, vector_cols: dict,
             param_vals: tuple, device):
        """The script over one segment: ``numeric_cols`` {field:
        (values f32 [n_pad], exists bool [n_pad])}, ``vector_cols``
        {id(call node): f32 [n_pad]} (``vector_calls``); torch ops on
        ``device``."""
        params = dict(zip(self.param_names, param_vals))
        return _ScoreEvaluator(params, numeric_cols, vector_cols, score,
                               device).visit(self._tree)


def _call_key(node, host_params) -> tuple:
    """``(fn, field, query bytes)`` of a vector-function call, its query
    argument evaluated on the host in float32."""
    q = _ScoreEvaluator(host_params, {}, {}, None,
                        torch.device("cpu")).visit(node.args[0])
    if not isinstance(q, torch.Tensor):
        q = torch.as_tensor(q, dtype=torch.float32)
    q = np.ascontiguousarray(q.to(torch.float32).numpy().reshape(-1))
    return node.func.id, _doc_field_of(node.args[1]), q.tobytes()


def _as_tensor(x, device):
    """A Python scalar as a 0-d tensor typed as JAX types it under x64
    (bool, int64, float64); a tensor as it is."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, bool):
        return torch.tensor(x, device=device)
    if isinstance(x, int):
        return torch.tensor(x, dtype=torch.int64, device=device)
    return torch.tensor(float(x), dtype=torch.float64, device=device)


def _as_float(x, device):
    """``_as_tensor``, integers promoted to float64 (jnp's float
    functions promote integer inputs so)."""
    t = _as_tensor(x, device)
    return t if t.is_floating_point() else t.to(torch.float64)


class _ScoreEvaluator(_Evaluator):
    """The score-script evaluator: torch ops over a segment's tensors."""

    def __init__(self, params, numeric_cols, vector_cols, score, device):
        super().__init__(params, numeric_cols, vector_cols, score)
        self.numeric = numeric_cols        # field -> (values, exists)
        self.vectors = vector_cols         # id(call node) -> column
        self.device = device

    def _fn(self, name):
        dev = self.device

        def unary(op):
            return lambda x: op(_as_float(x, dev))

        def binary(op):
            return lambda a, b: op(_as_tensor(a, dev), _as_tensor(b, dev))

        return {
            "log": unary(torch.log), "log10": unary(torch.log10),
            "sqrt": unary(torch.sqrt), "exp": unary(torch.exp),
            "floor": unary(torch.floor), "ceil": unary(torch.ceil),
            "abs": lambda x: torch.abs(_as_tensor(x, dev)),
            "min": binary(torch.minimum), "max": binary(torch.maximum),
            "pow": binary(torch.pow),
            "sigmoid": lambda x: 1.0 / (1.0 + torch.exp(-_as_float(x, dev))),
        }[name]

    def visit_List(self, node):
        return torch.tensor([float(self.visit(e)) for e in node.elts],
                            dtype=torch.float32, device=self.device)

    visit_Tuple = visit_List

    def visit_Attribute(self, node):
        f = _doc_field_of(node.value)
        if f is not None and node.attr == "value":
            return self.numeric[f][0]
        return super().visit_Attribute(node)

    def visit_UnaryOp(self, node):
        if isinstance(node.op, ast.Not):
            return torch.logical_not(_as_tensor(self.visit(node.operand),
                                                self.device))
        return super().visit_UnaryOp(node)

    def visit_Compare(self, node):
        if len(node.ops) != 1:
            raise ScriptException("chained comparisons are not supported")
        a = _as_tensor(self.visit(node.left), self.device)
        b = _as_tensor(self.visit(node.comparators[0]), self.device)
        table = {ast.Eq: torch.eq, ast.NotEq: torch.ne, ast.Lt: torch.lt,
                 ast.LtE: torch.le, ast.Gt: torch.gt, ast.GtE: torch.ge}
        return table[type(node.ops[0])](a, b)

    def visit_BoolOp(self, node):
        vals = [_as_tensor(self.visit(v), self.device) for v in node.values]
        op = (torch.logical_and if isinstance(node.op, ast.And)
              else torch.logical_or)
        out = vals[0]
        for v in vals[1:]:
            out = op(out, v)
        return out

    def visit_IfExp(self, node):
        return torch.where(_as_tensor(self.visit(node.test), self.device),
                           _as_tensor(self.visit(node.body), self.device),
                           _as_tensor(self.visit(node.orelse), self.device))

    def visit_Call(self, node):
        if isinstance(node.func, ast.Name):
            name = node.func.id
            if name in _VECTOR_FNS:
                return self.vectors[id(node)]
            if name in _BARE_FNS:
                args = [self.visit(a) for a in node.args]
                try:
                    return self._fn(name)(*args)
                except TypeError as e:
                    raise ScriptException(
                        f"bad arguments to [{name}]: {e}") from None
        if isinstance(node.func, ast.Attribute):
            recv = node.func.value
            f = _doc_field_of(recv)
            if f is not None and node.func.attr == "size":
                return self.numeric[f][1].to(torch.int32)
            if isinstance(recv, ast.Name) and recv.id == "Math":
                if node.func.attr not in _MATH_FNS:
                    raise ScriptException(
                        f"Math.{node.func.attr} is not supported")
                try:
                    return self._fn(node.func.attr)(
                        *[self.visit(a) for a in node.args])
                except TypeError as e:
                    raise ScriptException(
                        f"bad arguments to [Math.{node.func.attr}]: "
                        f"{e}") from None
        raise ScriptException("unsupported function call in script")


_KNN_SCORE_SOURCES = {
    "l2": "1 / (1 + l2Squared(params.query_value, doc['{f}']))",
    "cosinesimil": "(1 + cosineSimilarity(params.query_value, doc['{f}'])) / 2",
    "innerproduct": "dotProduct(params.query_value, doc['{f}'])",
}


def compile_score_script(script: dict) -> ScriptProgram:
    """Parse + whitelist a score script; raises ScriptException (400) on
    anything outside the subset."""
    if not isinstance(script, dict):
        raise ScriptException("[script] must be an object")
    lang = script.get("lang", "painless")
    source = script.get("source") or script.get("inline") or ""
    params = script.get("params") or {}
    if lang == "knn" or source == "knn_score":
        # the k-NN plugin's pre-baked script (BASELINE config #2)
        field = params.get("field")
        qv = params.get("query_value")
        if not field or qv is None:
            raise ScriptException(
                "knn_score requires params.field and params.query_value")
        space = params.get("space_type", "l2")
        if space not in _KNN_SCORE_SOURCES:
            raise ScriptException(f"unknown space_type [{space}]")
        source = _KNN_SCORE_SOURCES[space].replace("{f}", field)
    elif lang not in ("painless", "expression"):
        raise ScriptException(f"script lang [{lang}] is not supported")
    if not source:
        raise ScriptException("script [source] is required")
    try:
        tree = ast.parse(_painless_to_python(source), mode="eval")
    except SyntaxError as e:
        raise ScriptException(f"script compile error: {e}") from None
    coll = _FieldCollector()
    coll.visit(tree)
    numeric_params = {k: v for k, v in params.items()
                      if isinstance(v, (int, float, bool, list, tuple))
                      and not isinstance(v, str)}
    return ScriptProgram(
        source=source, param_names=tuple(sorted(numeric_params)),
        numeric_fields=tuple(sorted(set(coll.numeric))),
        vector_fields=tuple(sorted(set(coll.vectors))),
        uses_score=coll.uses_score, _tree=tree, _params=numeric_params)
