"""Pipeline aggregations: coordinator-side transforms over reduced aggs.

The reference runs these after the final reduce (ref
search/aggregations/pipeline/PipelineAggregator.java — sibling aggs via
SiblingPipelineAggregator.doReduce, parent aggs via each
*PipelineAggregator.reduce over the parent's bucket list).  Nothing
touches the device: inputs are the already-reduced response buckets, so
this is pure host reduce-tree work applied by ``reduce_aggs`` as a
post-pass — identical for the 1-shard and N-shard partial-merge paths.

All 15 reference types (SURVEY Appendix A listing of
``search/aggregations/pipeline/``):

  sibling:  avg_bucket, max_bucket, min_bucket, sum_bucket, stats_bucket,
            extended_stats_bucket, percentiles_bucket
  parent:   cumulative_sum, derivative, serial_diff, moving_fn,
            moving_avg (legacy model-based alias), bucket_script,
            bucket_selector, bucket_sort

Window semantics follow MovFnPipelineAggregator.java:136 — the window is
``[i - window + shift, i + shift)``, i.e. shift=0 EXCLUDES the current
bucket; MovAvgPipelineAggregator.java:122 computes the model before
offering the current value, so moving_avg shares the same exclusive
window.
"""

from __future__ import annotations

import ast

import numpy as np

from opensearch_tpu_torch.common.errors import IllegalArgumentError, ParsingError

PARENT_TYPES = {"cumulative_sum", "derivative", "serial_diff", "moving_fn",
                "moving_avg", "bucket_script", "bucket_selector",
                "bucket_sort"}
SIBLING_TYPES = {"avg_bucket", "max_bucket", "min_bucket", "sum_bucket",
                 "stats_bucket", "extended_stats_bucket",
                 "percentiles_bucket"}
PIPELINE_TYPES = PARENT_TYPES | SIBLING_TYPES

_GAP = ("skip", "insert_zeros", "keep_values")


# -- buckets_path resolution ----------------------------------------------

def _gap_policy(params) -> str:
    gp = params.get("gap_policy", "skip")
    if gp not in _GAP:
        raise ParsingError(f"No gap policy found for value [{gp}]")
    return gp


def _metric_value(node, stat: str | None):
    """Extract a numeric from one reduced agg output."""
    if node is None:
        return None
    if stat is None:
        if "value" in node:
            return node["value"]
        raise IllegalArgumentError(
            "buckets_path must reference either a number value or a "
            "single value numeric metric aggregation")
    if stat in node:
        return node[stat]
    vals = node.get("values")
    if isinstance(vals, dict):
        for key in (stat, f"{float(stat)}" if _is_num(stat) else stat):
            if key in vals:
                return vals[key]
    raise IllegalArgumentError(f"path not supported for [{stat}]")


def _is_num(s) -> bool:
    try:
        float(s)
        return True
    except (TypeError, ValueError):
        return False


def bucket_value(bucket: dict, path: str, gap_policy: str = "skip"):
    """Value of ``path`` relative to one bucket ("_count", "metric",
    "single_bucket>metric", "stats_metric.avg"...).  Returns None for a
    gap under skip, 0.0 under insert_zeros."""
    parts = path.split(">")
    node = bucket
    for part in parts[:-1]:
        node = node.get(part.strip())
        if node is None:
            return _gap(gap_policy)
    last = parts[-1].strip()
    if last == "_count":
        return float(node["doc_count"])
    name, dot, stat = last.partition(".")
    v = _metric_value(node.get(name), stat if dot else None)
    if v is None or (isinstance(v, float) and np.isnan(v)):
        return _gap(gap_policy)
    return float(v)


def _gap(gap_policy: str):
    return 0.0 if gap_policy == "insert_zeros" else None


def _buckets_list(node):
    """Bucket list of a reduced multi-bucket agg (list, or keyed dict as
    in filters{keyed})."""
    b = node.get("buckets")
    if isinstance(b, dict):
        return list(b.values())
    return b


def sibling_values(level: dict, path: str, gap_policy: str):
    """Resolve a sibling buckets_path like "histo>metric[.stat]" against
    the reduced aggs at one level: walks single-bucket aggs, then maps
    over the multi-bucket agg's buckets.  Returns (values, keys)."""
    parts = [p.strip() for p in path.split(">")]
    node = level
    for i, part in enumerate(parts):
        nxt = node.get(part) if isinstance(node, dict) else None
        if nxt is None and "." in part and isinstance(node, dict):
            # "agg.metric" dot form: split at the first dot that names
            # an agg at this level (BucketsPath's AGG_PATH separators)
            name, _, rest = part.partition(".")
            if name in node:
                nxt = node[name]
                parts = parts[:i] + [name, rest] + parts[i + 1:]
                part = name
        if nxt is None:
            raise IllegalArgumentError(
                f"No aggregation found for path [{path}]")
        if "buckets" in nxt:
            rest = ">".join(parts[i + 1:])
            if not rest:
                raise IllegalArgumentError(
                    f"No aggregation [metric] found for path [{path}]")
            vals, keys = [], []
            for b in _buckets_list(nxt):
                if gap_policy == "skip" and b.get("doc_count") == 0:
                    # empty buckets are gaps to sibling metrics
                    # (BucketMetricsPipelineAggregator.collectBucketValue)
                    vals.append(None)
                else:
                    vals.append(bucket_value(b, rest, gap_policy))
                keys.append(b.get("key"))
            return vals, keys
        node = nxt                      # single-bucket: descend
    raise IllegalArgumentError(
        f"buckets_path [{path}] must reference a multi-bucket aggregation")


# -- host scalar script evaluation (bucket_script / bucket_selector) ------

def _eval_bucket_script(script, variables: dict):
    """Painless-subset scalar evaluation over resolved buckets_path
    variables (exposed as ``params.*`` plus bare names, matching
    BucketScriptPipelineAggregator.java:113)."""
    from opensearch_tpu_torch.search.scripting import (ScriptException,
                                                       _Evaluator,
                                                       _FieldCollector,
                                                       _painless_to_python)

    if isinstance(script, dict):
        src = script.get("source") or script.get("inline")
        params = dict(script.get("params") or {})
    else:
        src, params = str(script), {}
    if src is None:
        raise ParsingError("[script] requires a [source]")
    params.update(variables)
    try:
        tree = ast.parse(_painless_to_python(src), mode="eval")
    except SyntaxError as e:
        raise ScriptException(f"compile error in [{src}]: {e}") from None

    # the scoring whitelist, extended: bare buckets_path variable names
    # are legal in bucket-script painless (exposed alongside params.*,
    # BucketScriptPipelineAggregator.java:113)
    class _Whitelist(_FieldCollector):
        def visit_Name(self, node):
            if node.id in params:
                return
            return super().visit_Name(node)

    wl = _Whitelist()
    wl.visit(tree)
    if wl.numeric or wl.vectors:
        raise ScriptException(
            "doc[...] is not available in pipeline aggregations")

    class _Eval(_Evaluator):
        def visit_Name(self, node):
            if node.id in params:
                return self._param(node.id)
            return super().visit_Name(node)

    return _Eval(params, {}, {}, 0.0).visit(tree)


# -- moving_fn scripts ----------------------------------------------------

def _mf_stddev(values, avg):
    v = values[~np.isnan(values)]
    if len(v) == 0:
        return float("nan")
    return float(np.sqrt(np.mean((v - avg) ** 2)))


def _mf_linear(values):
    v = values[~np.isnan(values)]
    if len(v) == 0:
        return float("nan")
    w = np.arange(1, len(v) + 1, dtype=np.float64)
    return float((v * w).sum() / w.sum())


def _mf_ewma(values, alpha):
    v = values[~np.isnan(values)]
    if len(v) == 0:
        return float("nan")
    avg = v[0]
    for x in v[1:]:
        avg = alpha * x + (1 - alpha) * avg
    return float(avg)


def _mf_holt(values, alpha, beta):
    v = values[~np.isnan(values)]
    if len(v) == 0:
        return float("nan")
    if len(v) == 1:
        return float(v[0])
    s = v[0]
    b = v[1] - v[0]
    for i in range(1, len(v)):
        last_s = s
        s = alpha * v[i] + (1 - alpha) * (s + b)
        b = beta * (s - last_s) + (1 - beta) * b
    return float(s + b)


def _nan_reduce(fn):
    def run(values):
        v = values[~np.isnan(values)]
        return float(fn(v)) if len(v) else float("nan")
    return run


_MOVING_FNS = {
    "max": _nan_reduce(np.max),
    "min": _nan_reduce(np.min),
    "sum": lambda v: float(np.nansum(v)) if len(v[~np.isnan(v)]) else 0.0,
    "unweightedAvg": _nan_reduce(np.mean),
    "stdDev": _mf_stddev,
    "linearWeightedAvg": _mf_linear,
    "ewma": _mf_ewma,
    "holt": _mf_holt,
}


def _eval_moving_fn(script, window_values: np.ndarray):
    """Evaluate a moving_fn script: ``MovingFunctions.<fn>(values, ...)``
    (MovingFunctions.java whitelist) over one window."""
    if isinstance(script, dict):
        src = script.get("source") or script.get("inline") or ""
    else:
        src = str(script)
    try:
        tree = ast.parse(src.strip(), mode="eval")
    except SyntaxError:
        raise ParsingError(f"invalid moving_fn script [{src}]") from None

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value,
                                                         (int, float)):
            return float(node.value)
        if isinstance(node, ast.Name) and node.id == "values":
            return window_values
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "MovingFunctions"):
            fn = _MOVING_FNS.get(node.func.attr)
            if fn is None:
                raise ParsingError(
                    f"unknown MovingFunctions.{node.func.attr}")
            return fn(*[ev(a) for a in node.args])
        if isinstance(node, ast.BinOp):
            import operator as op

            ops = {ast.Add: op.add, ast.Sub: op.sub, ast.Mult: op.mul,
                   ast.Div: op.truediv}
            fn = ops.get(type(node.op))
            if fn is not None:
                return fn(ev(node.left), ev(node.right))
        raise ParsingError("unsupported moving_fn script construct")

    return ev(tree)


# -- parent pipelines -----------------------------------------------------

def _apply_parent(req, buckets: list):
    """Apply one parent pipeline agg to the parent's bucket list,
    returning the (possibly filtered/reordered) list."""
    params = req.params
    typ = req.type
    gp = _gap_policy(params)
    if typ in ("cumulative_sum", "derivative", "serial_diff",
               "moving_fn", "moving_avg"):
        path = params.get("buckets_path")
        if path is None:
            raise ParsingError(f"[{typ}] requires [buckets_path]")
        if isinstance(path, list):
            path = path[0]
        vals = [bucket_value(b, path, gp) for b in buckets]
        if typ == "cumulative_sum":
            # gaps contribute nothing but still get the running total
            # (CumulativeSumPipelineAggregator.java)
            total = 0.0
            for b, v in zip(buckets, vals):
                total += v if v is not None else 0.0
                b[req.name] = {"value": total}
        elif typ == "derivative":
            unit = params.get("unit")
            unit_ms = None
            if unit is not None:
                from opensearch_tpu_torch.search.aggs import _parse_duration_ms
                unit_ms = _parse_duration_ms(unit) if not str(
                    unit).isdigit() else int(unit)
            prev = prev_key = None
            for b, v in zip(buckets, vals):
                if prev is not None and v is not None:
                    diff = v - prev
                    out = {"value": diff}
                    if unit_ms and b.get("key") is not None \
                            and prev_key is not None:
                        span = (float(b["key"]) - float(prev_key)) / unit_ms
                        out["normalized_value"] = diff / span if span else None
                    b[req.name] = out
                if v is not None:
                    # a gap never clears the carried value (the reference
                    # leaves lastBucketValue untouched on NaN under every
                    # gap policy — DerivativePipelineAggregator.java)
                    prev, prev_key = v, b.get("key")
        elif typ == "serial_diff":
            lag = int(params.get("lag", 1))
            if lag < 1:
                raise IllegalArgumentError("[lag] must be a positive integer")
            hist = []
            for b, v in zip(buckets, vals):
                if len(hist) >= lag and v is not None \
                        and hist[-lag] is not None:
                    b[req.name] = {"value": v - hist[-lag]}
                hist.append(v)
        else:                                   # moving_fn / moving_avg
            window = int(params.get("window", 5))
            if window <= 0:
                raise IllegalArgumentError("[window] must be a positive "
                                           "integer")
            shift = int(params.get("shift", 0))
            arr = np.asarray([np.nan if v is None else v for v in vals],
                             np.float64)
            if typ == "moving_avg":
                script = _movavg_model_script(params)
            else:
                script = params.get("script")
                if script is None:
                    raise ParsingError("[moving_fn] requires [script]")
            n = len(arr)
            for i, b in enumerate(buckets):
                lo = max(0, min(i - window + shift, n))
                hi = max(0, min(i + shift, n))
                res = _eval_moving_fn(script, arr[lo:hi])
                if res is not None and not (isinstance(res, float)
                                            and np.isnan(res)):
                    b[req.name] = {"value": float(res)}
        return buckets
    if typ == "bucket_script":
        paths = params.get("buckets_path")
        if not isinstance(paths, dict):
            raise ParsingError("[bucket_script] requires a [buckets_path] "
                               "map")
        script = params.get("script")
        for b in buckets:
            vars_ = {}
            gap = False
            for var, p in paths.items():
                v = bucket_value(b, p, gp)
                if v is None:
                    gap = True
                    break
                vars_[var] = v
            if gap:
                continue
            val = _eval_bucket_script(script, vars_)
            b[req.name] = {"value": float(val)}
        return buckets
    if typ == "bucket_selector":
        paths = params.get("buckets_path")
        if not isinstance(paths, dict):
            raise ParsingError("[bucket_selector] requires a [buckets_path] "
                               "map")
        script = params.get("script")
        kept = []
        for b in buckets:
            vars_ = {}
            gap = False
            for var, p in paths.items():
                v = bucket_value(b, p, gp)
                if v is None:
                    gap = True
                    break
                vars_[var] = v
            if gap or bool(_eval_bucket_script(script, vars_)):
                kept.append(b)
        return kept
    if typ == "bucket_sort":
        sort = params.get("sort") or []
        from_ = int(params.get("from", 0))
        size = params.get("size")
        if sort:
            import functools

            keys = []
            for spec in sort:
                if isinstance(spec, str):
                    spec = {spec: {"order": "asc"}}
                ((path, opts),) = spec.items()
                order = (opts or {}).get("order", "desc") \
                    if isinstance(opts, dict) else "desc"
                keys.append((path, order == "desc"))

            def val_of(b, path):
                return b.get("key") if path == "_key" \
                    else bucket_value(b, path, gp)

            def cmp(a, b):
                # per-key comparison: None always sorts last; desc flips
                # the comparison, never negates (string keys sort too)
                for path, desc in keys:
                    va, vb = val_of(a, path), val_of(b, path)
                    if va == vb:
                        continue
                    if va is None:
                        return 1
                    if vb is None:
                        return -1
                    lt = va < vb
                    if desc:
                        lt = not lt
                    return -1 if lt else 1
                return 0

            buckets = sorted(buckets, key=functools.cmp_to_key(cmp))
        end = None if size is None else from_ + int(size)
        return buckets[from_:end]
    raise ParsingError(f"unknown pipeline aggregation [{typ}]")


def _movavg_model_script(params) -> str:
    """Legacy moving_avg model -> the equivalent MovingFunctions call
    (the same mapping the reference documents for migrating off
    MovAvgPipelineAggregator)."""
    model = params.get("model", "simple")
    s = params.get("settings") or {}
    if model == "simple":
        return "MovingFunctions.unweightedAvg(values)"
    if model == "linear":
        return "MovingFunctions.linearWeightedAvg(values)"
    if model == "ewma":
        return f"MovingFunctions.ewma(values, {float(s.get('alpha', 0.3))})"
    if model == "holt":
        return (f"MovingFunctions.holt(values, "
                f"{float(s.get('alpha', 0.3))}, {float(s.get('beta', 0.1))})")
    raise ParsingError(f"moving_avg model [{model}] is not supported "
                       "(use moving_fn for holt_winters)")


# -- sibling pipelines ----------------------------------------------------

def _sibling_result(req, level: dict):
    params = req.params
    gp = _gap_policy(params)
    path = params.get("buckets_path")
    if path is None:
        raise ParsingError(f"[{req.type}] requires [buckets_path]")
    if isinstance(path, list):
        path = path[0]
    vals, keys = sibling_values(level, path, gp)
    pairs = [(v, k) for v, k in zip(vals, keys) if v is not None]
    clean = np.asarray([v for v, _ in pairs], np.float64)
    typ = req.type
    if typ == "avg_bucket":
        return {"value": float(clean.mean()) if len(clean) else None}
    if typ == "sum_bucket":
        return {"value": float(clean.sum()) if len(clean) else 0.0}
    if typ in ("max_bucket", "min_bucket"):
        if not len(clean):
            return {"value": None, "keys": []}
        best = float(clean.max() if typ == "max_bucket" else clean.min())
        ks = [str(k) for v, k in pairs if v == best]
        return {"value": best, "keys": ks}
    if typ == "stats_bucket":
        if not len(clean):
            return {"count": 0, "min": None, "max": None, "avg": None,
                    "sum": 0.0}
        return {"count": int(len(clean)), "min": float(clean.min()),
                "max": float(clean.max()), "avg": float(clean.mean()),
                "sum": float(clean.sum())}
    if typ == "extended_stats_bucket":
        sigma = float(params.get("sigma", 2.0))
        n = len(clean)
        if not n:
            return {"count": 0, "min": None, "max": None, "avg": None,
                    "sum": 0.0, "sum_of_squares": None, "variance": None,
                    "std_deviation": None,
                    "std_deviation_bounds": {"upper": None, "lower": None}}
        sq = float((clean ** 2).sum())
        avg = float(clean.mean())
        var = sq / n - avg * avg
        std = float(np.sqrt(max(var, 0.0)))
        return {"count": n, "min": float(clean.min()),
                "max": float(clean.max()), "avg": avg,
                "sum": float(clean.sum()), "sum_of_squares": sq,
                "variance": var, "variance_population": var,
                "variance_sampling": (sq - n * avg * avg) / (n - 1)
                if n > 1 else None,
                "std_deviation": std, "std_deviation_population": std,
                "std_deviation_sampling": float(np.sqrt(max(
                    (sq - n * avg * avg) / (n - 1), 0.0)))
                if n > 1 else None,
                "std_deviation_bounds": {"upper": avg + sigma * std,
                                         "lower": avg - sigma * std}}
    if typ == "percentiles_bucket":
        percents = params.get("percents",
                              [1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0])
        if not len(clean):
            return {"values": {f"{float(p)}": None for p in percents}}
        # the reference uses the nearest-rank method over the sorted
        # bucket values (PercentilesBucketPipelineAggregator.java:126)
        s = np.sort(clean)
        out = {}
        for p in percents:
            i = int(round(float(p) / 100.0 * len(s))) - 1
            out[f"{float(p)}"] = float(s[max(0, min(i, len(s) - 1))])
        return {"values": out}
    raise ParsingError(f"unknown pipeline aggregation [{typ}]")


# -- tree application -----------------------------------------------------

def apply_pipelines(reqs: list, out: dict):
    """Post-reduce pass over one reduced aggs level: recurse into bucket
    trees, run parent pipelines inside their parent's buckets, then
    sibling pipelines at this level — all in declaration order so chains
    (derivative of cumulative_sum, max_bucket of derivative) work."""
    for r in reqs:
        if r.type in PARENT_TYPES:
            # parent pipelines only make sense inside a multi-bucket agg
            # (the reference 400s at validate(); silently dropping the
            # name would hide the mistake from the client)
            raise IllegalArgumentError(
                f"[{r.type}] aggregation [{r.name}] must be declared "
                "inside a multi-bucket aggregation")
    for r in reqs:
        if r.type in PIPELINE_TYPES:
            continue
        node = out.get(r.name)
        if node is not None:
            _apply_in_agg(r, node)
    for r in reqs:
        if r.type in SIBLING_TYPES:
            out[r.name] = _sibling_result(r, out)
    return out


def _apply_in_agg(req, node: dict):
    """Recurse + apply the pipeline subs of one reduced bucket agg."""
    buckets = node.get("buckets")
    if buckets is None:
        # single-bucket agg (filter/global/missing): its subs live as
        # named keys on the node itself — treat the node as one level
        if "doc_count" in node and req.subs:
            apply_pipelines(req.subs, node)
        return
    keyed = isinstance(buckets, dict)
    blist = list(buckets.values()) if keyed else buckets
    # deeper levels first
    for b in blist:
        for sub in req.subs:
            if sub.type in PIPELINE_TYPES:
                continue
            sub_node = b.get(sub.name)
            if sub_node is not None:
                _apply_in_agg(sub, sub_node)
    # sibling pipes nested one level down operate within each bucket
    for b in blist:
        for sub in req.subs:
            if sub.type in SIBLING_TYPES:
                b[sub.name] = _sibling_result(sub, b)
    # parent pipes transform the bucket list in declaration order
    for sub in req.subs:
        if sub.type in PARENT_TYPES:
            blist = _apply_parent(sub, blist)
    if keyed:
        # rebuild the keyed dict in the (possibly sorted/filtered)
        # bucket order — JSON key order carries bucket_sort's result
        by_id = {id(b): k for k, b in buckets.items()}
        node["buckets"] = {by_id[id(b)]: b for b in blist
                           if id(b) in by_id}
    else:
        node["buckets"] = blist
