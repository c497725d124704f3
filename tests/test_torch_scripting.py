"""script_score and score scripts of the PyTorch port against the JAX
package, on the CPU.

- One case per test of ``tests/test_scripting.py``: the same segments
  (``segment_arrays`` / ``segment_from_arrays``) through the reference's
  ``ShardSearcher`` and the port's, ids equal but for near-ties and
  scores within ``ops/knn.py``'s ``RTOL`` / ``ATOL`` (the reference sums
  its vector functions in float32, the port in float64 rounded once);
  the same 400s; the same plan for a script whose param values differ;
  the same Painless rewrite.
- More bodies (the ``knn_score`` script in the three spaces, general
  sources over ``match`` / ``bool`` filter children, ``min_score``,
  ``boost``, ``size: 0``, ``_count``) through the searcher and the
  engine.
- The plain raw functions (``ops/knn.py`` ``vector_scores``) against the
  reference evaluator's ``vec @ q`` expressions at three seeds; their
  float64 sums do not depend on summation order on random data; the
  kernel's lane order (a numpy model of ``csrc/knn.cu``'s lanes and xor
  shuffles) equals ``row_sums`` byte for byte.
- The segments-table wrapper refuses CPU tensors; its table and chunks.
- ``script_score`` over HTTP on the port's node against the reference
  node.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_tpu.common.errors import OpenSearchTpuError as JaxError
from opensearch_tpu.index.segment import SegmentWriter as JaxWriter
from opensearch_tpu.mapping.mapper import DocumentMapper as JaxMapper
from opensearch_tpu.ops import bm25 as jbm25
from opensearch_tpu.search import scripting as jscript
from opensearch_tpu.search.executor import ShardSearcher as JaxSearcher
from opensearch_tpu_torch.common.errors import OpenSearchTpuError
from opensearch_tpu_torch.index.segment import (segment_arrays,
                                                segment_from_arrays)
from opensearch_tpu_torch.mapping.mapper import DocumentMapper
from opensearch_tpu_torch.ops import cuda_knn
from opensearch_tpu_torch.ops import knn as tknn
from opensearch_tpu_torch.search import scripting as tscript
from opensearch_tpu_torch.search.executor import ShardSearcher
from opensearch_tpu_torch.testing.parity import knn_mismatch
from test_torch_rest import call as http_call
from test_torch_rest import nodes  # noqa: F401  (the fixture)

DIM = 8
MAPPING = {"properties": {
    "title": {"type": "text"},
    "rank": {"type": "long"},
    "weight": {"type": "double"},
    "vec": {"type": "knn_vector", "dimension": DIM, "space_type": "l2"},
}}


def build_pair(n=20, seed=3):
    """``tests/test_scripting.py``'s ``build`` for both packages: 20 docs
    in two segments, one without ``weight``; (reference searcher, port
    searcher, vectors)."""
    rng = np.random.default_rng(seed)
    mapper, writer = JaxMapper(MAPPING), JaxWriter()
    vecs = rng.normal(size=(n, DIM)).astype(np.float32)
    segs, parsed = [], []
    for i in range(n):
        doc = {"title": "common words here", "rank": i,
               "weight": float(i) / 2.0, "vec": vecs[i].tolist()}
        if i == n - 1:
            doc.pop("weight")
        parsed.append(mapper.parse(str(i), doc))
        if i == n // 2:
            segs.append(writer.build(parsed, "sc0"))
            parsed = []
    segs.append(writer.build(parsed, "sc1"))
    tsegs = [segment_from_arrays(*segment_arrays(s)) for s in segs]
    return (JaxSearcher(segs, mapper),
            ShardSearcher(tsegs, DocumentMapper(MAPPING), device="cpu"),
            vecs)


@pytest.fixture(scope="module")
def pair():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbm25, "HOST_SCORING", False)
        yield build_pair()


def script_body(script, query=None, size=30, **kw):
    return {"query": {"script_score": {
        "query": query or {"match_all": {}}, "script": script, **kw}},
        "size": size}


def same(pair, body):
    """Both searchers answer ``body`` alike (ids but near-ties, scores
    within RTOL / ATOL, equal totals); returns the port's response."""
    ref = json.loads(json.dumps(pair[0].search(dict(body))))
    got = json.loads(json.dumps(pair[1].search(dict(body))))
    bad = knn_mismatch(got, ref)
    assert bad is None, (body, bad)
    return got


def same_error(pair, body):
    """Both refuse ``body`` with a 400."""
    with pytest.raises(JaxError) as ref:
        pair[0].search(dict(body))
    with pytest.raises(OpenSearchTpuError) as got:
        pair[1].search(dict(body))
    assert getattr(ref.value, "status", 500) == 400
    assert got.value.status == 400, (body, got.value)
    return got.value


def scores_by_id(resp):
    return {h["_id"]: h["_score"] for h in resp["hits"]["hits"]}


# -- one case per test of tests/test_scripting.py ------------------------------

def test_field_arithmetic_and_score_as_the_reference(pair):
    got = same(pair, script_body({"source": "_score * 2 + doc['rank'].value"},
                                 query={"match": {"title": "common"}}))
    base = scores_by_id(pair[1].search({"query": {"match": {
        "title": "common"}}, "size": 30}))
    for did, s in scores_by_id(got).items():
        assert s == pytest.approx(base[did] * 2 + int(did), rel=1e-5)


def test_math_functions_and_params_as_the_reference(pair):
    got = same(pair, script_body({
        "source": "Math.log(doc['rank'].value + params.offset)",
        "params": {"offset": 2}}))
    for did, s in scores_by_id(got).items():
        assert s == pytest.approx(np.log(int(did) + 2), rel=1e-5)


def test_missing_value_reads_zero_and_size_as_the_reference(pair):
    got = scores_by_id(same(pair, script_body({
        "source": "doc['weight'].size() > 0 ? doc['weight'].value : -1"})))
    assert got["19"] == pytest.approx(-1.0)
    assert got["4"] == pytest.approx(2.0)


def test_knn_score_script_matches_exact_knn_as_the_reference(pair):
    q = pair[2][7] + 0.05
    got = same(pair, {"query": {"script_score": {
        "query": {"match_all": {}},
        "script": {"lang": "knn", "source": "knn_score",
                   "params": {"field": "vec", "query_value": q.tolist(),
                              "space_type": "l2"}}}}, "size": 5})
    knn = pair[1].search({"query": {"knn": {"vec": {
        "vector": q.tolist(), "k": 5}}}, "size": 5})
    assert [h["_id"] for h in got["hits"]["hits"]] == \
        [h["_id"] for h in knn["hits"]["hits"]]
    for a, b in zip(got["hits"]["hits"], knn["hits"]["hits"]):
        assert a["_score"] == pytest.approx(b["_score"], rel=1e-5)


def test_cosine_similarity_function_as_the_reference(pair):
    q = np.ones(DIM, np.float32)
    got = scores_by_id(same(pair, script_body({
        "source": "cosineSimilarity(params.qv, doc['vec']) + 1.0",
        "params": {"qv": q.tolist()}})))
    for did, s in got.items():
        v = pair[2][int(did)]
        cos = float(v @ q / (np.linalg.norm(v) * np.linalg.norm(q)))
        assert s == pytest.approx(cos + 1.0, rel=1e-4)


def test_min_score_filters_docs_as_the_reference(pair):
    got = same(pair, script_body({"source": "doc['rank'].value"},
                                 min_score=10))
    assert set(scores_by_id(got)) == {str(i) for i in range(10, 20)}


@pytest.mark.parametrize("bad", [
    {"source": "__import__('os').system('x')"},
    {"source": "doc['rank'].value; 1"},
    {"source": "while True: 1"},
    {"source": "unknownvar + 1"},
    {"source": "doc['rank'].values"},
    {"source": "params.qv.unknown()"},
    {"lang": "mustache", "source": "1"},
    {"source": ""},
    {"lang": "knn", "source": "knn_score",
     "params": {"field": "vec", "query_value": [0.0] * DIM,
                "space_type": "hamming"}},
    {"lang": "knn", "source": "knn_score", "params": {"field": "vec"}},
])
def test_unknown_constructs_are_400_not_crash_as_the_reference(pair, bad):
    same_error(pair, script_body(bad))


def test_script_over_text_field_rejected_as_the_reference(pair):
    err = same_error(pair, script_body({"source": "doc['title'].value"}))
    assert isinstance(err, tscript.ScriptException)
    same_error(pair, script_body({
        "source": "dotProduct(params.q, doc['rank'])",
        "params": {"q": [1.0] * DIM}}))


def test_same_script_shares_program_across_param_values_as_the_reference(
        pair):
    from opensearch_tpu_torch.search.compiler import compile_query
    from opensearch_tpu_torch.search.query_dsl import parse_query

    plans = []
    for f in (2.0, 5.0):
        q = parse_query({"script_score": {
            "query": {"match_all": {}},
            "script": {"source": "doc['rank'].value * params.f",
                       "params": {"f": f}}}})
        plans.append(compile_query(q, pair[1].ctx)[0])
    assert plans[0] == plans[1] and hash(plans[0]) == hash(plans[1])


@pytest.mark.parametrize("src", [
    "a && b || !c", "doc['true'].value * 2", "x != 1",
    "doc['w'].size() > 0 && true ? doc['w'].value : 0"])
def test_painless_syntax_translation_preserves_quoted_fields_as_the_reference(
        src):
    assert tscript._painless_to_python(src) == \
        jscript._painless_to_python(src)


# -- more bodies: spaces, children, min_score, the engine ----------------------

def knn_score(q, space, **kw):
    return {"query": {"script_score": {
        "query": kw.pop("query", {"match_all": {}}),
        "script": {"lang": "knn", "source": "knn_score",
                   "params": {"field": "vec", "query_value": q.tolist(),
                              "space_type": space}}, **kw}}, "size": 7}


def more_bodies(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=DIM).astype(np.float32)
    q2 = rng.normal(size=DIM).astype(np.float32)
    return [
        knn_score(q, "l2"), knn_score(q, "cosinesimil"),
        knn_score(q, "innerproduct"),
        knn_score(q, "l2", query={"bool": {"filter": [
            {"range": {"rank": {"gte": 3, "lt": 15}}}]}}),
        knn_score(q, "l2", min_score=0.02, boost=2.0),
        script_body({"source": "_score * dotProduct(params.q, doc['vec'])",
                     "params": {"q": q.tolist()}},
                    query={"match": {"title": "words"}}, size=10),
        script_body({"source": "l2Squared(params.q, doc['vec']) + "
                               "l2Squared(params.q, doc['vec']) - "
                               "cosineSimilarity(params.p, doc['vec'])",
                     "params": {"q": q.tolist(), "p": q2.tolist()}}),
        script_body({"source": "sigmoid(dotProduct([1, 0, 0, 0, 0, 0, 0, "
                               "1], doc['vec'])) * Math.max(doc['rank']"
                               ".value, 3) + Math.pow(2, 3)"}),
        script_body({"source": "doc['weight'].value >= 2 && "
                               "doc['rank'].value < 12 ? Math.sqrt("
                               "doc['weight'].value) : Math.floor(1.5)"}),
        script_body({"source": "params.a * 2 + 1", "params": {"a": 0.25}}),
        {**knn_score(q, "l2"), "size": 0},
    ]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_script_score_bodies_as_the_reference(pair, seed):
    for body in more_bodies(seed):
        same(pair, body)


def test_script_score_count_and_the_engine(pair):
    """``_count`` with a script_score (``min_score`` in play) and the
    engine's ``execute`` (the continuous batcher bypasses it, the plain
    pipeline serves it) answer as the searcher and the reference do."""
    from opensearch_tpu_torch.search.batch import batchable
    from opensearch_tpu_torch.search.engine import query_engine

    class Svc:
        def _use_mesh(self, body):
            return False

    for body in more_bodies(5)[:6]:
        q = body["query"]
        assert pair[1].count(q) == pair[0].count(q)
        assert batchable(pair[1], body) is None
        got = query_engine().execute(pair[1], dict(body), service=Svc())
        assert knn_mismatch(got, pair[0].search(dict(body))) is None


def cached_bytes(searcher) -> int:
    """Bytes of the distinct tensor storages the searcher's plan and
    prepared-bindings caches hold."""
    seen, storages = set(), {}

    def walk(x):
        if id(x) in seen:
            return
        seen.add(id(x))
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif hasattr(x, "__dict__"):
            walk(vars(x))

    for cache in (searcher._plan_cache, searcher._prep_cache):
        walk(cache._entries)
    return sum(storages.values())


def test_script_score_columns_are_not_cached():
    """A script_score's per-row vector columns stay out of the searcher's
    caches: a second knn_score body with a new query vector leaves the
    cached bytes as the first left them."""
    searcher = build_pair()[1]
    rng = np.random.default_rng(11)
    before = cached_bytes(searcher)
    held = []
    for _ in range(3):
        q = rng.normal(size=DIM).astype(np.float32)
        searcher.search(knn_score(q, "l2"))
        searcher.search(knn_score(q, "l2", query={"match": {
            "title": "words"}}))
        held.append(cached_bytes(searcher))
    assert held == [before] * 3
    assert len(searcher._plan_cache._entries) == 0
    # a query without a script is still cached
    searcher.search({"query": {"match": {"title": "words"}}})
    assert len(searcher._plan_cache._entries) == 1


# -- the plain raw functions ---------------------------------------------------

def ref_vector_fn(fn, vectors, query):
    """The reference evaluator's expression for ``fn`` (``vec @ q`` and
    row norms in float32, XLA's order)."""
    prog = jscript.compile_score_script({
        "source": f"{fn}(params.q, doc['v'])", "params": {"q": query.tolist()}})
    vec = jnp.asarray(vectors)
    return np.asarray(prog.eval(jnp.zeros(len(vectors), jnp.float32), {},
                                {"v": (vec, jnp.ones(len(vectors), bool))},
                                prog.param_values()))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fn", tknn.SCRIPT_FNS)
def test_raw_vector_functions_match_the_reference_evaluator(fn, seed):
    rng = np.random.default_rng(seed)
    d = (128, 100, 3)[seed]
    vectors = rng.standard_normal((500, d)).astype(np.float32)
    vectors[:5] = 0.0                    # rows without a vector: zeros
    query = rng.standard_normal(d).astype(np.float32)
    got = tknn.vector_scores(torch.from_numpy(vectors), None,
                             torch.from_numpy(query), fn=fn).numpy()
    ref = ref_vector_fn(fn, vectors, query)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    # l2Squared cancels: the reference's float32 |v|^2 - 2 v.q + |q|^2
    # errs by ~eps * |v|^2 (ROADMAP Queue C), so the atol scales with it
    atol = tknn.ATOL * (64 if fn == "l2Squared" else 1)
    np.testing.assert_allclose(got, ref, rtol=tknn.RTOL, atol=atol)
    zero_row = float(query.astype(np.float64) @ query) \
        if fn == "l2Squared" else 0.0
    assert (got[:5] == np.float32(zero_row)).all()


@pytest.mark.parametrize("fn", tknn.FUNCTIONS)
def test_vector_functions_do_not_depend_on_summation_order(fn):
    """Summed in float64 and rounded to float32 once, the six functions
    give numpy's sums over the dimensions reversed byte for byte on
    random data (the card's sums, in K1's order, give the plain
    version's bytes by construction: the next test)."""
    rng = np.random.default_rng(21)
    vectors = rng.standard_normal((3000, 128)).astype(np.float32)
    query = rng.standard_normal(128).astype(np.float32)
    v = vectors[:, ::-1].astype(np.float64)
    q = query[::-1].astype(np.float64)
    dots = np.einsum("ij,j->i", v, q)
    v2 = np.einsum("ij,ij->i", v, v)
    q2 = q @ q
    want = {
        "l2": 1.0 / (1.0 + np.maximum(v2 - 2.0 * dots + q2, 0.0)),
        "cosinesimil": (1.0 + dots / np.maximum(np.sqrt(v2) * np.sqrt(q2),
                                                1e-30)) / 2.0,
        "innerproduct": np.where(dots >= 0, dots + 1.0, 1.0 / (1.0 - dots)),
        "dotProduct": dots,
        "l2Squared": np.maximum(v2 - 2.0 * dots + q2, 0.0),
        "cosineSimilarity": dots / np.maximum(np.sqrt(v2) * np.sqrt(q2),
                                              1e-30),
    }[fn]
    got = tknn.vector_scores(torch.from_numpy(vectors), None,
                             torch.from_numpy(query), fn=fn)
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.astype(np.float32).tobytes()


def kernel_lane_sums(vectors, query):
    """A numpy model of ``csrc/knn.cu``'s per-row sums: L lanes a row,
    lane j fma-ing the units j, j + L, ... (a float4's x, y, z, w, or one
    float), then the xor shuffles off = L/2 .. 1 on every lane, lane 0's
    value kept; |q|^2 over 32 lanes the same way."""
    n, d = vectors.shape
    width = 4 if d % 4 == 0 else 1
    units = d // width
    lanes = tknn.row_lanes(d)
    v = vectors.astype(np.float64)
    q = query.astype(np.float64)

    def shuffle(x):                     # x [..., L]: every lane's value
        off = x.shape[-1] // 2
        while off:
            x = x + x[..., np.arange(x.shape[-1]) ^ off]
            off //= 2
        return x[..., 0]

    dot = np.zeros((n, lanes))
    v2 = np.zeros((n, lanes))
    for j in range(lanes):
        for u in range(j, units, lanes):
            for c in range(width):
                e = u * width + c
                dot[:, j] = dot[:, j] + v[:, e] * q[e]
                v2[:, j] = v2[:, j] + v[:, e] * v[:, e]
    qq = np.zeros(32)
    for j in range(32):
        for e in range(j, d, 32):
            qq[j] = qq[j] + q[e] * q[e]
    return shuffle(dot), shuffle(v2), shuffle(qq)


@pytest.mark.parametrize("d", [1, 3, 4, 30, 100, 128, 129, 960])
def test_row_sums_take_the_kernels_lane_order(d):
    rng = np.random.default_rng(d)
    vectors = (rng.standard_normal((64, d)) * 3).astype(np.float32)
    query = rng.standard_normal(d).astype(np.float32)
    want = kernel_lane_sums(vectors, query)
    got = tknn.row_sums(torch.from_numpy(vectors), torch.from_numpy(query))
    for w, g in zip(want, got):
        assert np.asarray(g.numpy(), np.float64).tobytes() == \
            np.asarray(w, np.float64).tobytes()


def test_vector_scores_segments_and_the_dispatcher_on_cpu():
    """The plain version over a list of segments: each segment's rows,
    -inf where ``exists & live & mask`` is False, every row when
    ``exists`` is None, empty segments empty; the dispatcher takes it on
    a CPU query and launches nothing."""
    rng = np.random.default_rng(4)
    segs = []
    for n in (0, 7, 50):
        v = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))
        flags = [torch.from_numpy(rng.random(n) > 0.3) for _ in range(3)]
        segs.append(tknn.KnnSegment(v, *flags))
        segs.append(tknn.KnnSegment(v, None))
    q = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    before = cuda_knn.knn_scores_segments_cuda.launches
    for fn in tknn.FUNCTIONS:
        outs = tknn.vector_scores_segments_auto(segs, q, fn=fn)
        assert len(outs) == len(segs)
        for seg, out in zip(segs, outs):
            valid = tknn.segment_valid(seg)
            want = tknn.vector_scores(seg.vectors, None, q, fn=fn)
            if valid is not None:
                want = torch.where(valid, want, -torch.inf)
            assert out.shape == (seg.vectors.shape[0],)
            assert out.numpy().tobytes() == want.numpy().tobytes()
    assert cuda_knn.knn_scores_segments_cuda.launches == before


# -- the segments-table wrapper ------------------------------------------------

def test_scores_segments_wrapper_refuses_cpu_tensors():
    seg = tknn.KnnSegment(torch.zeros(4, DIM), None)
    q = torch.zeros(DIM)
    for fn in tknn.FUNCTIONS:
        with pytest.raises(ValueError, match="CUDA"):
            cuda_knn.knn_scores_segments_cuda([seg], q, fn=fn)
    with pytest.raises(ValueError, match="function"):
        cuda_knn.knn_scores_segments_cuda([seg], q, fn="hamming")
    assert cuda_knn.knn_scores_segments_cuda.launches == 0


@pytest.mark.parametrize("rows,d,sms,chunk", [
    (65_536, 128, 132, 32),          # one scale segment: 2,048 blocks
    (16 * 65_536, 128, 132, 512),    # the 16 of them: 2,048 blocks
    (1_000_000, 128, 132, 512),
    (100, 128, 132, 32),             # fewer rows than one wave: 1 pass
    (65_536, 3, 132, 256),           # one lane a row: 256 rows a pass
    (10 ** 9, 128, 132, 32 * 64),    # at most SCORE_MAX_PASSES
])
def test_score_chunk_rows_fill_two_waves(rows, d, sms, chunk):
    got = cuda_knn.score_chunk_rows(rows, d, sms)
    assert got == chunk
    per_pass = 256 // tknn.row_lanes(d)
    assert got % per_pass == 0
    blocks = -(-rows // got)
    target = cuda_knn.SCORE_WAVES * cuda_knn.SCORE_BLOCKS_PER_SM * sms
    assert blocks >= target or got == per_pass
    assert got == per_pass * cuda_knn.SCORE_MAX_PASSES or \
        -(-rows // (2 * got)) < target


def test_scores_table_is_the_launch_tables_head():
    """The scores entry reads the top-k table's head alone: each
    segment's pointers, rows, first block, blocks and first output
    element; no work list and no counters."""
    rows = [7, 0, 100, 64]
    ptrs = [(16 * (s + 1), 0 if s == 1 else 5, 0, 9) for s in range(4)]
    offsets = [0, 7, 7, 107]
    head, n_blocks = cuda_knn.launch_table(ptrs, rows, offsets,
                                           chunk_rows=32, work_list=False)
    chunks = [1, 1, 4, 2]
    assert n_blocks == sum(chunks) and head.dtype == np.int64
    assert head.shape == (4 * cuda_knn.SEG_WORDS,)
    h = head.reshape(4, cuda_knn.SEG_WORDS)
    np.testing.assert_array_equal(h[:, 0:4], ptrs)
    np.testing.assert_array_equal(h[:, 4], rows)
    np.testing.assert_array_equal(h[:, 5], [0, 1, 2, 6])
    np.testing.assert_array_equal(h[:, 6], chunks)
    np.testing.assert_array_equal(h[:, 7], offsets)
    full, nb = cuda_knn.launch_table(ptrs, rows, offsets, chunk_rows=32)
    assert nb == n_blocks
    np.testing.assert_array_equal(full[: head.shape[0]], head)


# -- over HTTP -----------------------------------------------------------------

def script_docs(seed, n):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        lines += [{"index": {"_index": "scripted", "_id": str(i)}},
                  {"title": " ".join(f"w{int(w) % 9}" for w in
                                     rng.zipf(1.4, size=4)),
                   "rank": int(rng.integers(0, 50)),
                   "vec": rng.normal(size=DIM).astype(np.float32).tolist()}]
    return lines


def test_script_score_over_http_as_the_reference_node(nodes):  # noqa: F811
    for node in nodes:
        assert http_call(node, "PUT", "/scripted", {"mappings": MAPPING})[0] \
            == 200
        assert http_call(node, "POST", "/_bulk?refresh=true",
                         ndjson=script_docs(9, 60))[0] == 200
    rng = np.random.default_rng(10)
    bodies = []
    for space in ("l2", "cosinesimil", "innerproduct"):
        q = rng.normal(size=DIM).astype(np.float32)
        bodies.append(knn_score(q, space))
    q = rng.normal(size=DIM).astype(np.float32)
    bodies += [
        knn_score(q, "l2", query={"bool": {"filter": [
            {"range": {"rank": {"gte": 10}}}]}}, min_score=0.01),
        script_body({"source": "_score * l2Squared(params.q, doc['vec'])",
                     "params": {"q": q.tolist()}},
                    query={"match": {"title": "w1 w2"}}),
        script_body({"source": "Math.log(doc['rank'].value + 1)"})]
    for body in bodies:
        ref, port = (http_call(n, "POST", "/scripted/_search", body)
                     for n in nodes)
        assert ref[0] == port[0] == 200, (body, ref, port)
        assert knn_mismatch(port[1], ref[1]) is None, body
        ref, port = (http_call(n, "POST", "/scripted/_count",
                               {"query": body["query"]}) for n in nodes)
        assert ref == port
    bad = script_body({"source": "doc['title'].value"})
    ref, port = (http_call(n, "POST", "/scripted/_search", bad)
                 for n in nodes)
    assert ref[0] == port[0] == 400
    assert port[1]["error"]["type"] == ref[1]["error"]["type"]
    for node in nodes:
        assert http_call(node, "DELETE", "/scripted")[0] == 200
