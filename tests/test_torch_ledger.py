"""The residency ledger, the quantized pager and the device budget of the
PyTorch port (``common/device_ledger.py`` and its callers in
``index/segment.py``, the executor, the batch and ``search/sorting.py``),
on the CPU against the JAX package.

Case for case from ``tests/test_device_ledger.py`` (accounting equal to
the staged tensors, lazy columns and live snapshots, groups released with
their views, ``host_footprint``, budget eviction, the breaker charge, the
eviction order, restages, the batched path under a budget, transfer
counters, the compile registry) and ``tests/test_quantized.py`` (the
pager: LRU eviction and restage, prefetch never evicts, eviction
invisible in the hits, the prefetch oracle, its stats).

The reference scores an evicted segment's term bags on its host impact
tables (``host_fallbacks``); the port has no host scoring: an evicted
segment is staged again on its next use (``restages``) and
``host_fallbacks`` stays 0.  Those cases say so.  The reference's
Prometheus gauges, ``_nodes/stats`` / ``_cat`` columns, insights and its
staging lint wait for modules the port does not have yet.  Beyond the
reference: a request's working set stays resident under a budget below
it, an evicted view and its tensors are freed, the searcher's sort key
columns are counted, the ANN indexes a view adopts are counted and
dropped with their bound, a segment keeps at most 8 quantized table sets
a field, the fielddata breaker's default follows the card, and node
settings apply the budget and the page size.
"""

import gc
import json

import numpy as np
import pytest
import torch

from opensearch_tpu.common.device_ledger import \
    host_footprint as jax_host_footprint
from opensearch_tpu.index import codec as jcodec
from opensearch_tpu.index.segment import SegmentWriter as JaxWriter
from opensearch_tpu.mapping.mapper import DocumentMapper as JaxMapper
from opensearch_tpu.ops import bm25 as jax_bm25
from opensearch_tpu.search.executor import ShardSearcher as JaxSearcher
from opensearch_tpu_torch.common import breakers
from opensearch_tpu_torch.common.breakers import breaker_service
from opensearch_tpu_torch.common.device_ledger import (KernelCompileRegistry,
                                                       device_ledger,
                                                       device_pager,
                                                       host_footprint,
                                                       kernel_registry)
from opensearch_tpu_torch.index import codec as tcodec
from opensearch_tpu_torch.index.segment import (SegmentWriter,
                                                segment_arrays,
                                                segment_from_arrays)
from opensearch_tpu_torch.mapping.mapper import DocumentMapper
from opensearch_tpu_torch.node import Node
from opensearch_tpu_torch.ops import cuda_build
from opensearch_tpu_torch.search import profile as profile_mod
from opensearch_tpu_torch.search.executor import ShardSearcher

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean_ledger(monkeypatch):
    """The ledger is process-global (like the breakers): reset it around
    every test; the reference scores on its device path."""
    led = device_ledger()
    led.reset()
    monkeypatch.setattr(jax_bm25, "HOST_SCORING", False)
    yield
    led.reset()


MAPPING = {"properties": {"t": {"type": "text"},
                          "k": {"type": "keyword"},
                          "n": {"type": "long"}}}
TEXTS = [["alpha beta", "beta gamma", "alpha alpha gamma"],
         ["beta beta delta", "alpha gamma", "gamma delta"],
         ["alpha delta", "beta", "alpha beta gamma delta"]]


def _segments(mapper_cls, writer_cls, n_segs):
    mapper = mapper_cls(MAPPING)
    segs = []
    for i in range(n_segs):
        docs = TEXTS[i % len(TEXTS)]
        base = i * 3
        parsed = [mapper.parse(str(base + j),
                               {"t": t, "k": f"g{j % 2}", "n": base + j})
                  for j, t in enumerate(docs)]
        segs.append(writer_cls().build(parsed, f"s{i}"))
    return mapper, segs


def _searcher(n_segs=2):
    mapper, segs = _segments(DocumentMapper, SegmentWriter, n_segs)
    return ShardSearcher(segs, mapper, index_name="ledgerix", device="cpu")


def _jax_searcher(n_segs=2):
    mapper, segs = _segments(JaxMapper, JaxWriter, n_segs)
    return JaxSearcher(segs, mapper, index_name="ledgerix")


def _tensors(value):
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, dict):
        return [t for v in value.values() for t in _tensors(v)]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _tensors(v)]
    return []


def _staged_nbytes(dseg):
    """Walk the ACTUAL staged tensors of one view (distinct storages)."""
    seen = {}
    for fam in (dseg.postings, dseg.norms, dseg.numeric, dseg.ordinal,
                dseg.vector, dseg.geo, dseg._nested, dseg._impact_cache):
        for t in _tensors(fam):
            seen[t.data_ptr()] = t.numel() * t.element_size()
    for _live_np, staged in dseg._live_cache.values():
        seen[staged.data_ptr()] = staged.numel() * staged.element_size()
    return sum(seen.values()) + sum(st.nbytes()
                                    for _i, st in dseg._ann_staged.values())


def _hits(resp):
    return json.dumps(resp["hits"], sort_keys=True)


# -- accounting parity ------------------------------------------------------

def test_ledger_matches_staged_nbytes_exactly():
    s = _searcher(n_segs=2)
    led = device_ledger()
    for seg in s.segments:
        dseg = seg.device(CPU)
        assert led.device_footprint(seg) == _staged_nbytes(dseg)
    assert led.resident_bytes() == sum(
        _staged_nbytes(seg.device(CPU)) for seg in s.segments)
    # staging goes through the ledger: its stage counter saw every byte
    assert led.stats()["transfers"]["stage"]["bytes"] == \
        led.resident_bytes()


def test_ledger_tracks_lazy_impacts_and_live_snapshots():
    s = _searcher(n_segs=1)
    seg = s.segments[0]
    dseg = seg.device(CPU)
    led = device_ledger()
    before = led.device_footprint(seg)
    imp = dseg.impacts("t", 2.0)
    assert led.device_footprint(seg) == before + imp.nbytes
    # a deletes-replaced live bitmap stages a NEW snapshot entry
    seg.apply_deletes([0])
    live2 = dseg.live_mask(seg.live)
    assert led.device_footprint(seg) == before + imp.nbytes + live2.nbytes
    # positions and norms staged on demand join the group too
    dseg.ensure_positions("t")
    dseg.ensure_norms("t")
    assert led.device_footprint(seg) == _staged_nbytes(dseg)
    by_kind = led.segments()[0]["by_kind"]
    assert by_kind["impacts"] == imp.nbytes and by_kind["live"] > 0


def test_refresh_away_releases_ledger_groups():
    s = _searcher(n_segs=2)
    for seg in s.segments:
        seg.device(CPU)
    led = device_ledger()
    assert led.resident_bytes() > 0
    assert led.stats()["resident_segments"] == 2
    for seg in s.segments:
        seg._device.clear()
    del s
    gc.collect()
    assert led.stats()["resident_segments"] == 0
    assert led.resident_bytes() == 0


def test_host_footprint_is_the_single_size_source():
    s = _searcher(n_segs=1)
    seg = s.segments[0]
    total = host_footprint(seg)
    per = host_footprint(seg, per_field=True)
    assert total == sum(per.values()) > 0
    assert ("postings", "t") in per and ("ordinal", "k") in per \
        and ("numeric", "n") in per
    # the view's breaker charge derives from the same number, and the
    # host segments are the reference's, byte for byte
    assert seg.device(CPU)._breaker_bytes == total * 2
    jseg = _jax_searcher(n_segs=1).segments[0]
    assert per == jax_host_footprint(jseg, per_field=True)


# -- budget eviction --------------------------------------------------------

def test_budget_eviction_is_byte_identical_via_host_fallback():
    """The reference scores the evicted segments on its host impact
    tables; the port restages them on the device instead: the hits are
    byte-equal to the unbudgeted port's and to the reference's,
    ``restages`` counts both segments and ``host_fallbacks`` stays 0."""
    s = _searcher(n_segs=2)
    led = device_ledger()
    body = {"query": {"match": {"t": "alpha beta"}}, "size": 5}
    r1 = s.search(body)
    assert led.resident_bytes() > 0
    led.set_budget(1)                       # far below the footprint
    st = led.stats()["budget"]
    assert st["evictions"] == 2 and st["evicted_bytes"] > 0
    assert all(not seg._device and str(CPU) in seg._device_evicted
               for seg in s.segments)
    r2 = s.search(body)                     # restaged on the device
    assert _hits(r1) == _hits(r2) == _hits(_jax_searcher(2).search(body))
    st = led.stats()["budget"]
    assert st["restages"] == 2 and st["host_fallbacks"] == 0


def test_budget_eviction_releases_breaker_charge():
    s = _searcher(n_segs=1)
    breaker = breaker_service().fielddata
    gc.collect()              # other tests' views release their charges
    gc.disable()              # ... and none is collected in between
    try:
        used0 = breaker.used
        dseg = s.segments[0].device(CPU)
        charged = dseg._breaker_bytes
        assert charged > 0 and breaker.used == used0 + charged
        device_ledger().set_budget(1)
        # eviction released the charge exactly once (the finalizer on
        # the dead view must not release it again)
        assert breaker.used == used0
        del dseg
        gc.collect()
        assert breaker.used == used0
    finally:
        gc.enable()


def test_eviction_order_is_least_recently_dispatched():
    s = _searcher(n_segs=2)
    led = device_ledger()
    g0 = s.segments[0].device(CPU)._ledger_group
    g1 = s.segments[1].device(CPU)._ledger_group
    led.record_dispatch(g0)
    led.record_dispatch(g1)
    led.record_dispatch(g0)                 # seg0 dispatched most recently
    led.set_budget(led.resident_bytes() - 1)  # must evict exactly one
    assert not s.segments[1]._device        # the LRU-dispatch victim
    assert s.segments[0]._device


def test_restage_counted_when_no_host_fallback_exists():
    s = _searcher(n_segs=1)
    led = device_ledger()
    body = {"query": {"match": {"t": "alpha"}}, "size": 2,
            "aggs": {"m": {"max": {"field": "n"}}}}
    r1 = s.search(body)
    led.set_budget(1)                       # evict; the aggs path restages
    r2 = s.search(body)
    assert json.dumps(r1["aggregations"]) == json.dumps(r2["aggregations"])
    assert _hits(r1) == _hits(r2)
    assert led.stats()["budget"]["restages"] >= 1


def test_msearch_batched_path_survives_budget():
    s = _searcher(n_segs=2)
    bodies = [{"query": {"match": {"t": "alpha"}}, "size": 3},
              {"query": {"match": {"t": "beta"}}, "size": 3}]
    r1 = s.msearch(bodies)
    device_ledger().set_budget(1)
    assert len(s._batch_prep_cache) == 0    # the evicted views' inputs
    r2 = s.msearch(bodies)
    assert [_hits(r) for r in r1] == [_hits(r) for r in r2] == \
        [_hits(r) for r in _jax_searcher(2).msearch(bodies)]
    assert device_ledger().stats()["budget"]["restages"] == 2


def test_transfer_counters_split_stage_and_fetch():
    s = _searcher(n_segs=1)
    led = device_ledger()
    s.search({"query": {"match": {"t": "alpha"}}, "size": 3})
    t = led.stats()["transfers"]
    assert t["stage"]["bytes"] > 0 and t["stage"]["ops"] > 0
    assert t["fetch"]["bytes"] > 0 and t["fetch"]["ops"] == 1
    assert led.transfer_snapshot() == (t["stage"]["bytes"],
                                       t["fetch"]["bytes"])


def test_working_set_stays_resident_within_a_request():
    """Under a budget below one request's working set, the request keeps
    every segment it stages until its launches are queued: nothing is
    evicted inside it, ``stats()`` says the ledger is over budget, and
    the groups go once the request ends."""
    s = _searcher(n_segs=3)
    led = device_ledger()
    body = {"query": {"match": {"t": "alpha gamma"}}, "size": 5}
    want = _hits(s.search(body))
    led.set_budget(1)
    with led.request():
        got = s.search(body)
        st = led.stats()["budget"]
        assert st["evictions"] == 3          # the first views, before
        assert st["over_budget"] and st["pinned_groups"] == 3
        assert all(seg._device for seg in s.segments)
    assert _hits(got) == want
    st = led.stats()["budget"]
    assert st["evictions"] == 6 and not st["over_budget"]
    assert st["restages"] == 3 and st["host_fallbacks"] == 0


def test_sort_key_columns_count_against_the_budget():
    s = _searcher(n_segs=2)
    led = device_ledger()
    body = {"query": {"match_all": {}}, "sort": [{"n": "desc"}], "size": 4}
    resp = s.search(body)
    assert _hits(resp) == _hits(_jax_searcher(2).search(body))
    by_kind = led.stats()["by_kind"]
    assert by_kind["sort_keys"] == sum(seg.n_docs for seg in s.segments) * 8
    s._sort_cache.clear()                    # dropped with its entry
    assert "sort_keys" not in led.stats()["by_kind"]


def test_ann_indexes_are_adopted_and_dropped_with_their_bound():
    mapping = {"properties": {"v": {"type": "knn_vector", "dimension": 2,
                                    "method": {"name": "ivf"}}}}
    mapper = DocumentMapper(mapping)
    seg = SegmentWriter().build([mapper.parse(str(i), {"v": [i, 1.0]})
                                 for i in range(8)], "a0")
    dseg = seg.device(CPU)
    led = device_ledger()
    before = led.device_footprint(seg)
    staged = [dseg.ann_staged(seg.ann_index("v", {"name": "ivf",
                                                  "nlist": n}, CPU))
              for n in (1, 2, 3, 4, 5)]
    kept = sum(st.nbytes() for st in staged[1:])   # the oldest dropped
    assert led.device_footprint(seg) == before + kept
    assert led.device_footprint(seg) == _staged_nbytes(dseg)


# -- compile registry -------------------------------------------------------

def test_compile_registry_counts_query_kernels(monkeypatch):
    """The port counts the hand-kernel libraries ``cuda_build.library``
    loaded, per library (none on the CPU)."""
    monkeypatch.setattr(cuda_build, "_libs", {})
    assert kernel_registry().counts() == {"kernels": {}, "unavailable": 0,
                                          "total": 0}
    monkeypatch.setattr(cuda_build, "_libs", {
        ("bm25", ()): object(), ("bm25", (("X", 1),)): object(),
        ("knn", ()): object()})
    counts = kernel_registry().counts()
    assert counts["kernels"] == {"cuda.bm25": 2, "cuda.knn": 1}
    assert counts["total"] == 3 and counts["unavailable"] == 0


def test_compile_registry_unavailable_fallback():
    """A library table that cannot be read is counted, never raised."""
    def broken():
        raise RuntimeError("moved")

    assert KernelCompileRegistry(libraries=broken).counts() == {
        "kernels": {}, "unavailable": 1, "total": 0}


def test_profiler_xla_compiles_survives_missing_introspection(
        monkeypatch):
    def gone():
        raise RuntimeError("no library table")

    monkeypatch.setattr(
        "opensearch_tpu_torch.common.device_ledger._registry",
        KernelCompileRegistry(libraries=gone))
    assert profile_mod.xla_program_count() == 0
    prof = profile_mod.QueryProfiler()
    section = prof.shard_section("ix", 0, plan_type="T",
                                 description="d", total_segments=0)
    assert section["engine"]["xla_compiles"] == 0


def test_backend_memory_stats_read_only_what_the_device_gives():
    """On the CPU the allocator has nothing to say: ``backend`` is {}."""
    assert device_ledger().stats()["backend"] == {}


# -- the fielddata breaker on a card -----------------------------------------

class _Card:
    total_memory = 80 << 30


def test_default_node_stages_past_the_dev_host_breaker(tmp_path,
                                                       monkeypatch):
    """A node on a card sizes the fielddata breaker's default to it: twice
    the card's memory (a view charges twice its host footprint), so more
    than 4 GB of host footprint stages where the dev-host default (8 GB)
    would refuse it; the parent limit follows."""
    from opensearch_tpu_torch import node as node_mod
    from opensearch_tpu_torch.indices import service as service_mod

    monkeypatch.setattr(breakers, "_default",
                        breakers.CircuitBreakerService())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda _device: _Card())
    for mod in (node_mod, service_mod):      # a node without indices yet
        monkeypatch.setattr(mod, "resolve_device",
                            lambda _device: torch.device("cuda", 0))
    fielddata = breaker_service().fielddata
    assert fielddata.limit == 8 << 30
    node = Node(str(tmp_path), port=0)
    try:
        assert fielddata.limit == 160 << 30
        assert breaker_service().parent.limit == (12 << 30) + (152 << 30)
        footprint = (4 << 30) + (512 << 20)  # 4.5 GB of host arrays
        fielddata.add_estimate(2 * footprint, label="segment staging")
        assert fielddata.used == 2 * footprint
    finally:
        node.stop()


def test_breaker_sizing_keeps_set_limits_and_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda _device: _Card())
    cpu = breakers.CircuitBreakerService()
    cpu.size_for(CPU)
    assert cpu.fielddata.limit == 8 << 30
    fixed = breakers.CircuitBreakerService(
        {"breaker.fielddata.limit": 1 << 30})
    fixed.size_for(torch.device("cuda", 0))
    assert fixed.fielddata.limit == 1 << 30
    assert fixed.parent.limit == 12 << 30
    card = breakers.CircuitBreakerService()
    card.size_for(torch.device("cuda", 0))
    card.size_for(torch.device("cuda", 0))   # once a device
    assert card.fielddata.limit == 160 << 30


# -- eviction frees the view --------------------------------------------------

def test_evicted_view_and_its_tensors_are_collected():
    """After the budget evicts a view, nothing the port keeps (prepared
    and batch inputs, the live snapshots, the ledger, the plan cache)
    holds it or its tensors: the memory is really freed."""
    import weakref

    s = _searcher(n_segs=2)
    body = {"query": {"match": {"t": "alpha beta"}}, "size": 5}
    s.search(body)
    s.msearch([body, {"query": {"match": {"t": "gamma"}}, "size": 5}])
    s.count({"match": {"t": "alpha"}})
    views = [seg._device[str(CPU)] for seg in s.segments]
    refs = [weakref.ref(d) for d in views]
    tensors = [weakref.ref(t) for d in views
               for t in (d.postings["t"]["doc_ids"], d.live)]
    del views
    device_ledger().set_budget(1)
    gc.collect()
    assert all(r() is None for r in refs)
    assert all(r() is None for r in tensors)
    device_ledger().set_budget(0)
    assert _hits(s.search(body)) == _hits(_jax_searcher(2).search(body))


# -- node settings ----------------------------------------------------------

def test_node_settings_set_the_budget_and_the_page(tmp_path):
    node = Node(str(tmp_path), port=0, device="cpu",
                settings={"device.memory.budget_bytes": "2mb",
                          "device.pager.page_bytes": "64kb"})
    try:
        assert device_ledger().budget_bytes == 2 << 20
        assert device_pager().page_bytes == 64 << 10
        assert device_pager().capacity_pages() == 32
    finally:
        node.stop()


# -- tests/test_quantized.py: the pager ---------------------------------------

def _mk_loader(i):
    def loader():
        return [("a", "impacts_q", np.full(32, i, dtype=np.int8)),
                ("b", "postings_q", np.arange(8, dtype=np.int32) + i)]
    return loader


def test_pager_lru_eviction_and_restage():
    led, pager = device_ledger(), device_pager()
    pager.set_page_bytes(256)
    led.set_budget(512)                      # capacity: 2 pages
    assert pager.capacity_pages() == 2
    keys = [("ix", 0, f"s{i}", "body", 0.0) for i in range(3)]
    a1 = pager.acquire(keys[0], _mk_loader(1), device=CPU)
    assert pager.stats()["misses"] == 1
    again = pager.acquire(keys[0], _mk_loader(1), device=CPU)
    assert pager.stats()["hits"] == 1 and again is a1
    pager.acquire(keys[1], _mk_loader(2), device=CPU)
    pager.acquire(keys[2], _mk_loader(3), device=CPU)   # evicts keys[0]
    st = pager.stats()
    assert st["resident_entries"] == 2 and st["evictions"] == 1
    a1b = pager.acquire(keys[0], _mk_loader(1), device=CPU)
    np.testing.assert_array_equal(a1b["a"].numpy(),
                                  np.full(32, 1, dtype=np.int8))
    st = pager.stats()
    assert st["misses"] == 4 and st["evictions"] == 2
    assert st["resident_pages"] <= 2
    assert led.resident_bytes() == st["resident_bytes"]


def test_pager_prefetch_never_evicts():
    led, pager = device_ledger(), device_pager()
    pager.set_page_bytes(256)
    led.set_budget(512)
    keys = [("ix", 0, f"p{i}", "body", 0.0) for i in range(3)]
    pager.acquire(keys[0], _mk_loader(1), device=CPU)
    pager.acquire(keys[1], _mk_loader(2), device=CPU)
    assert pager.prefetch(keys[2], _mk_loader(3), 64, device=CPU) is False
    assert pager.stats()["resident_entries"] == 2
    assert pager.stats()["prefetches"] == 0
    led.set_budget(2048)                     # room opens up
    assert pager.prefetch(keys[2], _mk_loader(3), 64, device=CPU) is True
    assert pager.stats()["prefetches"] == 1
    hits0 = pager.stats()["hits"]
    pager.acquire(keys[2], _mk_loader(3), device=CPU)
    assert pager.stats()["hits"] == hits0 + 1
    assert pager.prefetch(keys[2], _mk_loader(3), 64, device=CPU) is False


def _zipf_corpus(rng, n, vocab=30):
    return [{"body": " ".join(f"w{int(t)}" for t in
                              (rng.zipf(1.3, size=12) - 1).clip(0, vocab))}
            for _ in range(n)]


def _quantized_pair(monkeypatch, docs, sizes, prefix):
    for mod in (jcodec, tcodec):
        monkeypatch.setattr(mod, "QUANTIZED_MODE", "on")
    mapping = {"properties": {"body": {"type": "text"}}}
    mapper, writer = JaxMapper(mapping), JaxWriter()
    jsegs, i = [], 0
    for si, size in enumerate(sizes):
        jsegs.append(writer.build([mapper.parse(str(i + j), d)
                                   for j, d in enumerate(docs[i: i + size])],
                                  f"{prefix}{si}"))
        i += size
    tsegs = [segment_from_arrays(*segment_arrays(s)) for s in jsegs]
    return (JaxSearcher(jsegs, mapper),
            ShardSearcher(tsegs, DocumentMapper(mapping), device="cpu"))


def test_pager_eviction_is_invisible_to_results(monkeypatch):
    """Crush the budget under the quantized working set: the pager evicts
    (and restages) but every score bit is unchanged, and equal to the
    reference's."""
    rng = np.random.default_rng(41)
    jax_s, s = _quantized_pair(monkeypatch, _zipf_corpus(rng, 240),
                               [80, 80, 80], "ev")
    body = {"query": {"match": {"body": "w0 w2"}}, "size": 240}
    ref = _hits(s.search(dict(body)))
    assert device_pager().stats()["resident_entries"] == 3
    device_ledger().set_budget(1)            # evict everything staged
    assert device_pager().stats()["evictions"] == 3
    got = _hits(s.search(dict(body)))
    assert got == ref == _hits(jax_s.search(dict(body)))
    st = device_pager().stats()
    # staged again: one table set prefetched into the one free page, two
    # missed (held by the request past the pager's capacity)
    assert st["prefetches"] + st["misses"] == 6 and st["evictions"] >= 3
    assert device_ledger().stats()["budget"]["host_fallbacks"] == 0


def test_prefetch_oracle_runs_ahead_of_dispatch(monkeypatch):
    """The block-max prefetch oracle stages every segment's quantized
    tables before the launch asks: a cold scored query sees pager hits,
    not misses."""
    rng = np.random.default_rng(53)
    jax_s, s = _quantized_pair(monkeypatch, _zipf_corpus(rng, 210),
                               [70, 70, 70], "po")
    body = {"query": {"match": {"body": "w1"}}, "size": 10}
    assert _hits(s.search(dict(body))) == _hits(jax_s.search(dict(body)))
    st = device_pager().stats()
    assert st["prefetches"] == 3
    assert st["misses"] == 0
    assert st["hits"] >= 3


def test_pager_stats_in_ledger(monkeypatch):
    """The pager's stats in the ledger's (the reference's Prometheus
    gauges wait for the telemetry module)."""
    rng = np.random.default_rng(61)
    _jax_s, s = _quantized_pair(monkeypatch, _zipf_corpus(rng, 90), [90],
                                "st")
    s.search({"query": {"match": {"body": "w0"}}, "size": 5})
    pstats = device_ledger().stats()["pager"]
    for key in ("page_bytes", "capacity_pages", "resident_pages",
                "resident_entries", "resident_bytes", "hits", "misses",
                "evictions", "evicted_pages", "prefetches"):
        assert key in pstats
    assert pstats["resident_entries"] >= 1
    assert device_ledger().stats()["by_kind"]["impacts_q"] > 0


def test_quantized_tables_bounded_per_field_without_budget(monkeypatch):
    """Without a budget the pager has no capacity, so a segment keeps at
    most 8 quantized table sets a field (avgdl moves with every refresh):
    staging a 9th drops the oldest, from the pager and the ledger."""
    rng = np.random.default_rng(67)
    _jax_s, s = _quantized_pair(monkeypatch, _zipf_corpus(rng, 60), [60],
                                "qb")
    seg = s.segments[0]
    dseg = seg.device(CPU)
    pager, led = device_pager(), device_ledger()
    view_bytes = led.resident_bytes()
    avgdls = [8.0 + i for i in range(9)]
    first = dseg.quantized("body", avgdls[0])
    for avgdl in avgdls[1:]:
        dseg.quantized("body", avgdl)
    st = pager.stats()
    assert st["resident_entries"] == 8 and st["misses"] == 9
    assert len(dseg._quant_cache) == 8
    assert all(k[4] != avgdls[0] for k in dseg._quant_cache)
    assert led.resident_bytes() == view_bytes + st["resident_bytes"]
    # the oldest set is staged again on demand, dropping the next oldest
    again = dseg.quantized("body", avgdls[0])
    assert again is not first
    assert again["qvals"].numpy().tobytes() == \
        first["qvals"].numpy().tobytes()
    assert pager.stats()["resident_entries"] == 8
    assert all(k[4] != avgdls[1] for k in dseg._quant_cache)
