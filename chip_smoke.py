"""Drive the PyTorch/CUDA port (``opensearch_tpu_torch``) on one NVIDIA
GPU and check it: the quickest proof that the port starts on the card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. toolkit: torch / CUDA / nvcc versions, the device, its power limit;
   the hand-written kernels are built from ``opensearch_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together);
2. kernels vs their plain PyTorch twins on the card, timed:
   K1's top-k entry ``knn_topk_segments_cuda`` (one launch over many
   segments: 1 segment of 1M, the 16 scale segments, ragged n = 7,
   1,000, 65,536 and 1M in one call and a segment of duplicated rows;
   k in 1, 10, 100, K_MAX, K_MAX + 1; three spaces; with and without a
   filter mask; and widths d = 3, 30, 960 beside the main path's 128;
   the fused launch and the sorted route each taken where
   ``uses_sorted_route`` says, in one call where they mix)
   against ``knn_topk_segments`` within the stated tolerance; K1's
   scores entry ``knn_scores_segments_cuda`` (one launch over a table
   of segments) byte-equal to its plain version
   ``vector_scores_segments`` and launch to launch in all six functions
   (the three spaces, ``dotProduct``, ``l2Squared``,
   ``cosineSimilarity``) at 1M x 128 in one segment, over the 16 scale
   segments in one launch (with their masks, and every row as
   ``script_score`` reads them), at d = 1, 3, 100, 128 and
   ``knn_d_max()`` with n = 1, 31, 513, and on a segment whose base is
   not 16-byte aligned beside one of no rows and one with every row
   invalid, then timed in turns with its plain version per segment
   (beside ``vectors @ q``), over 16 segments in one launch (beside
   ``[v @ q for v in segs]``) and at 1M x 128; K2's and K4's per-slot
   (dense) entry, one launch per call and row layout over a table of
   every segment (``term_bag_dense_kernel``), byte for byte against its
   plain twins in every mode the paths call (scores; scores + counts;
   counts only, as filter bags and ``postings_mask`` call it) on the
   median, the heaviest and the 25-term code-heavy bag, f32 over the 16
   scale segments in one launch and int8 and int16 over the 8 quantized
   ones in one launch, filter-context bags, and 2 f32 with 2 int8
   segments in one call (one launch each layout), then timed at the
   median bag over the 16 f32 and over the 8 int8 segments in turns with
   its plain twin, beside the per-segment kernel it replaced
   (``testing/k2_sweep.py`` ``OldFold``, 16 or 8 launches) and the
   ``index_add_`` chain; the plan top-k (``csrc/plan_topk.cu``, one
   launch over every segment of a request) against its plain version
   (each segment's stable sort) on phase 10's first ``bool`` over the 16
   scale segments and on ties, negative scores, -0.0, no match, fewer
   matches than k, k = n_pad, no live mask and ragged segments, at k =
   10, 100 and 256 (and K_MAX + 1: the sort, counted), then timed over
   the 16 x 65,536 docs in turns with the sort and beside ``torch.topk``
   per segment; and
   K2's top-k entry ``term_bag_topk_segments_cuda`` (one launch over the
   16 scale segments) against ``term_bag_topk_segments``, byte for byte,
   on the median bag, the heaviest bag, a 4-term bag, an ``and`` bag, a
   ``min_score`` bag and segments with deletes, k in 1, 10, 100, K_MAX,
   K_MAX + 1 (the per-slot entry plus the stable sort); and K3
   ``batch_term_bag_topk_cuda`` (``csrc/union_topk.cu``, one launch per
   batch of queries over the 16 scale segments: persistent blocks per
   (query chunk, segment) stage each union posting once in shared memory
   and score every query of the chunk from there) against
   ``batch_term_bag_topk_segments``, byte for byte, on batches of 1, 7
   and 64 zipf OR bags (with and without the presence counts), 64
   ``and`` bags, 64 OR bags over segments with deletes, 64 bags with a
   duplicate term (OR and ``and``), 64 bags with negative weights and 256
   bags of 3-4 terms (several query chunks at K_MAX), k in 1, 10, 100,
   K_MAX, and timed at k = 10 and 100 beside the route it replaced (K2's
   top-k kernel over one table entry per (query, segment),
   ``testing/k3_sweep.py``); and K4, the quantized row layout, on 8
   segments of 125,000 docs that the port quantizes (the same corpus):
   its top-k entry ``term_bag_topk_quantized_cuda`` (its own kernel,
   ``csrc/quant_topk.cu``: each block stages its tile's run of every row
   in shared memory with bulk asynchronous copies and decodes the ids
   there) against ``term_bag_topk_segments``, byte for byte, on the
   median, heaviest, 4-term, ``and``, ``min_score``, deletes, unguarded
   and code-dominated bags and a term some segments lack (blocks with no
   slot), k in 1, 10, 100, K_MAX, K_MAX + 1, int8 and
   int16 codes, bags with and without guarded (exact) terms, and on 4
   segments of 5,000 docs quantized under ``QUANTIZED_MODE = "on"``
   (13-bit deltas against the scale shard's 17); a mixed call
   over 2 quantized and 2 f32 segments; and K4 against K2 over the same
   segments' ``dequantized()`` column staged as f32, byte for byte; and
   K5, the bucket collector of aggregations (``bucket_collect_cuda``,
   ``csrc/aggs.cu``: one call of 2-4 kernels over every segment, or
   every (column, segment), of a collector request, blocks over 4,096-
   entry chunks), against its plain version byte for byte in its
   ordinal, edges and single modes with 0-2 sub-columns (long and
   double), on one scale segment, on multi-valued columns of 1-3 values
   a doc with duplicates in one bucket, and at the chunks' boundaries
   (runs starting at every residue, runs of 2^k - 1 to 2^k + 1 entries
   across chunks, empty chunks, a doc's repeat across a boundary,
   100,000 ordinals, several columns in one single-mode call), two
   calls on the same inputs byte-equal, then timed over the 16 scale
   segments (a day ``date_histogram`` with a ``stats`` sub, ``terms``
   with two subs, the single mode over ``fare``) beside the
   ``index_add_`` / ``scatter_reduce_`` chain or ``v.sum()`` /
   ``v.aminmax()``; the filter masks (``range_mask``,
   ``term_mask``, ``terms_mask``) timed alone on one segment; and K6
   and K7, the IVF / IVF-PQ kernels (``csrc/ivf.cu``:
   ``ivf_search_segments_cuda``, ``ivfpq_search_segments_cuda``: a
   probe, (K7) a table pass and a scan kernel a call over every (query,
   segment)), byte for byte against their plain twins and run to run,
   on two groups of segments a call x 3 queries: indexes trained on the
   card (deletes, rows without the field, clusters of one row, nlist
   271) and indexes laid out by hand (``testing/ann.py`` ``SKEWED``: a
   cluster of c_pad rows over several scan chunks, one holding most of
   a segment, an empty cluster, nlist 1, 3 and 2,000, tied rows
   straddling every multiple of 64, so every chunk boundary), d = 3 and
   100, and two of them at d = 768 (K7 at m = 8, its codebook read from
   device memory, and at m = 128, the largest m), K6 in
   the three spaces and K7 in l2, nprobe 1, nlist // 8 and nlist, k 1,
   10, K_MAX (past the candidates of small probes) and K_MAX + 1 (the
   sorted route, counted), and a ``knn`` on an
   ``ivf`` field through ``ShardSearcher`` over three segments, one
   without the field, equal to the CPU searcher (phase 13 times them);
   and K8 and K9, the phrase and span-near kernels
   (``csrc/positions.cu``: ``phrase_scores_cuda``, ``span_scores_cuda``,
   one launch per request and kernel over every (leaf, segment) job,
   blocks of 1,024 anchor positions staged by bulk copies, BM25 in the
   kernel), scores and matched masks byte for byte against the
   request-wide plain entries (``phrase_scores``, ``span_scores``) and
   launch to launch, one launch a call, on the CPU test's sets
   (``testing/positions.py``, each set's cases in one call, scored and
   not: among them a 12-slot phrase and a doc of 6,000 positions of the
   anchor) and over the 16 scale segments ("t0 t0", the heaviest, with
   t0's position count printed; "t0 t0 t0"; 2-, 3- and 5-term phrases of
   ``phrase_query_log``; a phrase with a term some segments lack;
   ordered, unordered and ``end`` spans; then every phrase case, and
   every span case, in one call), then each timed at its heaviest case
   over one scale segment and over the 16 in one launch, in turns with
   its plain version (CUDA events and profiler device ms) beside its
   bound; and K10, the mesh's cross-shard merge (``csrc/mesh_merge.cu``,
   ``mesh_merge_cuda``: every entry of the [R, k] sorted lists finds its
   rank by binary searches of the other rows and writes itself there),
   byte for byte against ``mesh_merge_plain`` (a stable sort) on random
   rows with ties and -inf padding at 4 and 8 rows, k = 10 and 1,000,
   and at phase 19's 16 x 10, then timed there beside ``torch.topk``.
   The scale corpus carries doc-value columns (``testing/corpus.py``
   ``doc_value_columns``: ``price`` long, ``ts`` date, ``tag`` keyword
   with postings and ordinals, ``fare`` double) in both layouts, for
   phases 10 and 11;
3. ingest path: ~2,000 JSON docs through the port's DocumentMapper and
   SegmentWriter into 2 segments with deletes, then match / bool / knn
   (three spaces, filtered, and one k above K1's in-kernel maximum)
   searches and counts through ``ShardSearcher`` on the card, held to
   the same searcher on the CPU (the plain versions): BM25 byte for
   byte, k-NN within tolerance; the filtered ``knn`` and the
   ``track_total_hits: false`` ``match`` make one dense launch each over
   both segments;
4. scale: 1,000,000 docs in 16 segments (62,500 docs each, under the
   reference's quantization threshold) with ~22M postings and a 128-d
   float32 vector per doc; 200 zipf ``match`` and 100 ``knn`` queries
   through ``ShardSearcher.search`` (qps, p50, kernel launches per
   query: one K2 top-k launch per ``match`` query and no per-slot one,
   one K1 and one plan top-k launch per ``knn`` query), a sample checked
   against the CPU searcher;
5. msearch: the 256 queries of ``zipf_query_log(256, seed=7)`` through
   ``ShardSearcher.msearch`` in 4 batches of 64 (one K3 launch and no K2
   launch per batch, every response equal to sequential ``search``,
   batched qps at least 0.8 x sequential qps);
6. continuous batching: the same queries from 16 client threads through
   ``query_engine().execute(..., service=shim)`` with a 4 ms window
   (fewer than one dispatch per query, every response equal to
   sequential ``search``; qps, p50 and p99), then once more with the
   batcher off (each thread's searches one after another) for its qps,
   p50 and p99;
7. quantized scale: the same 1,000,000 docs in 8 segments of 125,000
   (every one at or above ``QUANTIZED_MIN_DOCS``, so quantized as the
   reference quantizes them; the time the quantization takes is
   logged); the 200 zipf ``match`` queries of phase 4 through
   ``ShardSearcher.search`` (qps, p50, launches per query: one K4 top-k
   launch and no per-slot one per ``match``), a ``bool`` /
   ``constant_score`` / ``count`` sample (K4's per-slot entry, K2's on
   the demand-staged f32 columns for filters), a sample byte-equal to
   the CPU searcher, and the resident bytes against the f32 layout of
   the same segments;
8. write path: 160,000 docs of the same corpus shape as text
   (``testing/corpus.render_texts``) indexed through the port's
   ``InternalEngine(..., device="cuda")`` (a ``body`` text field and a
   ``tag`` keyword) in bulks of 1,000 with one ``ensure_synced()`` each
   (the reference's ``request`` durability), ~1% updates and ~0.5%
   deletes, one stale ``if_seq_no`` write refused before each of the 10
   refreshes (one every 16,000 docs); after each refresh 20 zipf
   ``match`` queries and a ``bool`` with a ``term`` filter byte-equal
   to the CPU searcher over the same segments; every updated and
   deleted id and a 2,000-id sample read back by realtime ``get``;
   ``count`` equal to the acked live docs; the 200 ``match`` queries
   on the 10 f32 segments (one K2 top-k launch each) and one
   ``msearch`` batch of 64 (one K3 launch); ``force_merge(2)`` into two
   quantized segments, after which the device holds no byte of the
   merged-away ones; the 200 queries again (one K4 top-k launch each);
   ``flush``, ``close`` and a reopen whose first ``match`` builds and
   writes the ``.quant`` sidecars, and a second reopen whose first
   ``match`` quantizes nothing; then 1,000 more docs, the engine
   dropped without ``close`` and reopened: the translog replay brings
   them back (gets, counts and searches equal to the CPU searcher) and
   moves the avgdl under the quantized segments.  One ``write path:``
   line prints the rates and times;
9. serving node: ``opensearch_tpu_torch.node.Node(..., device="cuda")``
   driven over HTTP only: ``GET /`` and ``/_cluster/health``; an index
   ``corpus`` of 2 shards (phase 8's mapping) fed 20,000 rendered docs
   by 20 ``_bulk`` requests of 1,000 items with ~1% ``update`` and ~0.5%
   ``delete`` items and one refused ``create`` of an existing id (one
   translog sync per item), a ``_refresh`` every 5,000 docs; a sample
   of acked ids read back by ``GET _doc``; ``_count`` equal to the acked
   live docs; the 200 ``match`` queries as ``_search`` requests one at a
   time (one K2 top-k launch over both shards' segments and no other
   each, equal to the CPU searcher; qps, p50, p99, and beside them the
   p50 of the same bodies through ``IndexService.search`` and through
   the REST controller in process, and of a keep-alive ``GET /``); one
   ``_msearch`` of 64 (one K3 launch, equal to sequential); the 256
   queries from 16 client threads, in this process and then in a child
   process (the continuous batcher behind the real ``IndexService``:
   fewer than one dispatch per query, equal to sequential); an index
   ``vectors`` of 5,000 128-d vectors by ``_bulk`` and 50 ``knn``
   searches (one K1 launch each, within
   tolerance of the CPU); a multi-index ``match_all``; ``aggs`` on
   ``corpus`` and across ``corpus,vectors`` equal to the CPU searcher,
   and a missing index 404; ``_forcemerge``, ``_flush``, ``DELETE
   /vectors`` (the device bytes it held released); then a restart on the
   same data path (the index reloaded, ``vectors`` gone, ``_count`` and
   20 responses unchanged, the acked docs read back).  One ``serving:``
   line prints the rates and times;
10. filters and hybrid: on phase 4's 16 f32 segments and phase 7's 8
   quantized ones (the ``price``, ``ts`` and ``tag`` columns staged
   beside the postings), 200 ``bool`` queries on each layout (phase 4's
   ``match`` pair, filtered by a ``price`` range over ~40% of the docs
   and a ``tag`` term: one dense launch per term-bag leaf and row layout,
   two per request, and one plan top-k launch); 50 ``_count`` of a
   5-value ``terms`` on ``tag``, a month's ``range`` on ``ts`` and
   ``exists`` (one counts-only dense launch per request); 50 ``ids``
   queries of 10 ids (one plan top-k each); 100 ``hybrid`` queries of
   [the ``match`` pair, ``knn`` k = 10] through the pipeline {min_max,
   arithmetic_mean, weights [0.3, 0.7]} (one K2 top-k, one K1 and one
   plan top-k launch each); and 20 more hybrids over HTTP on phase 9's
   node, run at the
   end of phase 9 before the node stops: its ``corpus`` index (20,000
   docs in 2 shards) gains a ``vec`` field by ``PUT _mapping`` and phase
   9's 5,000 vectors by ``_bulk`` ``update`` of its first 5,000 live
   docs, then ``PUT /_search/pipeline/p`` and the hybrids by
   ``?search_pipeline=p`` (every one held to the CPU searcher; the
   counts zeroed just before them and read just after).  A sample of each kind
   equals the CPU searcher (BM25 and constant scores byte for byte;
   hybrids' ids equal, scores within rtol 1e-5 / atol 1e-6).  One
   ``filters and hybrid:`` line prints qps, p50 and launches per query
   for each kind, the resident bytes of the new columns and the phase's
   seconds;
11. aggregations, on phase 4's 16 f32 segments and phase 7's 8 quantized
   ones (``price``, ``ts``, ``tag`` and the ``fare`` double), shaped on
   nyc_taxis' ``date_histogram_agg`` / ``distance_amount_agg`` and
   config 5: per layout 50 ``date_histogram`` (day) on ``ts`` with a
   ``stats`` sub on ``fare`` (25 under a 21-day ``range``, 25 over every
   doc), 50 ``histogram`` on ``price`` under a ``range`` filter, 50
   ``match`` pairs with ``size`` 10 and ``terms`` on ``tag`` with ``avg``
   / ``max`` subs, 20 ``match_all`` with 12 metric aggs, and one each of
   ``range``, ``filters``, ``missing``, ``cardinality``, ``percentiles``
   (the centroid path), ``terms`` on a long, ``composite`` with an
   ``after``, ``top_hits`` under ``terms``, ``cumulative_sum`` and
   ``max_bucket``; K5's calls per request checked against each kind's
   bucket aggs and its metric aggs (one call for all of a request's
   top-level metric aggs), its kernels per request recorded, one plan
   top-k per request with hits and none with ``size`` 0, no K3
   launch, samples equal to the CPU
   searcher byte for byte (JSON), and where a request's time goes
   (``run_full``, K5 and its copy, the host aggregation); plus 20
   ``terms`` + ``value_count`` ``_search`` requests over HTTP to phase
   9's node before it stops (``?request_cache=false``; two K5 calls
   each), equal to the CPU searcher.  One ``aggregations:`` line prints
   qps and p50 per kind and the layer times;
12. script_score, on phase 4's 16 f32 segments (SIFT-1M's shape: 1M
   128-d float32 vectors, random from the seed; ``price`` and ``tag``):
   BASELINE config 2's traffic, the k-NN plugin's ``knn_score`` script:
   100 l2 over ``match_all``, 20 cosinesimil, 20 innerproduct, 20 l2
   under a ``bool`` filter child (a ``price`` range over ~40% and a
   common ``tag``), 20 general sources (``cosineSimilarity(...) +
   1.0``, ``_score * dotProduct(...)`` over a ``match`` child,
   ``Math.log(doc['price'].value + ...)``), 10 l2 with ``min_score``;
   exactly one K1 scores launch per request and distinct vector function
   (never one per segment), one plan top-k launch per request and no K1
   top-k launch; answers equal to the
   CPU searcher's (byte for byte, but ids equal and scores within rtol
   1e-5 / atol 1e-6 where the script calls ``Math.log``) for every
   kind's first 10 requests and every filtered and ``min_score`` one,
   70 of 190 (cut for time: a CPU answer scores all 1M rows, and the
   line says so); every l2 top-10's ids equal to a ``knn`` query's; where a ``knn_score`` request's
   time goes (compile with the K1 pre-pass, the per-segment plan path,
   the host merge and response); plus 10 ``script_score`` ``_search``
   requests over HTTP to phase 9's ``corpus`` index before it stops
   (20,000 docs in 2 shards, 5,000 with a ``vec`` since phase 10's
   hybrids; one K1 scores launch per request and vector function, each
   held to the CPU searcher).  One ``script_score:`` line
   prints qps and p50 per kind and the layer times;
13. ANN at GloVe-100's shape (BASELINE config 3: ``ivf_pq``, cosine):
   1,183,514 clustered 100-d vectors (``testing/corpus.py``
   ``clustered_vectors``, 4,096 centres; GloVe-100 itself is not in the
   repository) in 16 segments of ~73,970 (default nlist 271, nprobe
   33), with ``price``, ``ts`` and ``tag`` columns; ``vec`` mapped as
   ``ivf_pq`` (m = 10) in the cosine space (which probes the flat
   layout: K6) and, by a second mapper over the same segments, in l2
   (the ADC route: K7).  Every segment's indexes are trained on the card
   first (seconds per segment printed; two trainings of one segment
   byte-equal) and staged (bytes beside the reference's padded
   ``[nlist, c_pad, d]``).  Traffic, k = 10: 100 cosine queries at the
   default nprobe, 50 at ``method_parameters.nprobe`` 8, 50 at nprobe =
   nlist (ids equal to exact K1's), 100 l2 ``ivf_pq`` queries and 20
   with a ``price`` filter (the exact route: one K1 launch each); qps,
   p50, K6 / K7 / K1 launches a query (1 / 0 / 0, 0 / 1 / 0, 0 / 0 / 1
   checked), recall@10 against exact K1 on the card, and a sample of
   each kind equal to the CPU searcher over the same segments (which
   reuses the card-trained indexes).  K6 and K7 are then timed at this
   shape in turns with their plain twins (device ms of each kernel:
   probe, K7's table pass, scan), beside ``torch.topk`` over ``flat_v @
   q`` of the probed rows and exact K1 over the same segments.  Phase 9 also feeds an index ``ann`` (5,000 clustered
   100-d vectors, ``ivf``, cosine) by ``_bulk`` and sends it 10 ``knn``
   ``_search`` requests over HTTP (one K6 launch each), held to the CPU
   searcher;
14. phrase and proximity, on phase 4's 16 f32 segments (positions staged
   on the first phrase, their bytes and seconds printed): 100
   ``match_phrase`` of 2-3 tokens of ``phrase_query_log`` (each occurs
   in the corpus), 20 anchored on t0 (runs starting with t0, "t0 t0",
   "t0 t0 t0"), 20 ``match_phrase_prefix``, 20 ``multi_match``
   ``phrase`` over ``body^2`` and ``tag``, 20 ordered ``span_near`` (2-3
   clauses, slop 0-3), 20 unordered, 10 ``span_first``, 10 ordered
   ``intervals`` and 20 ``bool`` of a ``match_phrase`` and a ``price``
   range: qps, p50, p99 and K8 / K9 launches a request by kind; 4 of
   each kind byte-equal to the CPU searcher; 20 phrase bodies on phase
   7's 8 int8 segments equal to the f32 layout's.  Phase 9 also sends
   its ``corpus`` 10 phrase requests over HTTP (6 ``match_phrase``
   bodies, 2 quoted and 2 bare URI ``q``), held to the CPU searcher;
15. the search request's result features, on phase 4's 16 f32 segments
   (``price``, ``ts``, ``fare`` and ``tag``, whose dictionary differs
   from segment to segment; ordered on the card by
   ``search/sorting.py``): 20 ``match_all`` sorted by ``ts`` desc (pages
   by ``from``), 20 ``match`` pairs sorted by [``fare`` asc,
   ``_score``], 20 ``bool`` of a ``match`` pair and a ``price`` range
   sorted by [``tag`` asc, ``price`` desc], 10 ``match`` pairs collapsed
   on ``tag``, 10 rescored by a ``match_phrase`` over a window of 100,
   10 with ``highlight``, ``explain`` and ``docvalue_fields``: p50 host
   ms and the bytes read back a request by kind (under 1 MB for a
   sorted page, checked), three ``search_after`` pages equal to one deep
   page, 2 of each kind and the pages byte-equal to the CPU searcher
   over the same segments (its ms beside), and the host split of two
   sorted requests (compile, ``run_full``, key build, sorts, read-back,
   fetch).  Phase 9 also feeds an index ``corpus_b`` and sends 7 sorted,
   collapsed, rescored and fetched requests over HTTP, two of them
   across ``corpus,corpus_b``, held to the CPU searchers;
16. the relevance-shaping, multi-term and geo queries, on phase 4's 16
   f32 segments with a ``pickup`` geo_point (the nyc_taxis workload's
   pickup box, clustered around Midtown) and a ``min_terms`` long
   (``testing/corpus.py`` ``relevance_columns``): 10 requests of each of
   22 kinds (``phase16_bodies``: ``wildcard`` ``t12*``-like, ``t1*``-like
   and case-insensitive, ``regexp``, ``fuzzy`` at distances 1 and 2,
   ``match`` and ``match_bool_prefix`` with ``fuzziness``, ``boosting``,
   ``terms_set``, ``distance_feature`` on ``ts`` and ``pickup``,
   ``rank_feature`` on ``fare``, ``more_like_this``, ``geo_distance`` at
   2 and 20 km, ``geo_bounding_box``, an 8-vertex ``geo_polygon``,
   ``exists`` on ``pickup``, and ``function_score`` in three forms, one
   with a ``script_score`` function that launches K1's scores entry):
   p50 host ms and the launches a request by route and kind (K1 scores,
   the dense entry, the plan top-k), the dictionary expansion of
   ``t12*`` and ``t1*`` timed apart, device ms, kernels and idle share a
   request under the profiler, one of each kind held to the CPU
   searcher (byte for byte; 2 float32 ulps on the kinds whose scores go
   through transcendental functions).  Phase 9 also sends ``corpus``
   five such bodies and ``?q=body:t12*`` over HTTP, held to the CPU
   searcher;
17. the relationship queries and the reader contexts: 1,000,000
   questions (OpenSearch Benchmark's ``nested`` workload's shape: a
   ``tag``, a ``created`` date, 0-6 ``answers`` of a zipf ``user`` and a
   later ``date``; ``testing/corpus.py`` ``qa_draws``) as nested objects
   and as the parent and child docs of a ``join`` field (each answer
   also a ``body`` of 5-15 tokens), 16 segments each, and a percolator
   index of 2,000 stored ``body`` queries: 10 ``nested`` in the
   ``randomized-nested-queries`` shape, 10 inside a ``bool`` with a
   ``tag`` filter, 10 ``has_child`` (each ``score_mode``, one with
   ``min_children``), 10 ``has_parent`` with ``score``, 10
   ``parent_id``, 5 ``percolate`` of one document and 5 of five, 5 term
   and 5 phrase ``suggest``, 10 ``completion`` prefixes on a small
   index, and one body with each key the searcher ignores: p50 host ms
   and the launches a request by route (the dense entry, the plan
   top-k), the joins' inner pre-pass and percolate's ms per stored
   query apart, device ms and kernels a request under the profiler;
   then on phase 4's 16 segments a ``match_all`` scroll of 25 pages of
   1,000 (first page apart), a sliced scroll (``max: 4``, the slices'
   rows every row once), a scroll sorted on ``ts`` and a point in time
   with three ``search_after`` pages and a delete after it opens; one
   of each kind and every scroll and PIT page held to the CPU searcher
   byte for byte, and the ``nested`` and ``has_child`` question sets of
   one bool held equal; ``knn_topk_batch`` (64 queries over 65,536 x
   128) against K1's top-k entry one query at a time.  Phase 9 also
   indexes ``qa_nested``, ``qa_join`` and ``qa_perc`` and, over HTTP,
   reads two scroll pages and clears the scroll, searches a point in
   time and closes it, and sends a ``nested``, a ``has_child``, a
   ``percolate`` and a ``suggest`` body: each answer equals a CPU
   node's, the ids masked;
18. profile and residency (``phase_profile_residency``): 50 each of
   ``match``, phase 10's ``bool`` and ``knn`` (k = 10) on phase 4's 16
   segments and 4 ``msearch`` batches of 64, each profiled and
   unprofiled in turns: hits byte-equal, the phases within ``took`` + 1
   ms, the segment decisions summing to 16, no kernel library built
   once warm; p50 of both by kind; 128 profiled searches from 16
   clients through the continuous batcher (each member's ``queue``);
   the residency ledger's ``stats()`` by kind; ``resident_bytes()``
   against the change in ``torch.cuda.memory_allocated()`` over
   restaging the 16 segments, and evicting them again after requests
   frees at least what the ledger evicted and leaves the allocator where
   the first eviction left it; 50 ``match`` under a device budget that
   holds half of them, and 50 on phase 7's 8 int8 segments with their
   pages held to 1/4 of their quantized tables, each byte-equal to the
   unbudgeted answers (evictions, restages and ms a restage, pager hits,
   misses and prefetches; no host fallback); the device ms of
   ``train_kmeans`` and ``knn_topk_batch``;
19. the mesh (``phase_mesh``): the 16 scale segments regrouped into 4
   shards of 4 on a mesh of ``[cuda:0] * 4`` (``MeshSearcher``; one card
   stands in for four): 20 each of ``match`` (the median bag first),
   phase 10's ``bool``, ``knn`` k = 10, a ``price`` ``range`` and a
   ``size: 0`` ``stats`` on ``fare``, through the mesh, the host scatter
   on the card and the node-local searcher (p50 host ms of each); every
   mesh answer byte-equal to the host scatter's (double sums within
   rtol 1e-12), 2 of each kind to the same mesh on the CPU; launches a
   request (4 K2 top-k or plan top-k, 1 K10; 4 K5 calls for ``stats``);
   K10's device ms on a ``match``'s own lists; and a 4-shard
   ``search.mesh`` index on this one-card node, whose ``_mesh_search``
   demotes to the host scatter, counted.  The script's total seconds
   print before the kernels line.

Every phase runs under the port's own fielddata breaker, whose default
sizes itself to the card on the first staging (twice the card's memory:
a staged segment charges twice its host footprint), as a node's does.
Every kernel wrapper counts
its launches; the counts are zeroed just
before phase 3 and read after phase 4, and zeroed again just before
phases 5, 6, 7, 8, 9, phase 10's hybrids and phase 11's requests over
HTTP, phase 10, phase 11, phase 12's requests over HTTP, phase 12, phase
9's ANN requests and phase 13 and read after each; K8 / K9's before
phase 9's phrase requests and each kind of phase 14; all of them before
phase 9's sorted requests and before phase 15 (whose dense entry, K2
top-k and K8 launches must be more than 0), and before phase 9's
relevance requests and phase 16 (whose K1 scores, dense entry and plan
top-k launches must be more than 0), before phase 9's relations
requests and phase 17's requests (whose dense entry and plan top-k
launches must be more than 0), before phase 18 (whose K2 top-k, plan
top-k, K1, K3 and K4 launches must be more than 0), and before phase
19's mesh requests (whose K2 top-k, plan top-k, K1, K5 and K10 launches
must be more than 0): each kernel of each path must have run.
The line before the last is one JSON object with each kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.  Without CUDA the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
FP64_FLOPS_PER_S = 34e12         # ... fp64 outside the tensor cores (K1 sums)
SCALE_DOCS = 1_000_000
BIG_N = 1_000_000                # the single large segment of phase 2
SCALE_SEGMENTS = 16
QUANT_SEGMENTS = 8               # phase 7: 8 x 125,000 docs, all quantized
DIM = 128
DEVICE = "cuda"


def log(*a):
    print(*a, flush=True)


def gpu_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per ``fn()`` on the card: CUDA events around
    ``reps`` calls after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(kernel, plain, reps: int) -> tuple:
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain in one
    call; each is the lower of its two readings."""
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return min(k1, k2), min(p1, p2)


def bound_ms(nbytes: float, flops: float,
             peak: float = FP32_FLOPS_PER_S) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_device_ms(fn, reps: int, name: str, attempts: int = 3):
    """Mean device milliseconds per launch of the kernels whose name
    holds ``name``, over ``reps`` calls of ``fn`` under
    ``torch.profiler``.  The profiler at times drops a window's device
    events: the first of ``attempts`` windows that shows such a kernel
    counts; None when none does."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from opensearch_tpu_torch.testing.profile_scale import (_device_self_us,
                                                            _is_device)
    fn()
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if _is_device(e) and name in e.key]
        count = sum(e.count for e in hits)
        if count:
            return sum(_device_self_us(e) for e in hits) / 1e3 / count
    return None


# -- phase 1 ----------------------------------------------------------------

def phase_toolkit():
    import torch

    from opensearch_tpu_torch.ops import (cuda_aggs, cuda_bm25, cuda_build,
                                          cuda_ivf, cuda_knn, cuda_plan,
                                          cuda_positions)

    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    log(f"toolkit: python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} nvcc "
        f"[{nvcc.stdout.strip().splitlines()[-1]}]")
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"count={torch.cuda.device_count()}")
    log(f"gpu: {gpu_name_power()}")
    t0 = time.monotonic()
    logs = cuda_build.build(["knn", "bm25", "union_topk", "quant_topk",
                             "aggs", "plan_topk", "ivf", "positions",
                             "mesh_merge"],
                            {"knn": cuda_knn.defines(),
                             "ivf": cuda_ivf.defines(),
                             "bm25": cuda_bm25.defines(),
                             "quant_topk": cuda_bm25.quant_defines(),
                             "aggs": cuda_aggs.defines(),
                             "plan_topk": cuda_plan.defines(),
                             "positions": cuda_positions.defines()})
    log(f"kernels built in {time.monotonic() - t0:.1f}s: "
        f"{sorted(logs) or 'cached'}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or \
                    "entry function" in line:
                log(f"  ptxas {name}: {line.strip()}")


# -- phase 2 ----------------------------------------------------------------

def phase_knn_topk(scale_segs, dev, gen):
    """K1's top-k entry against its plain twin at every shape, k, space
    and mask the contract lists, then timed over the 16 scale segments
    in one launch (k = 10, l2) beside the plain twin, the library chain
    ``[torch.topk(v @ q, k) for each segment]`` and the bound."""
    import torch

    from opensearch_tpu_torch.ops import cuda_knn, knn
    from opensearch_tpu_torch.testing.parity import topk_mismatch

    def rand_segment(n, dup=False, d=DIM):
        v = torch.randn(n, d, device=dev, generator=gen)
        if dup:      # 64 distinct rows, each repeated: ties everywhere
            v = v[:64][torch.randint(0, 64, (n,), device=dev,
                                     generator=gen)].contiguous()
        flags = [torch.rand(n, device=dev, generator=gen) > p
                 for p in (0.05, 0.05, 0.5)]
        return v, *flags

    scale = []
    for seg in scale_segs:
        dseg = seg.device(dev)
        vcol = dseg.vector["vec"]
        scale.append((vcol["values"], vcol["exists"], dseg.live,
                      torch.rand(dseg.n_pad, device=dev,
                                 generator=gen) > 0.5))
    big = rand_segment(BIG_N)
    sets = {f"n={BIG_N}": [big], "scale16": scale,
            f"ragged 7/1000/65536/{BIG_N}": [rand_segment(n) for n in
                                             (7, 1000, 65_536)] + [big],
            "duplicated rows": [rand_segment(65_536, dup=True)]}
    q = torch.randn(DIM, device=dev, generator=gen)
    ks = (1, 10, 100, cuda_knn.K_MAX, cuda_knn.K_MAX + 1)
    max_err = 0.0
    for name, raw in sets.items():
        for filtered in (False, True):
            segs = [knn.KnnSegment(v, e, lv, m if filtered else None)
                    for v, e, lv, m in raw]
            for space in knn.SPACES:
                for k in ks:
                    fn = cuda_knn.knn_topk_segments_cuda
                    sc = cuda_knn.knn_scores_segments_cuda
                    before = (fn.launches, fn.sorted_route_segments,
                              sc.launches)
                    got = fn(segs, q, space=space, k=k)
                    ref = knn.knn_topk_segments(segs, q, space=space, k=k)
                    routes = [cuda_knn.uses_sorted_route(k, s.vectors.shape[0])
                              for s in segs]
                    moved = (fn.launches - before[0],
                             fn.sorted_route_segments - before[1],
                             sc.launches - before[2])
                    if moved != (int(not all(routes)), sum(routes),
                                 int(any(routes))):
                        raise AssertionError(
                            f"K1 top-k {name} k={k}: routes {routes} gave "
                            f"{moved[0]} fused launches, {moved[1]} sorted "
                            f"segments and {moved[2]} scores launches")
                    bad, err = topk_mismatch(
                        *(t.cpu().numpy() for t in got + ref))
                    if bad is None and name == "duplicated rows" and \
                            got[1].cpu().numpy().tobytes() != \
                            ref[1].cpu().numpy().tobytes():
                        bad = "ids are not byte-equal"
                    if bad:
                        raise AssertionError(
                            f"K1 top-k {name} filtered={filtered} {space} "
                            f"k={k}: {bad}")
                    max_err = max(max_err, err)
            ties = "; ids byte-equal" if name.startswith("dup") else ""
            sorted_k = [k for k in ks if any(
                cuda_knn.uses_sorted_route(k, s.vectors.shape[0])
                for s in segs)]
            log(f"K1 top-k {name} filtered={filtered}: 3 spaces x k "
                f"{list(ks)} agree with the plain twin (rtol=1e-5, "
                f"atol=1e-6{ties}); sorted route taken by some segment at "
                f"k {sorted_k}")
    del sets
    # other widths: scalar loads and 4-byte copies (d % 4 != 0), one lane
    # per row (d = 3), a whole warp per row (d = 960)
    for d in (3, 30, 960):
        segs = [knn.KnnSegment(*rand_segment(n, d=d))
                for n in (5000, 70_000)]
        qd = torch.randn(d, device=dev, generator=gen)
        for space in knn.SPACES:
            for k in (10, cuda_knn.K_MAX):
                bad, err = topk_mismatch(*(t.cpu().numpy() for t in (
                    cuda_knn.knn_topk_segments_cuda(segs, qd, space=space,
                                                    k=k)
                    + knn.knn_topk_segments(segs, qd, space=space, k=k))))
                if bad:
                    raise AssertionError(f"K1 top-k d={d} {space} k={k}: "
                                         f"{bad}")
                max_err = max(max_err, err)
        log(f"K1 top-k d={d} (filtered, n = 5000 and 70,000): 3 spaces x k "
            f"[10, {cuda_knn.K_MAX}] agree with the plain twin")

    segs = [knn.KnnSegment(v, e, lv) for v, e, lv, _m in scale]
    k = 10
    ms, plain_ms = in_turns(
        lambda: cuda_knn.knn_topk_segments_cuda(segs, q, space="l2", k=k),
        lambda: knn.knn_topk_segments(segs, q, space="l2", k=k), 20)
    lib_ms = cuda_ms(lambda: [torch.topk(s.vectors @ q, k) for s in segs],
                     20)
    dev_ms = kernel_device_ms(
        lambda: cuda_knn.knn_topk_segments_cuda(segs, q, space="l2", k=k),
        20, "knn_topk_kernel")
    rows = sum(s.vectors.shape[0] for s in segs)
    nbytes = rows * (DIM * 4 + 2) + DIM * 4 + len(segs) * k * 8
    bms, by = bound_ms(nbytes, 4.0 * rows * DIM, FP64_FLOPS_PER_S)
    log(f"K1 top-k l2 k={k} over {len(segs)} segments of "
        f"{segs[0].vectors.shape[0]}x{DIM}, one launch per query: ms {ms:.4f} "
        f"device_ms {dev_ms} plain_ms {plain_ms:.4f} library_ms"
        f"(topk(v @ q) chain) {lib_ms:.4f} bound_ms {bms:.4f} ({by}: "
        f"{nbytes} bytes) on "
        f"{gpu_name_power()}")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
            "bound_bytes": nbytes, "max_abs_err": max_err,
            "shape": f"{len(segs)}x{segs[0].vectors.shape[0]}x{DIM}, k={k}"}


def phase_knn_scores(scale_segs, dev, gen) -> dict:
    """K1's scores entry (one launch over a table of segments) byte-equal
    to its plain version and launch to launch: all six functions at 1M x
    128 in one segment and over the 16 scale segments in one launch;
    d = 1, 3, 100, 128 and ``knn_d_max()`` at n = 1, 31 and 513 in one
    table; a segment whose base is not 16-byte aligned (the 4-byte
    loads), a segment of no rows and one with every row invalid; 40
    segments in one table; ``knn_scores_cuda`` (a
    table of one) in the three spaces at 1M x 128.  Then
    timed in turns with its plain version: per segment (65,536 x 128)
    beside ``vectors @ q``, over the 16 segments in one launch beside
    ``[v @ q for v in segs]``, and at 1M x 128; device ms from the
    profiler, the bound from ``bound_ms``.  The timed function is
    ``l2Squared`` over every row, as ``script_score``'s ``knn_score``
    (l2) asks for it."""
    import torch

    from opensearch_tpu_torch.ops import cuda_knn, knn

    lib = cuda_knn._library()
    for d in (1, 2, 3, 4, 8, 100, 128, 129, 960, lib.d_max):
        if lib.knn_row_lanes(d) != knn.row_lanes(d):
            raise AssertionError(f"K1 lanes at d={d}: kernel "
                                 f"{lib.knn_row_lanes(d)}, plain "
                                 f"{knn.row_lanes(d)}")

    def bits(t):
        return t.contiguous().view(torch.int32)

    counter = cuda_knn.knn_scores_segments_cuda
    cases = 0

    def check(name, segs, q, fns=knn.FUNCTIONS):
        nonlocal cases
        for fn in fns:
            before = counter.launches
            a = cuda_knn.knn_scores_segments_cuda(segs, q, fn=fn)
            b = cuda_knn.knn_scores_segments_cuda(segs, q, fn=fn)
            if counter.launches - before != 2:
                raise AssertionError(f"K1 scores {name} {fn}: "
                                     f"{counter.launches - before} launches "
                                     "for 2 calls")
            ref = knn.vector_scores_segments(segs, q, fn=fn)
            torch.cuda.synchronize()
            for i, (x, y, r) in enumerate(zip(a, b, ref)):
                if not torch.equal(bits(x), bits(y)):
                    raise AssertionError(f"K1 scores {name} {fn} segment "
                                         f"{i}: launches differ")
                if not torch.equal(bits(x), bits(r)):
                    bad = (bits(x) != bits(r)).nonzero()[:3].flatten()
                    raise AssertionError(
                        f"K1 scores {name} {fn} segment {i}: not byte-equal "
                        f"to the plain version at rows {bad.tolist()}: "
                        f"{x[bad].tolist()} vs {r[bad].tolist()}")
            cases += 1

    def rand(n, d=DIM):
        return torch.randn(n, d, device=dev, generator=gen)

    def flags(n, p=0.05):
        return torch.rand(n, device=dev, generator=gen) > p

    big = rand(BIG_N)
    big_valid = flags(BIG_N)
    q_big = torch.randn(DIM, device=dev, generator=gen)
    check(f"1 x {BIG_N}x{DIM}", [knn.KnnSegment(big, big_valid)], q_big)
    for space in knn.SPACES:           # the one-segment wrapper's contract
        if not torch.equal(bits(cuda_knn.knn_scores_cuda(
                big, big_valid, q_big, space=space)),
                bits(cuda_knn.knn_scores_plain(big, big_valid, q_big,
                                               space=space))):
            raise AssertionError(f"knn_scores_cuda {space}: not byte-equal")
    scale = []
    for seg in scale_segs:
        dseg = seg.device(dev)
        vcol = dseg.vector["vec"]
        scale.append((vcol["values"], vcol["exists"], dseg.live))
    q = torch.from_numpy(np.random.default_rng(5).standard_normal(
        DIM, dtype=np.float32)).to(dev)
    check(f"{len(scale)} scale segments, exists & live",
          [knn.KnnSegment(v, e, lv) for v, e, lv in scale], q)
    check(f"{len(scale)} scale segments, every row (script_score)",
          [knn.KnnSegment(v, None) for v, _e, _lv in scale], q)
    for d in (1, 3, 100, DIM, lib.d_max):
        segs = [knn.KnnSegment(rand(n, d), flags(n), flags(n),
                               flags(n, 0.5)) for n in (1, 31, 513)]
        check(f"d={d} n=1/31/513", segs,
              torch.randn(d, device=dev, generator=gen))
    flat = rand(4097).flatten()
    odd = flat[1: 1 + 4096 * DIM].view(4096, DIM)      # base 4 bytes off
    if odd.data_ptr() % 16 == 0:
        raise AssertionError("the unaligned case is aligned")
    check("unaligned base + empty + all-invalid + aligned",
          [knn.KnnSegment(odd, flags(4096)),
           knn.KnnSegment(rand(0), torch.zeros(0, dtype=torch.bool,
                                               device=dev)),
           knn.KnnSegment(rand(777), torch.zeros(777, dtype=torch.bool,
                                                 device=dev)),
           knn.KnnSegment(rand(5000), None)], q)
    many = 40
    check(f"{many} segments in one table",
          [knn.KnnSegment(rand(int(n)), flags(int(n)))
           for n in torch.randint(0, 700, (many,), generator=torch.Generator(
               ).manual_seed(9))], q)
    log(f"K1 scores entry: {cases} cases (6 functions each) byte-equal to "
        f"the plain version and launch to launch (lanes per row equal to "
        f"the plain version's at 10 widths; d_max {lib.d_max})")

    out = {}
    fn = "l2Squared"

    def one(segs):
        return lambda: cuda_knn.knn_scores_segments_cuda(segs, q, fn=fn)

    def plain(segs):
        return lambda: knn.vector_scores_segments(segs, q, fn=fn)

    def scores_bound(rows):
        return bound_ms(rows * DIM * 4 + DIM * 4 + rows * 4,
                        4.0 * rows * DIM, FP64_FLOPS_PER_S)

    # per segment: each scale segment's [n_pad, 128] in turn (32 MiB
    # each, so L2 does not hold them across the sixteen)
    every = [knn.KnnSegment(v, None) for v, _e, _lv in scale]
    nseg = len(every)
    per = [[s] for s in every]
    ms, plain_ms = in_turns(lambda: [one(s)() for s in per],
                            lambda: [plain(s)() for s in per], 10)
    lib_ms = cuda_ms(lambda: [s.vectors @ q for s in every], 10)
    dev_ms = kernel_device_ms(lambda: [one(s)() for s in per], 5,
                              "knn_scores_kernel")
    from opensearch_tpu_torch.testing.k1_sweep import device_ms
    lib_dev_ms = device_ms(lambda: [s.vectors @ q for s in every], 5)
    lib_dev_ms = None if lib_dev_ms is None else lib_dev_ms / nseg
    n_pad = every[0].vectors.shape[0]
    bms, by = scores_bound(n_pad)
    out["knn_scores"] = {
        "ms": ms / nseg, "plain_ms": plain_ms / nseg,
        "library_ms": lib_ms / nseg, "bound_ms": bms, "bound_by": by,
        "device_ms": dev_ms, "library_device_ms": lib_dev_ms,
        "max_abs_err": 0.0, "shape": f"{n_pad}x{DIM}, {fn}"}
    log(f"K1 scores {fn} {n_pad}x{DIM} per segment: ms {ms / nseg:.4f} "
        f"device_ms {dev_ms} plain_ms {plain_ms / nseg:.4f} library_ms"
        f"(vectors @ q) {lib_ms / nseg:.4f} (device {lib_dev_ms}) bound_ms "
        f"{bms:.4f} ({by}) on {gpu_name_power()}")
    # the 16 segments in one launch
    ms, plain_ms = in_turns(one(every), plain(every), 10)
    lib_ms = cuda_ms(lambda: [s.vectors @ q for s in every], 10)
    dev_ms = kernel_device_ms(one(every), 5, "knn_scores_kernel")
    bms, by = scores_bound(n_pad * nseg)
    out["knn_scores_16"] = {"ms": ms, "plain_ms": plain_ms,
                            "library_ms": lib_ms, "device_ms": dev_ms,
                            "bound_ms": bms, "bound_by": by}
    log(f"K1 scores {fn} {nseg}x{n_pad}x{DIM} in one launch: ms {ms:.4f} "
        f"device_ms {dev_ms} plain_ms {plain_ms:.4f} library_ms"
        f"([v @ q for v in segs]) {lib_ms:.4f} bound_ms {bms:.4f} ({by})")
    # one segment of 1M rows
    segs = [knn.KnnSegment(big, None)]
    ms, plain_ms = in_turns(one(segs), plain(segs), 10)
    lib_ms = cuda_ms(lambda: big @ q, 10)
    dev_ms = kernel_device_ms(one(segs), 5, "knn_scores_kernel")
    bms, by = scores_bound(BIG_N)
    out["k1_1m"] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "device_ms": dev_ms, "bound_ms": bms}
    log(f"K1 scores {fn} 1Mx{DIM}: ms {ms:.4f} device_ms {dev_ms} plain_ms "
        f"{plain_ms:.4f} library_ms(vectors @ q) {lib_ms:.4f} bound_ms "
        f"{bms:.4f} ({by}) on {gpu_name_power()}")
    return out


def match_query(terms, **extra) -> dict:
    """A ``match`` query over ``body`` for the bag ``terms``."""
    return {"match": {"body": {"query": " ".join(terms), **extra}}}


def df_sum(pf, terms) -> int:
    """Postings of ``terms`` in one segment's ``body`` field."""
    return sum(int(pf.df[pf.term_id(t)]) for t in terms
               if pf.term_id(t) >= 0)


def topk_inputs(segs, searcher, query) -> list:
    """Each segment's ``TermBagSegment`` of a scored bag, as the
    searcher's one top-k call builds them."""
    from opensearch_tpu_torch.search.executor import build_arrays

    plan, bind = searcher.compiled(query)
    out = []
    for seg in segs:
        dseg = seg.device(searcher.device)
        A = build_arrays(dseg, plan.arrays(), searcher.mapper,
                         live=searcher.ctx.live_mask(seg, dseg),
                         partial_ok=plan.arrays())
        out.append(plan.topk_input(bind, seg, dseg, A))
    return out


def phase_kernels(scale_segs, searcher, query_pairs):
    """K1 and K2 against their plain twins on the card, and timed at the
    shapes the main path gives them."""
    import torch

    from opensearch_tpu_torch.ops import bm25, cuda_knn, knn

    dev = torch.device(DEVICE)
    out = {}
    gen = torch.Generator(device=dev).manual_seed(1234)
    out.update(phase_knn_scores(scale_segs, dev, gen))
    out["knn_topk"] = phase_knn_topk(scale_segs, dev, gen)

    # the scale corpus's bags: the median and the heaviest by postings in
    # the first segment, and a 4-term bag
    pf0 = scale_segs[0].postings["body"]
    bags = []
    for a, b in query_pairs:
        bags.append([f"t{a}", f"t{b}"] if a != b else [f"t{a}"])
    by_size = sorted(bags, key=lambda t: df_sum(pf0, t))
    median_bag = by_size[len(by_size) // 2]
    checks = [median_bag, by_size[-1],
              by_size[len(by_size) // 4] + by_size[-2]]   # a 4-term bag
    out["bags"] = {"median": median_bag, "heaviest": by_size[-1]}

    out["term_bag_topk"] = phase_term_bag_topk(
        scale_segs, searcher, dev, gen, median_bag, by_size[-1],
        checks[2])
    out["batch_topk"] = phase_batch_topk(searcher, dev, gen, query_pairs)
    return out


def phase_term_bag_topk(scale_segs, searcher, dev, gen, median_bag,
                        heaviest_bag, four_bag):
    """K2's top-k entry against its plain twin over the 16 scale
    segments, byte for byte, at every bag, mask and k the contract lists;
    then timed (one launch per query) on the median and the heaviest bag
    beside the plain twin, the library chain ``[torch.topk(zeros(n_pad)
    .index_add_(...), k) for each segment]`` and the bound."""
    import torch

    from opensearch_tpu_torch.ops import bm25, cuda_bm25

    def inputs_for(query):
        return topk_inputs(scale_segs, searcher, query)

    median = inputs_for(match_query(median_bag))
    deleted = [seg._replace(live=seg.live & (torch.rand(
        seg.live.shape[0], device=dev, generator=gen) > 0.1))
        for seg in median]
    cases = {"median": (median, -np.inf),
             "heaviest": (inputs_for(match_query(heaviest_bag)), -np.inf),
             "4-term": (inputs_for(match_query(four_bag)), -np.inf),
             "and": (inputs_for(match_query(heaviest_bag, operator="and")),
                     -np.inf),
             "deletes": (deleted, -np.inf)}
    top = bm25.term_bag_topk_segments(median, k=100).numpy()[0]
    cut = float(np.float32(np.median(top[np.isfinite(top)])))
    cases["min_score"] = (median, cut)
    fn = cuda_bm25.term_bag_topk_segments_cuda
    ks = (1, 10, 100, cuda_bm25.K_MAX, cuda_bm25.K_MAX + 1)
    for name, (inputs, ms) in cases.items():
        for k in ks:
            before = fn.launches, fn.sorted_route_segments
            got = fn(inputs, k=k, min_score=ms).numpy()
            ref = bm25.term_bag_topk_segments(inputs, k=k,
                                              min_score=ms).numpy()
            sorted_route = k > cuda_bm25.K_MAX
            if (fn.launches - before[0], fn.sorted_route_segments
                    - before[1]) != (int(not sorted_route),
                                     len(inputs) * sorted_route):
                raise AssertionError(f"K2 top-k {name} k={k}: wrong route")
            for what, a, b in zip(("vals", "ids", "totals", "maxes"), got,
                                  ref):
                if a.tobytes() != b.tobytes():
                    raise AssertionError(
                        f"K2 top-k {name} k={k}: {what} differ from the "
                        "plain twin")
        log(f"K2 top-k {name} (min_score {ms}): k {list(ks)} byte-equal to "
            f"the plain twin (vals, ids, totals, maxes); totals "
            f"{int(ref[2].sum())}")

    out = {}
    for name in ("median", "heaviest"):
        inputs = cases[name][0]
        k = 10
        calls = []
        nbytes = 0
        for seg in inputs:
            act = seg.active
            rows = [(int(a), int(b), float(i), float(w)) for (a, b), i, w
                    in zip(seg.rows[act], seg.idfs[act], seg.weights[act])]
            n_pad = seg.live.shape[0]
            nbytes += sum(8 * (b - a) for a, b, _i, _w in rows) + n_pad + \
                8 * k + 8
            calls.append((seg, rows, n_pad))

        def lib_chain():
            for seg, rows, n_pad in calls:
                acc = torch.zeros(n_pad, dtype=torch.float32, device=dev)
                for a, b, idf_v, w in rows:
                    acc.index_add_(0, seg.doc_ids[a:b],
                                   seg.impacts[a:b] * idf_v, alpha=w)
                torch.topk(acc, k)

        ms, plain_ms = in_turns(
            lambda: fn(inputs, k=k),
            lambda: bm25.term_bag_topk_segments(inputs, k=k), 20)
        lib_ms = cuda_ms(lib_chain, 20)
        dev_ms = kernel_device_ms(lambda: fn(inputs, k=k), 20,
                                  "term_bag_topk_kernel")
        postings = sum(b - a for _s, rows, _n in calls for a, b, _i, _w in rows)
        bms, by = bound_ms(nbytes, 3.0 * postings)
        bag = median_bag if name == "median" else heaviest_bag
        log(f"K2 top-k {name} bag {bag} k={k} over {len(inputs)} segments "
            f"({postings} postings), one launch per query: ms {ms:.4f} "
            f"device_ms {dev_ms} plain_ms {plain_ms:.4f} library_ms"
            f"(index_add_ + topk chain) {lib_ms:.4f} bound_ms {bms:.5f} "
            f"({by}: {nbytes} bytes) on {gpu_name_power()}")
        out[name] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
                     "bound_bytes": nbytes, "bag": bag, "postings": postings}
    return {**out["median"], "max_abs_err": 0.0, "heaviest": out["heaviest"]}


def match_body(a: int, b: int, size: int = 10, **extra) -> dict:
    """A ``match`` body over the scale corpus's ``body`` field."""
    terms = f"t{a} t{b}"
    query = {"query": terms, **extra} if extra else terms
    return {"query": {"match": {"body": query}}, "size": size,
            "_source": False}


def batch_inputs(searcher, bodies) -> dict:
    """The prepared inputs of the one ``BatchGroup`` that ``bodies`` (one
    field, one size) form: ``{"segs", "required", "need_counts", ...}``."""
    from opensearch_tpu_torch.search.batch import plan_batches

    groups, fallback = plan_batches(searcher, bodies)
    if fallback or len(groups) != 1:
        raise AssertionError(f"bodies form {len(groups)} groups and "
                             f"{len(fallback)} fallbacks")
    return groups[0]._prepare(searcher)


def phase_batch_topk(searcher, dev, gen, query_pairs):
    """K3 against its plain twin over the 16 scale segments, byte for
    byte: batches of 1, 7 and 64 ``match`` queries of the zipf log (OR
    bags, with and without the presence counts), 64 ``and`` bags, 64 OR
    bags over segments with deletes, 64 bags with a duplicate term (OR
    and ``and``), 64 bags with negative weights, and 256 bags of 3-4
    distinct terms (several query chunks at K_MAX), k in 1, 10, 100,
    K_MAX; then timed on the 64-query OR batch at k = 10 and 100 (one
    launch per batch, the launch table cached as the main path caches it)
    beside the plain twin, the library chain (the reference's formulation
    per segment: ``index_add_`` into a [T * n_pad] arena, row gathers,
    ``torch.topk``), the route K3 replaced (K2's top-k kernel over one
    table entry per (query, segment), ``testing/k3_sweep.py``) and the
    bound."""
    import torch

    from opensearch_tpu_torch.ops import cuda_bm25
    from opensearch_tpu_torch.search import batch
    from opensearch_tpu_torch.testing import corpus, k3_sweep

    fn = cuda_bm25.batch_term_bag_topk_cuda
    lib = cuda_bm25._union_library()
    for caps in ((60, 64, 128, 16, 512, 64, 4000, 0),
                 (3, 45, 150, 32, 256, 512, 0, 1),
                 (1000, 1, 1000, 1, 32, 512, 88, 1)):
        if lib.union_topk_smem_bytes(*caps) != cuda_bm25.union_smem_bytes(
                *caps):
            raise AssertionError(f"K3 shared memory sum differs from the "
                                 f"wrapper's at {caps}")
    cases = {}

    def add(name, bodies):
        prep = batch_inputs(searcher, bodies)
        cases[name] = (prep["segs"], prep["required"], len(bodies),
                       prep["need_counts"])

    for n in (1, 7, 64):
        add(f"{n} or", [match_body(a, b) for a, b in query_pairs[:n]])
    add("64 and", [match_body(a, b, operator="and")
                   for a, b in query_pairs[64:128]])
    segs64, req64, _n, _nc = cases["64 or"]
    deleted = [seg._replace(live=seg.live & (torch.rand(
        seg.live.shape[0], device=dev, generator=gen) > 0.1))
        for seg in segs64]
    cases["64 or, deletes"] = (deleted, req64, 64, False)

    def dup_body(a, b, **extra):
        body = match_body(a, b, **extra)
        q = body["query"]["match"]["body"]
        text = f"t{a} t{a} t{b}"
        body["query"]["match"]["body"] = ({**q, "query": text}
                                          if extra else text)
        return body

    add("64 duplicate", [dup_body(a, b) for a, b in query_pairs[:64]])
    add("64 duplicate and", [dup_body(a, b, operator="and")
                             for a, b in query_pairs[:64]])
    # negative weights: every other query's second slot at -0.5, so the
    # batch takes the counted match rule, as the plain twin does
    sign = np.where(np.arange(segs64[0].qweights.shape[0]) % 2, 1.0,
                    -0.5).astype(np.float32)[:, None]
    negative = [seg._replace(qweights=np.concatenate(
        [seg.qweights[:, :1], seg.qweights[:, 1:] * sign], axis=1))
        for seg in segs64]
    cases["64 negative"] = (negative, req64, 64, True)
    draws = iter(t for pair in corpus.zipf_query_log(4096, seed=11)
                 for t in pair)
    wide = []
    for i in range(256):
        terms: dict = {}
        while len(terms) < 3 + i % 2:
            terms[f"t{next(draws)}"] = None
        wide.append({"query": {"match": {"body": " ".join(terms)}},
                     "size": cuda_bm25.K_MAX, "_source": False})
    add("256 wide", wide)
    wide_segs, wide_req, _n, wide_nc = cases["256 wide"]
    chunks = cuda_bm25.union_table(wide_segs, wide_req, n_queries=256,
                                   k=cuda_bm25.K_MAX,
                                   need_counts=wide_nc).n_chunks
    if chunks < 2:
        raise AssertionError(f"K3 256 wide at K_MAX: {chunks} chunk")
    ks = (1, 10, 100, cuda_bm25.K_MAX)
    for name, (segs, req, n, need_counts) in cases.items():
        ways = (need_counts,) if need_counts else (False, True)
        for nc in ways:
            for k in ks:
                before = fn.launches
                got = fn(segs, req, n_queries=n, k=k,
                         need_counts=nc).numpy()
                ref = batch.batch_term_bag_topk_segments(
                    segs, req, n_queries=n, k=k, need_counts=nc).numpy()
                if fn.launches - before != 1:
                    raise AssertionError(f"K3 {name} k={k}: "
                                         f"{fn.launches - before} launches")
                for what, a, b in zip(("vals", "ids", "totals", "maxes"),
                                      got, ref):
                    if a.tobytes() != b.tobytes():
                        raise AssertionError(
                            f"K3 {name} need_counts={nc} k={k}: {what} "
                            "differ from the plain twin")
        log(f"K3 batch {name} ({len(segs)} segments, need_counts "
            f"{list(ways)}): k {list(ks)} byte-equal to the plain twin "
            f"(vals, ids, totals, maxes), one launch each; totals "
            f"{int(ref[2].sum())}")
    log(f"K3 batch 256 wide at k={cuda_bm25.K_MAX}: {chunks} query chunks "
        "in one launch")

    n = 64
    nbytes = {}
    postings = 0
    query_postings = 0         # each query's rows, summed over queries
    lib_inputs = []
    for seg in segs64:
        n_u = int(seg.union_active.sum())
        rows = seg.union_rows[:n_u]
        lens = rows[:, 1] - rows[:, 0]
        seg_postings = int(lens.sum())
        postings += seg_postings
        query_postings += int(lens[seg.qslots[:n]][seg.qact[:n] > 0].sum())
        n_pad = seg.live.shape[0]
        for k in (10, 100):
            nbytes[k] = nbytes.get(k, 0) + 8 * seg_postings + n_pad \
                + n * (8 * k + 8)
        pos = np.concatenate([np.arange(a, b) for a, b in rows])
        slot = np.repeat(np.arange(n_u), rows[:, 1] - rows[:, 0])
        docs = seg.doc_ids[torch.from_numpy(pos).to(dev)].long()
        lib_inputs.append((
            seg, n_u, torch.from_numpy(pos).to(dev),
            torch.from_numpy(slot).to(dev) * n_pad + docs,
            torch.from_numpy(seg.union_idfs[slot]).to(dev),
            torch.from_numpy(seg.qslots[:n]).to(dev).long(),
            torch.from_numpy(seg.qweights[:n]).to(dev)))

    def lib_chain(k):
        for seg, n_u, pos, flat, idf_p, qs, qw in lib_inputs:
            n_pad = seg.live.shape[0]
            arena = torch.zeros(n_u * n_pad, dtype=torch.float32,
                                device=dev).index_add_(
                0, flat, seg.impacts[pos] * idf_p)
            dense = arena.view(n_u, n_pad)
            scores = torch.zeros((n, n_pad), dtype=torch.float32,
                                 device=dev)
            for j in range(qs.shape[1]):
                scores = scores + qw[:, j: j + 1] * dense[qs[:, j]]
            key = torch.where((scores > 0) & seg.live, scores, -torch.inf)
            torch.topk(key, k, dim=1)

    old_table = k3_sweep.pinned_batch_table(segs64, req64, n_queries=n,
                                            need_counts=False)
    out = {}
    unions = [int(seg.union_active.sum()) for seg in segs64]
    for k in (10, 100):
        table = cuda_bm25.pinned_union_table(segs64, req64, n_queries=n,
                                             k=k, need_counts=False)

        def kernel():
            return fn(segs64, req64, n_queries=n, k=k, need_counts=False,
                      table=table)

        def old():
            return k3_sweep.old_route(segs64, old_table, n_queries=n, k=k)

        got, ref = kernel().numpy(), old().numpy()
        if any(a.tobytes() != b.tobytes() for a, b in zip(got, ref)):
            raise AssertionError(f"K3 k={k}: differs from the old route")
        ms, plain_ms = in_turns(
            kernel, lambda: batch.batch_term_bag_topk_segments(
                segs64, req64, n_queries=n, k=k, need_counts=False), 10)
        old_ms, _ = in_turns(old, kernel, 10)
        lib_ms = cuda_ms(lambda: lib_chain(k), 10)
        dev_ms = kernel_device_ms(kernel, 20, "union_topk_kernel")
        old_dev_ms = kernel_device_ms(old, 20, "term_bag_topk_kernel")
        dev_ms2 = kernel_device_ms(kernel, 20, "union_topk_kernel")
        old_dev_ms2 = kernel_device_ms(old, 20, "term_bag_topk_kernel")
        if None in (dev_ms, dev_ms2, old_dev_ms, old_dev_ms2):
            raise AssertionError("the profiler shows no K3 or old-route "
                                 "kernel")
        # bytes: each union posting (id + impact) read once, a live byte
        # per doc, each (query, segment)'s k keys, total and max written
        # once; operations: w * (idf * imp) + score per posting of each
        # query
        bms, by = bound_ms(nbytes[k], 3.0 * query_postings)
        log(f"K3 batch of {n} OR bags k={k} over {len(segs64)} segments "
            f"(union {min(unions)}-{max(unions)} terms, {postings} union "
            f"postings, {query_postings} summed over the queries; "
            f"{table.n_chunks} chunk, D {table.docs}, {table.blocks} blocks "
            f"per segment), one launch per batch: ms {ms:.4f} device_ms "
            f"{dev_ms} / {dev_ms2} plain_ms {plain_ms:.4f} "
            f"library_ms(index_add_ arena + row gathers + topk chain) "
            f"{lib_ms:.4f} old route (K2 kernel over (query, segment) "
            f"entries) ms {old_ms:.4f} device_ms {old_dev_ms} / "
            f"{old_dev_ms2} bound_ms {bms:.5f} ({by}: {nbytes[k]} bytes) on "
            f"{gpu_name_power()}")
        out[k] = {"ms": ms, "device_ms": min(dev_ms, dev_ms2),
                  "plain_ms": plain_ms, "library_ms": lib_ms,
                  "old_route_ms": old_ms,
                  "old_route_device_ms": min(old_dev_ms, old_dev_ms2),
                  "bound_ms": bms, "bound_by": by, "bound_bytes": nbytes[k],
                  "postings": postings, "query_postings": query_postings,
                  "max_abs_err": 0.0, "batch": n, "k": k}
    return {**out[10], "k100": out[100]}


# -- phase 3 ----------------------------------------------------------------

INGEST_MAPPING = {"properties": {
    "body": {"type": "text"},
    "tag": {"type": "keyword"},
    "vec": {"type": "knn_vector", "dimension": DIM, "space_type": "l2"},
    "vec_cos": {"type": "knn_vector", "dimension": DIM,
                "space_type": "cosinesimil"},
    "vec_ip": {"type": "knn_vector", "dimension": DIM,
               "space_type": "innerproduct"},
}}


def ingest_docs(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    tags = ["red", "green", "blue", "gold", "grey"]
    docs = []
    for i in range(n):
        words = (rng.zipf(1.3, size=int(rng.integers(5, 40))) - 1) % 2000
        vec = rng.standard_normal(DIM).astype(np.float32).tolist()
        docs.append({"body": " ".join(f"w{w}" for w in words),
                     "tag": tags[i % len(tags)],
                     "vec": vec, "vec_cos": vec, "vec_ip": vec})
    return docs


def ingest_queries(seed: int) -> list:
    rng = np.random.default_rng(seed)
    qv = [rng.standard_normal(DIM).astype(np.float32).tolist()
          for _ in range(4)]
    bm25_q = [
        {"match": {"body": "w0 w3 w17"}},
        {"match": {"body": {"query": "w1 w2", "operator": "and"}}},
        {"match": {"body": {"query": "w0 w5 w9 w11",
                            "minimum_should_match": 2}}},
        {"bool": {"must": [{"match": {"body": "w2 w4"}}],
                  "filter": [{"term": {"tag": "blue"}}]}},
        {"constant_score": {"filter": {"term": {"tag": "gold"}},
                            "boost": 1.5}},
    ]
    from opensearch_tpu_torch.ops.cuda_knn import K_MAX
    knn_q = [
        {"knn": {"vec": {"vector": qv[0], "k": 10}}},
        {"knn": {"vec_cos": {"vector": qv[1], "k": 10}}},
        {"knn": {"vec_ip": {"vector": qv[2], "k": 10}}},
        {"knn": {"vec": {"vector": qv[3], "k": 10,
                         "filter": {"term": {"tag": "red"}}}}},
        # above the kernel's in-kernel k: the scores-only route
        {"knn": {"vec_cos": {"vector": qv[0], "k": K_MAX + 1}}},
    ]
    return ([{"query": q, "size": 20} for q in bm25_q]
            + [{"query": {"match": {"body": "w1 w6"}}, "size": 20,
                "min_score": 0.8},
               {"query": {"match": {"body": "w0 w1"}}, "size": 5,
                "track_total_hits": False}],
            [{"query": q, "size": 10, "_source": False} for q in knn_q])


def phase_ingest():
    from opensearch_tpu_torch.index.segment import SegmentWriter
    from opensearch_tpu_torch.ops import cuda_bm25
    from opensearch_tpu_torch.mapping.mapper import DocumentMapper
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing.parity import (bm25_mismatch,
                                                     knn_mismatch)

    mapper = DocumentMapper(INGEST_MAPPING)
    docs = ingest_docs(2000, seed=11)
    parsed = [mapper.parse(str(i), d) for i, d in enumerate(docs)]
    writer = SegmentWriter()
    segs = [writer.build(parsed[:1100], "ingest_0"),
            writer.build(parsed[1100:], "ingest_1")]
    segs[0].apply_deletes([3, 10, 500, 1099])
    segs[1].apply_deletes([0, 7, 899])
    gpu = ShardSearcher(segs, mapper, device=DEVICE)
    cpu = ShardSearcher(segs, mapper, device="cpu")
    bm25_bodies, knn_bodies = ingest_queries(seed=12)
    dense = cuda_bm25.dense_f32
    for body in bm25_bodies:
        dense0 = dense.launches
        a = gpu.search(body)
        made = dense.launches - dense0
        b = cpu.search(body)
        bad = bm25_mismatch(a, b)
        if bad:
            raise AssertionError(f"ingest {body['query']}: {bad}")
        # untracked totals: the match's one dense launch over both
        # segments, then a plan top-k a segment
        if "track_total_hits" in body and made != 1:
            raise AssertionError(f"ingest untracked match: {made} dense "
                                 "launches")
        if not a["hits"]["hits"]:
            raise AssertionError(f"ingest {body['query']}: no hits")
        log(f"ingest bm25 ok: {json.dumps(body)[:80]} "
            f"total={a['hits']['total']['value']}")
    for q in ({"match": {"body": "w0 w3 w17"}}, {"term": {"tag": "red"}}):
        a, b = gpu.count(q), cpu.count(q)
        if a != b or not a:
            raise AssertionError(f"ingest count {q}: {a} vs {b}")
        log(f"ingest count ok: {json.dumps(q)} = {a}")
    for body in knn_bodies:
        dense0 = dense.launches
        a = gpu.search(body)
        made = dense.launches - dense0
        b = cpu.search(body)
        bad = knn_mismatch(a, b)
        if bad:
            raise AssertionError(f"ingest knn: {bad}")
        if len(a["hits"]["hits"]) != 10:
            raise AssertionError("ingest knn: expected 10 hits")
        field = next(iter(body["query"]["knn"]))
        spec = body["query"]["knn"][field]
        # a filter's term bag: one dense launch over both segments
        if made != ("filter" in spec):
            raise AssertionError(f"ingest knn: {made} dense launches")
        log(f"ingest knn ok: field={field} k={spec['k']} filtered="
            f"{'filter' in spec}")


# -- phase 2: K5, the bucket collector; the filter masks -----------------------

def multi_valued(n_docs: int, kind: str, seed: int) -> dict:
    """A column of ``n_docs`` docs with 1-3 values each (~30% of the
    later values repeat the one before, duplicates in one bucket), laid
    out as
    ``DeviceSegment`` stages a numeric or ordinal column: values sorted
    per doc, padded to a power of two with value 0 (ordinal -1) and doc
    ``n_docs``, offsets over ``n_pad + 1`` slots."""
    from opensearch_tpu_torch.index.segment import pad_pow2

    rng = np.random.default_rng(seed)
    per = rng.integers(1, 4, size=n_docs)
    docs = np.repeat(np.arange(n_docs, dtype=np.int32), per)
    if kind == "long":
        vals = rng.integers(0, 10_000, size=len(docs)).astype(np.int64)
    elif kind == "double":
        vals = np.round(rng.lognormal(2.3, 0.6, size=len(docs)), 2)
    else:
        vals = rng.integers(0, 40, size=len(docs)).astype(np.int32)
    same = np.r_[False, docs[1:] == docs[:-1]] & (rng.random(len(docs)) < 0.3)
    vals[same] = vals[np.nonzero(same)[0] - 1]
    order = np.lexsort((vals, docs))
    vals, docs = vals[order], docs[order]
    if kind == "ordinal":           # ordinals are distinct per doc
        keep = np.r_[True, (docs[1:] != docs[:-1]) | (vals[1:] != vals[:-1])]
        vals, docs = vals[keep], docs[keep]
    n_pad = pad_pow2(n_docs + 1)
    v_pad = pad_pow2(len(vals))
    pv = np.full(v_pad, -1 if kind == "ordinal" else 0, vals.dtype)
    pv[: len(vals)] = vals
    pd = np.full(v_pad, n_docs, np.int32)
    pd[: len(docs)] = docs
    offs = np.searchsorted(docs, np.arange(n_pad + 1)).astype(np.int32)
    return {"values": pv, "value_docs": pd, "offsets": offs}


def k5_bytes(segs, edges=None, self_metric=False) -> float:
    """Bytes K5 must move for one call: each input read once (matched,
    the key column and its docs, each sub-column's values and offsets,
    the edges), each output word written once."""
    n_subs = 1 if self_metric else len(segs[0].subs)
    total = 0.0 if edges is None else 8.0 * edges.shape[0]
    for s in segs:
        total += s.matched.shape[0] + s.keys.numel() * s.keys.element_size() \
            + 4 * s.key_docs.numel()
        total += 8.0 * s.n_buckets_pad * (1 + 4 * n_subs)
        for col in s.subs:
            if col is not None:
                total += col["values"].numel() * 8 + \
                    4 * col["offsets"].numel()
    return total


def k5_library_chain(segs, mode, edges=None):
    """The yardstick: the same function as PyTorch's scatter calls the
    port never makes (``index_add_`` / ``scatter_reduce_``, with float
    atomics on the card): counts, per-doc partials, then per-bucket
    partials, per segment."""
    import torch

    out = []
    for s in segs:
        dev = s.matched.device
        docs = s.key_docs.long()
        ok = s.matched[docs]
        if mode == "ordinal":
            b = s.keys.long()
            ok = ok & (b >= 0)
        else:
            b = torch.searchsorted(edges, s.keys.double(), right=True) - 1
            ok = ok & (b >= 0) & (b < s.n_buckets)
            ok[1:] &= ~((docs[1:] == docs[:-1]) & (b[1:] == b[:-1]))
        nbp = s.n_buckets_pad
        tgt = torch.where(ok, b, nbp - 1)
        parts = [torch.zeros(nbp, dtype=torch.int64, device=dev).index_add_(
            0, tgt, ok.long())]
        n_pad = s.matched.shape[0]
        for col in s.subs:
            vd = col["value_docs"].long()
            sok = s.matched[vd]
            v = torch.where(sok, col["values"].double(), 0.0)
            dt = torch.where(sok, vd, n_pad - 1)
            ps = torch.zeros(n_pad, dtype=torch.float64,
                             device=dev).index_add_(0, dt, v)
            pc = torch.zeros(n_pad, dtype=torch.int64,
                             device=dev).index_add_(0, dt, sok.long())
            pmn = torch.full((n_pad,), torch.inf, dtype=torch.float64,
                             device=dev).scatter_reduce_(
                0, dt, torch.where(sok, v, torch.inf), "amin")
            pmx = torch.full((n_pad,), -torch.inf, dtype=torch.float64,
                             device=dev).scatter_reduce_(
                0, dt, torch.where(sok, v, -torch.inf), "amax")
            bs = torch.zeros(nbp, dtype=torch.float64,
                             device=dev).index_add_(
                0, tgt, torch.where(ok, ps[docs], 0.0))
            bc = torch.zeros(nbp, dtype=torch.int64, device=dev).index_add_(
                0, tgt, torch.where(ok, pc[docs], 0))
            bmn = torch.full((nbp,), torch.inf, dtype=torch.float64,
                             device=dev).scatter_reduce_(
                0, tgt, torch.where(ok, pmn[docs], torch.inf), "amin")
            bmx = torch.full((nbp,), -torch.inf, dtype=torch.float64,
                             device=dev).scatter_reduce_(
                0, tgt, torch.where(ok, pmx[docs], -torch.inf), "amax")
            parts += [bs, bc, bmn, bmx]
        out.append(parts)
    return out


def k5_err(a, b) -> float:
    """Largest absolute difference of the float64 words (sums, min, max)
    of two collector outputs of the same call; 0 when they are equal."""
    diff = 0.0
    x = a.cpu().numpy().view(np.float64)
    y = b.cpu().numpy().view(np.float64)
    fin = np.isfinite(x) & np.isfinite(y)
    if fin.any():
        diff = float(np.abs(x[fin] - y[fin]).max())
    return diff


def k5_plain(segs, mode, edges=None, self_metric=False):
    """K5's plain version of one call (a flag per segment: each
    segment's own plain call, concatenated)."""
    import torch

    from opensearch_tpu_torch.ops import aggs as agg_ops

    if isinstance(self_metric, list):
        return torch.cat([agg_ops.bucket_collect_plain(
            [s], mode=mode, edges=edges, self_metric=f)
            for s, f in zip(segs, self_metric)])
    return agg_ops.bucket_collect_plain(segs, mode=mode, edges=edges,
                                        self_metric=self_metric)


def k5_boundary_cases(seg0, d0, live0, mv, mv_edges) -> list:
    """K5's chunk boundaries at the real chunk (``cuda_aggs.CHUNK``), as
    ``tests/test_torch_aggs_ops.py`` holds the model of them on the CPU:
    runs whose first rank in a chunk falls at every residue mod 16 and at
    larger ones (one job per skip of leading unmatched docs, one call);
    runs of 2^k - 1, 2^k and 2^k + 1 entries within one chunk, across
    two and across many; chunks with no matched doc; a doc's two values
    in one bucket on either side of every chunk boundary (edges); 100,000
    ordinals (records found by binary search); several key columns in
    one single-mode call (int32, int64 and float64 keys, one column
    twice)."""
    import torch

    from opensearch_tpu_torch.ops import aggs as agg_ops
    from opensearch_tpu_torch.ops import cuda_aggs

    CS = agg_ops.CollectSegment
    dev = live0.device
    C = cuda_aggs.CHUNK
    fare, price, tag = d0.numeric["fare"], d0.numeric["price"], \
        d0.ordinal["tag"]
    docs = fare["value_docs"]
    real = docs < seg0.n_docs
    doc_ids = torch.arange(d0.n_pad, device=dev)
    zero = torch.where(real, 0, -1).to(torch.int32)
    skips = list(range(16)) + [31, 33, 100, 1000, C // 2, C - 1]
    cases = [("runs starting at every residue", "ordinal",
              [CS(live0 & (doc_ids >= k), zero, docs, 2, [fare])
               for k in skips], None, False)]
    runs = []
    for length in (7, 8, 9, C - 1, C, C + 1, 2 * C - 1, 2 * C, 2 * C + 1,
                   8 * C - 1, 8 * C, 8 * C + 1):
        for offset in (0, 1000):
            pos = torch.arange(docs.shape[0], device=dev)
            key = torch.where((pos >= offset) & (pos < offset + length), 0,
                              1).to(torch.int32)
            runs.append(CS(live0, torch.where(real, key, -1), docs, 2,
                           [fare, price]))
    cases.append(("runs of 2^k - 1, 2^k, 2^k + 1 across chunks", "ordinal",
                  runs, None, False))
    empty = live0 & ((doc_ids < 2 * C) | (doc_ids >= 5 * C))
    cases.append(("empty chunks (ordinal)", "ordinal",
                  [CS(empty, tag["ords"], tag["value_docs"], tag["n_ords"],
                      [fare])], None, False))
    cases.append(("empty chunks (single)", "single",
                  [CS(empty, fare["values"], docs, 1)], None, True))
    # a doc's two values in one bucket straddling each chunk boundary
    vals = mv["long"]["values"].clone()
    vdocs = mv["long"]["value_docs"]
    straddle = 0
    for b in range(C, vals.shape[0], C):
        if int(vdocs[b - 1]) == int(vdocs[b]) < seg0.n_docs:
            vals[b] = vals[b - 1]
            straddle += 1
    if not straddle:
        raise AssertionError("no doc straddles a chunk boundary")
    cases.append((f"edges repeat across {straddle} chunk boundaries",
                  "edges", [CS(live0, vals, vdocs, mv_edges.shape[0] - 1,
                               [mv["double"]])], mv_edges, False))
    # 100,000 ordinals, 1-3 a doc
    rng = np.random.default_rng(74)
    per = rng.integers(1, 4, size=seg0.n_docs)
    kd = np.repeat(np.arange(seg0.n_docs, dtype=np.int32), per)
    ko = rng.integers(0, 100_000, size=len(kd)).astype(np.int32)
    order = np.lexsort((ko, kd))
    kd, ko = kd[order], ko[order]
    keep = np.r_[True, (kd[1:] != kd[:-1]) | (ko[1:] != ko[:-1])]
    kd, ko = kd[keep], ko[keep]
    v_pad = 1 << (len(ko) - 1).bit_length()
    pk = np.full(v_pad, -1, np.int32)
    pk[: len(ko)] = ko
    pd = np.full(v_pad, seg0.n_docs, np.int32)
    pd[: len(kd)] = kd
    big = CS(live0, torch.from_numpy(pk).to(dev),
             torch.from_numpy(pd).to(dev), 100_000, [fare])
    if cuda_aggs.plan_launch([big.n_buckets_pad], 0)[1]:
        raise AssertionError("100,000 ordinals took a dense row")
    cases.append(("ordinal 100,000 ordinals", "ordinal", [big], None, False))
    batch, flags = [], []
    for col, key, flag in ((fare, "values", True), (price, "values", True),
                           (fare, "values", True), (tag, "ords", False)):
        batch.append(CS(live0, col[key], col["value_docs"], 1))
        flags.append(flag)
    batch.append(CS(live0, mv["double"]["values"],
                    mv["double"]["value_docs"], 1))
    flags.append(True)
    cases.append(("batched single (fare, price, fare, tag, multi-valued)",
                  "single", batch, None, flags))
    return cases


def phase_k5(scale_segs, searcher) -> dict:
    """K5 (``bucket_collect_cuda``, ``csrc/aggs.cu``) against its plain
    version on the card, byte for byte, in the ordinal, edges and single
    modes with 0, 1 and 2 sub-columns (long ``price``, double ``fare``)
    on one scale segment and on multi-valued columns built for the check
    (1-3 values a doc, duplicates in one bucket), and at its chunk
    boundaries (``k5_boundary_cases``); one call per collector request
    (its kernels counted apart), and two calls on the same inputs
    byte-equal; the plain version on the CPU equal too; edges beyond
    ``EDGES_SMEM_MAX`` searched in global memory; the wrapper's
    shared-memory plan equal to the kernel's.  Then timed at the main
    path's three shapes, one call over the 16 scale segments, in turns
    with its plain version: a day ``date_histogram`` on ``ts`` with a
    ``stats`` sub on ``fare`` over every live doc (phase 11's
    whole-index request) and ``terms`` on ``tag`` with two subs beside
    the ``index_add_`` / ``scatter_reduce_`` chain, and the single mode
    over ``fare`` (a ``stats``) beside ``v = values[matched[value_docs]]``
    with ``v.sum()``, ``v.aminmax()`` and ``v.numel()``; device time is
    the sum of K5's kernels under the profiler."""
    import torch

    from opensearch_tpu_torch.ops import aggs as agg_ops
    from opensearch_tpu_torch.ops import cuda_aggs
    from opensearch_tpu_torch.search.aggs import build_date_edges
    from opensearch_tpu_torch.testing import corpus
    from opensearch_tpu_torch.testing.k5_sweep import kernel_ms

    dev = torch.device(DEVICE)
    k5 = cuda_aggs.bucket_collect_cuda
    seg0 = scale_segs[0]
    d0 = seg0.device(dev)
    rng = np.random.default_rng(71)
    live0 = searcher.ctx.live_mask(seg0, d0)
    matched = live0 & torch.from_numpy(rng.random(d0.n_pad) < 0.6).to(dev)
    tag, ts = d0.ordinal["tag"], d0.numeric["ts"]
    price, fare = d0.numeric["price"], d0.numeric["fare"]
    day_edges = torch.from_numpy(build_date_edges(
        corpus.TS_START_MS, corpus.TS_START_MS + corpus.TS_SPAN_MS,
        calendar="day").astype(np.float64)).to(dev)
    price_edges = torch.arange(0, corpus.PRICE_MAX + 1000, 500,
                               dtype=torch.float64, device=dev)
    mv = {kind: {k: torch.from_numpy(v).to(dev) for k, v in
                 multi_valued(seg0.n_docs, kind, 72 + i).items()}
          for i, kind in enumerate(("long", "double", "ordinal"))}
    mv_edges = torch.arange(-50.0, 10_050.0, 250.0, dtype=torch.float64,
                            device=dev)
    CS = agg_ops.CollectSegment
    subs_sets = ([], [fare], [fare, price])
    cases = []
    for subs in subs_sets:
        cases.append((f"ordinal tag subs={len(subs)}", "ordinal",
                      [CS(matched, tag["ords"], tag["value_docs"],
                          tag["n_ords"], subs)], None, False))
        cases.append((f"edges ts/day subs={len(subs)}", "edges",
                      [CS(matched, ts["values"], ts["value_docs"],
                          day_edges.shape[0] - 1, subs)], day_edges, False))
        cases.append((f"edges price/500 subs={len(subs)}", "edges",
                      [CS(matched, price["values"], price["value_docs"],
                          price_edges.shape[0] - 1, subs)], price_edges,
                      False))
    for name, col in (("fare", fare), ("price", price),
                      ("multi-valued double", mv["double"])):
        cases.append((f"single {name}", "single",
                      [CS(matched, col["values"], col["value_docs"], 1)],
                      None, True))
    cases.append(("single tag (value_count)", "single",
                  [CS(matched, tag["ords"], tag["value_docs"], 1)], None,
                  False))
    for subs in ([], [mv["double"]], [mv["long"], mv["double"]]):
        cases.append((f"ordinal multi-valued subs={len(subs)}", "ordinal",
                      [CS(matched, mv["ordinal"]["values"],
                          mv["ordinal"]["value_docs"], 40, subs)], None,
                      False))
        cases.append((f"edges multi-valued long subs={len(subs)}", "edges",
                      [CS(matched, mv["long"]["values"],
                          mv["long"]["value_docs"], mv_edges.shape[0] - 1,
                          subs)], mv_edges, False))
    # more edges than shared memory takes: searched in global memory
    fine_edges = torch.arange(0, corpus.PRICE_MAX + 2, 1,
                              dtype=torch.float64, device=dev)
    if fine_edges.shape[0] <= cuda_aggs.EDGES_SMEM_MAX:
        raise AssertionError("the fine edges fit shared memory")
    cases.append(("edges price/1 (edges in global memory) subs=1", "edges",
                  [CS(matched, price["values"], price["value_docs"],
                      fine_edges.shape[0] - 1, [fare])], fine_edges, False))
    cases.append(("edges multi-valued double + price", "edges",
                  [CS(matched, mv["double"]["values"],
                      mv["double"]["value_docs"], 39, [price])],
                  torch.arange(0.0, 40.0, dtype=torch.float64, device=dev),
                  False))
    n_basic = len(cases)
    cases += k5_boundary_cases(seg0, d0, live0, mv, mv_edges)

    def to_cpu(segs):
        return [CS(s.matched.cpu(), s.keys.cpu(), s.key_docs.cpu(),
                   s.n_buckets,
                   [None if c is None else {k: v.cpu() for k, v in c.items()
                                            if isinstance(v, torch.Tensor)}
                    for c in s.subs]) for s in segs]

    lib = cuda_aggs._library()      # the shared-memory plan
    C = cuda_aggs.CHUNK
    for args in ((0, 366, 512, 512), (0, 0, 1024, 1024), (0, 8192, C, C),
                 (1, 0, 0, 512), (1, 0, 0, C), (1, 0, 0, 8)):
        if lib.agg_smem_bytes(*args) != cuda_aggs.smem_bytes(*args):
            raise AssertionError(f"K5 shared memory {args}: the wrapper's "
                                 "plan differs from the kernel's")
    if lib.agg_chunk() != C:
        raise AssertionError("K5 was built with another chunk")
    max_err = 0.0
    for i, (name, mode, segs, edges, self_metric) in enumerate(cases):
        before, kernels0 = k5.launches, k5.kernels
        a = k5(segs, mode=mode, edges=edges, self_metric=self_metric)
        b = k5(segs, mode=mode, edges=edges, self_metric=self_metric)
        if k5.launches - before != 2 or k5.kernels - kernels0 not in (4, 8):
            raise AssertionError(f"K5 {name}: {k5.launches - before} calls "
                                 f"and {k5.kernels - kernels0} kernels for "
                                 "two calls")
        p = k5_plain(segs, mode, edges, self_metric)
        torch.cuda.synchronize()
        max_err = max(max_err, k5_err(a, p))
        if not torch.equal(a, b):
            raise AssertionError(f"K5 {name}: two launches differ")
        if not torch.equal(a, p):
            raise AssertionError(f"K5 {name}: differs from its plain "
                                 f"version (max_abs_err {k5_err(a, p)})")
        if i % 4 == 0 or i >= n_basic:
            c = agg_ops.bucket_collect(
                to_cpu(segs), mode=mode,
                edges=None if edges is None else edges.cpu(),
                self_metric=self_metric)
            if not torch.equal(a.cpu(), c):
                raise AssertionError(f"K5 {name}: differs from the plain "
                                     "version on the CPU")
        n_subs = ([int(f) for f in self_metric]
                  if isinstance(self_metric, list)
                  else 1 if self_metric else len(segs[0].subs))
        counts = agg_ops.unpack(a.cpu().numpy(), segs, n_subs)
        if sum(int(c.sum()) for c, _s in counts) <= 0:
            raise AssertionError(f"K5 {name}: no entry counted")
    log(f"K5 {len(cases)} cases (ordinal, edges, single; 0-2 sub-columns, "
        f"long and double; one scale segment of {seg0.n_docs} docs, "
        f"multi-valued columns of 1-3 values a doc, and "
        f"{len(cases) - n_basic} at the {C}-entry chunks' boundaries: "
        f"{', '.join(c[0] for c in cases[n_basic:])}): byte-equal to the "
        f"plain version and run to run, one call each")

    # timed at the main path's shapes: 16 segments, one call
    views = []
    for seg in scale_segs:
        dseg = seg.device(dev)
        views.append((dseg, searcher.ctx.live_mask(seg, dseg)))
    dh = [CS(m, d.numeric["ts"]["values"], d.numeric["ts"]["value_docs"],
             day_edges.shape[0] - 1, [d.numeric["fare"]]) for d, m in views]
    terms = [CS(m, d.ordinal["tag"]["ords"], d.ordinal["tag"]["value_docs"],
                d.ordinal["tag"]["n_ords"],
                [d.numeric["fare"], d.numeric["price"]]) for d, m in views]
    single = [CS(m, d.numeric["fare"]["values"],
                 d.numeric["fare"]["value_docs"], 1) for d, m in views]

    def single_library():
        out = []
        for s in single:
            v = s.keys[s.matched[s.key_docs.long()]]
            out.append((v.sum(), v.aminmax(), v.numel()))
        return out

    rows = {}
    for name, segs, mode, edges, sm, library in (
            ("date_histogram", dh, "edges", day_edges, False,
             lambda: k5_library_chain(dh, "edges", day_edges)),
            ("terms", terms, "ordinal", None, False,
             lambda: k5_library_chain(terms, "ordinal")),
            ("single", single, "single", None, True, single_library)):
        def fn(segs=segs, mode=mode, edges=edges, sm=sm):
            return k5(segs, mode=mode, edges=edges, self_metric=sm)

        def plain(segs=segs, mode=mode, edges=edges, sm=sm):
            return agg_ops.bucket_collect_plain(segs, mode=mode, edges=edges,
                                                self_metric=sm)

        calls0, kernels0 = k5.launches, k5.kernels
        a = fn()
        per_call = (k5.launches - calls0, k5.kernels - kernels0)
        p = plain()
        torch.cuda.synchronize()
        if not torch.equal(a, p):
            raise AssertionError(f"K5 timed {name}: differs from plain")
        ms, plain_ms = in_turns(fn, plain, 5)
        lib_ms = cuda_ms(library, 5)
        for _ in range(3):     # a profiler window may lose its events
            dev_ms, per_kernel = kernel_ms(fn, 5)
            if dev_ms:
                break
        if not dev_ms:
            raise AssertionError("the profiler shows no K5 kernel")
        nbytes = k5_bytes(segs, edges, self_metric=sm)
        bms, by = bound_ms(nbytes, 0.0)
        entries = sum(s.keys.numel() for s in segs)
        rows[name] = {"ms": ms, "device_ms": dev_ms,
                      "device_ms_per_kernel": per_kernel,
                      "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bms, "bound_by": by, "bound_bytes": nbytes,
                      "entries": entries, "segments": len(segs),
                      "max_abs_err": k5_err(a, p), "calls": per_call[0],
                      "kernels_per_call": per_call[1]}
        log(f"K5 {name} over {len(segs)} segments ({entries} entries, "
            f"{1 if sm else len(segs[0].subs)} sub-columns), "
            f"{per_call[0]} call of {per_call[1]} kernels: ms {ms:.4f} "
            f"device_ms {dev_ms:.5f} ("
            + ", ".join(f"{k} {v:.5f}" for k, v in per_kernel.items())
            + f") plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} "
            f"bound_ms {bms:.5f} ({by}: {nbytes:.0f} bytes) on "
            f"{gpu_name_power()}")
    row = dict(rows["date_histogram"], max_abs_err=max_err,
               ordinal=rows["terms"], single=rows["single"],
               cases=len(cases))
    return {"bucket_collect": row, "masks": phase_masks(seg0, d0)}


def phase_masks(seg, dseg) -> dict:
    """``ops/filters.py``'s torch mask ops timed alone on one 62,500-doc
    segment (their plain versions are themselves; the reference's are
    XLA): ``range_mask`` on ``price`` over ~40% of the values,
    ``term_mask`` on a ``tag`` ordinal, ``terms_mask`` on 5 ordinals; and
    ``ops/aggs.py`` ``masked_centroids`` (``percentiles`` past
    ``PCT_RAW_MAX`` values: a float64 sort and pairwise sums over 1,024
    rank bins) over every live doc's ``fare``.  CUDA-event ms per call
    and device ms (every kernel of the call under the profiler); bound
    from bytes (the column and its docs read once, the mask or the
    centroids written once)."""
    import torch

    from opensearch_tpu_torch.ops import aggs as agg_ops
    from opensearch_tpu_torch.ops import filters
    from opensearch_tpu_torch.search.aggs import PCT_CENTROIDS
    from opensearch_tpu_torch.testing.k1_sweep import device_ms

    price, tag = dseg.numeric["price"], dseg.ordinal["tag"]
    fare = dseg.numeric["fare"]
    n_pad = dseg.n_pad
    five = torch.tensor([0, 1, 2, 3, 4], dtype=torch.int32,
                        device=tag["ords"].device)
    live = torch.arange(n_pad, device=tag["ords"].device) < seg.n_docs
    calls = {
        "range_mask": (lambda: filters.range_mask(
            price["values"], price["value_docs"], 2000, 6000,
            include_lo=True, include_hi=False, n_pad=n_pad),
            price["values"].numel() * 12 + n_pad),
        "term_mask": (lambda: filters.term_mask(
            tag["ords"], tag["value_docs"], 0, n_pad=n_pad),
            tag["ords"].numel() * 8 + n_pad),
        "terms_mask": (lambda: filters.terms_mask(
            tag["ords"], tag["value_docs"], five, n_pad=n_pad),
            tag["ords"].numel() * 8 + n_pad + 20),
        "masked_centroids": (lambda: agg_ops.masked_centroids(
            fare["values"], fare["value_docs"], live, n_cent=PCT_CENTROIDS),
            fare["values"].numel() * 12 + n_pad + 16 * PCT_CENTROIDS)}
    out = {}
    for name, (fn, nbytes) in calls.items():
        ms = cuda_ms(fn, 50)
        dev_ms = device_ms(fn, 20)
        bms, by = bound_ms(nbytes, 0.0)
        out[name] = {"ms": ms, "device_ms": dev_ms, "bound_ms": bms,
                     "bound_by": by, "bound_bytes": nbytes}
    log("filter masks and centroids on one segment of " + str(seg.n_docs)
        + " docs: "
        + "; ".join(f"{n} ms {r['ms']:.4f} device_ms {r['device_ms']} "
                    f"bound_ms {r['bound_ms']:.6f} ({r['bound_bytes']} "
                    f"bytes)" for n, r in out.items())
        + f"; the torch ops are their own plain version; on "
        f"{gpu_name_power()}")
    return out


# -- phase 4 ----------------------------------------------------------------

def build_scale():
    import torch

    from opensearch_tpu_torch.mapping.mapper import DocumentMapper
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing import corpus

    t0 = time.monotonic()
    raw = corpus.build_raw_corpus(SCALE_DOCS, seed=42)
    vecs = corpus.random_vectors(SCALE_DOCS, DIM, seed=43)
    segs = corpus.make_segments(
        raw, SCALE_SEGMENTS, vectors=vecs,
        columns={**scale_columns(), **corpus.relevance_columns(SCALE_DOCS)})
    mapper = DocumentMapper({"properties": {
        "body": {"type": "text"},
        "vec": {"type": "knn_vector", "dimension": DIM,
                "space_type": "l2"}, **corpus.COLUMNS_MAPPING,
        **corpus.RELEVANCE_MAPPING}})
    searcher = ShardSearcher(segs, mapper, index_name="scale",
                             device=DEVICE)
    # stage every segment and its impact column before any timing
    avgdl = searcher.ctx.field_stats("body").avgdl
    for seg in segs:
        seg.device(searcher.device).impacts("body", avgdl)
    torch.cuda.synchronize()
    log(f"scale corpus: {SCALE_DOCS} docs, {len(segs)} segments of "
        f"{segs[0].n_docs} docs, {len(raw['doc_ids'])} postings, "
        f"{DIM}-d f32 vectors; built and staged in "
        f"{time.monotonic() - t0:.1f}s")
    log(f"scale resident bytes on device: {searcher.resident_bytes()}")
    return segs, mapper, searcher, raw


def timed(searcher, bodies) -> tuple:
    """(qps, p50 ms) of ``bodies`` searched one after another; every hit
    list must be at most ``size`` long with finite scores, and most
    queries must find something (a zipf tail pair may match nothing)."""
    lat = []
    answered = 0
    t0 = time.monotonic()
    for body in bodies:
        t = time.monotonic()
        resp = searcher.search(body)
        lat.append((time.monotonic() - t) * 1e3)
        hits = resp["hits"]["hits"]
        if len(hits) > body["size"] or \
                not all(np.isfinite(h["_score"]) for h in hits):
            raise AssertionError(f"bad hits for {json.dumps(body)[:80]}")
        answered += bool(hits)
    wall = time.monotonic() - t0
    if answered < 0.9 * len(bodies):
        raise AssertionError(f"only {answered} of {len(bodies)} queries "
                             "found hits")
    return len(bodies) / wall, float(np.median(lat))


def phase_scale(segs, mapper, searcher):
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing import corpus
    from opensearch_tpu_torch.testing.parity import (bm25_mismatch,
                                                     knn_mismatch)

    rng = np.random.default_rng(44)

    def match_bodies(n, seed):
        return [{"query": {"match": {"body": f"t{a} t{b}"}}, "size": 10,
                 "_source": False}
                for a, b in corpus.zipf_query_log(n, seed=seed)]

    def knn_bodies(n):
        return [{"query": {"knn": {"vec": {
            "vector": rng.standard_normal(DIM).astype(np.float32).tolist(),
            "k": 10}}}, "size": 10, "_source": False} for _ in range(n)]

    timed(searcher, match_bodies(20, seed=8))          # warm-up
    timed(searcher, knn_bodies(5))
    match_qs, knn_qs = match_bodies(200, seed=7), knn_bodies(100)
    from opensearch_tpu_torch.ops import cuda_bm25, cuda_knn, cuda_plan
    counters = {"knn_topk": cuda_knn.knn_topk_segments_cuda,
                "knn_scores": cuda_knn.knn_scores_segments_cuda,
                "term_bag": cuda_bm25.dense_f32,
                "term_bag_topk": cuda_bm25.term_bag_topk_segments_cuda,
                "plan_topk": cuda_plan.plan_topk_segments_cuda}

    def counts():
        return {name: fn.launches for name, fn in counters.items()}

    c0 = counts()
    m_qps, m_p50 = timed(searcher, match_qs)
    c1 = counts()
    k_qps, k_p50 = timed(searcher, knn_qs)
    c2 = counts()
    per_query = {}
    for name in counters:
        per_query[f"match_{name}"] = (c1[name] - c0[name]) / len(match_qs)
        per_query[f"knn_{name}"] = (c2[name] - c1[name]) / len(knn_qs)
    if per_query["knn_knn_topk"] != 1.0 or per_query["knn_knn_scores"] \
            or per_query["knn_plan_topk"] != 1.0:
        raise AssertionError(f"a knn query must make exactly one K1 "
                             f"launch and one plan top-k: {per_query}")
    if per_query["match_term_bag_topk"] != 1.0 or \
            per_query["match_term_bag"] or per_query["match_plan_topk"]:
        raise AssertionError(f"a match query must make exactly one K2 "
                             f"top-k launch and no per-slot one: "
                             f"{per_query}")
    gpu = gpu_name_power()
    log(f"scale match: {len(match_qs)} queries, qps {m_qps:.2f}, p50 "
        f"{m_p50:.3f} ms on {gpu}")
    log(f"scale knn: {len(knn_qs)} queries (k=10), qps {k_qps:.2f}, p50 "
        f"{k_p50:.3f} ms on {gpu}")
    # a sample against the same segments on the CPU (plain versions)
    cpu = ShardSearcher(segs, mapper, index_name="scale", device="cpu")
    for body in match_qs[:5]:
        bad = bm25_mismatch(searcher.search(body), cpu.search(body))
        if bad:
            raise AssertionError(f"scale match vs cpu: {bad}")
    for body in knn_qs[:3]:
        bad = knn_mismatch(searcher.search(body), cpu.search(body))
        if bad:
            raise AssertionError(f"scale knn vs cpu: {bad}")
    log("scale sample: 5 match queries byte-equal and 3 knn queries "
        "within tolerance of the CPU searcher")
    log("scale launches per query: match "
        f"{per_query['match_term_bag_topk']:.2f} K2 top-k (was 32 per-slot "
        f"launches) + {per_query['match_term_bag']:.2f} K2 per-slot + "
        f"{per_query['match_knn_topk']:.2f} K1; knn "
        f"{per_query['knn_knn_topk']:.2f} K1 (was 16, one per segment) + "
        f"{per_query['knn_plan_topk']:.2f} plan top-k (was 16 sorts) + "
        f"{per_query['knn_knn_scores']:.2f} K1 scores-only + "
        f"{per_query['knn_term_bag']:.2f} K2 per-slot + "
        f"{per_query['knn_term_bag_topk']:.2f} K2 top-k")
    return {"match_qps": m_qps, "match_p50_ms": m_p50, "knn_qps": k_qps,
            "knn_p50_ms": k_p50, "launches_per_query": per_query}


# -- phases 5 and 6 ----------------------------------------------------------

def strip_took(resp: dict) -> str:
    return json.dumps({key: v for key, v in resp.items() if key != "took"},
                      sort_keys=True)


def phase_msearch(searcher, bodies, counters) -> dict:
    """The 256 ``match`` queries through ``ShardSearcher.msearch`` in 4
    batches of 64 (the batch path's first run: every group assembled,
    one K3 launch each), then again (group inputs cached), against the
    same queries through ``search`` one after another (after a warm-up
    pass).  Every response must equal the sequential one, each batch
    make one K3 launch and no K2 one, and batched qps reach 0.8 x
    sequential qps."""
    for body in bodies:                        # warm: plans, inputs
        searcher.search(body)
    t0 = time.monotonic()
    seq = [strip_took(searcher.search(body)) for body in bodies]
    seq_s = time.monotonic() - t0
    n_batches = len(bodies) // 64
    for fn in counters.values():               # the batched path starts
        fn.launches = 0
    t0 = time.monotonic()
    out = []
    for i in range(n_batches):
        out += searcher.msearch(bodies[64 * i: 64 * (i + 1)])
    cold_s = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    t0 = time.monotonic()
    warm = []
    for i in range(n_batches):
        warm += searcher.msearch(bodies[64 * i: 64 * (i + 1)])
    warm_s = time.monotonic() - t0
    per_batch = launches["batch_topk"] / n_batches
    if per_batch != 1.0 or launches["term_bag_topk"] or \
            launches["term_bag_scores"]:
        raise AssertionError(f"an msearch batch must make exactly one K3 "
                             f"launch and no K2 one: {launches}")
    bad = [i for i, r in enumerate(out + warm)
           if strip_took(r) != seq[i % len(bodies)]]
    if bad:
        raise AssertionError(f"msearch responses {bad[:5]} differ from "
                             "sequential search")
    seq_qps = len(bodies) / seq_s
    qps, warm_qps = len(bodies) / cold_s, len(bodies) / warm_s
    if qps < 0.8 * seq_qps:
        raise AssertionError(f"batched qps {qps:.1f} below 0.8 x "
                             f"sequential {seq_qps:.1f}")
    log(f"msearch: {len(bodies)} match queries in {n_batches} batches of "
        f"64, every response equal to sequential search; qps {qps:.2f} "
        f"(group inputs assembled) / {warm_qps:.2f} (cached) against "
        f"sequential {seq_qps:.2f}; launches per batch {per_batch:.2f} K3, "
        f"{launches['term_bag_topk'] / n_batches:.2f} K2 top-k, "
        f"{launches['term_bag_scores'] / n_batches:.2f} K2 per-slot on "
        f"{gpu_name_power()}")
    return {"qps": qps, "qps_cached": warm_qps, "seq_qps": seq_qps,
            "k3_launches_per_batch": per_batch, "launches": launches,
            "seq": seq}


def phase_continuous(searcher, bodies, seq, counters,
                     concurrency: int = 16) -> dict:
    """``concurrency`` client threads send the same queries as single
    searches through ``query_engine().execute(..., service=shim)``, the
    continuous batcher on with a 4 ms window and batches of at most 64:
    fewer than one dispatch per query (the reference bench's bar), every
    response equal to sequential search; qps, p50 and p99 latency.  Then
    the same threads with the batcher off, for the qps and latency that
    the batcher is held against."""
    import threading

    from opensearch_tpu_torch.search import engine as engine_mod

    class Shim:
        """Service shim: a bare searcher behind the engine, no mesh."""

        @staticmethod
        def _use_mesh(body):
            return False

    eng = engine_mod.query_engine()
    n = len(bodies)

    def drive() -> tuple:
        results = [None] * n
        lat = [0.0] * n
        errors = []

        def client(t):
            try:
                for i in range(t, n, concurrency):
                    t1 = time.monotonic()
                    results[i] = eng.execute(searcher, dict(bodies[i]),
                                             service=Shim())
                    lat[i] = (time.monotonic() - t1) * 1e3
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(t,),
                                    name=f"smoke-client-{t}", daemon=True)
                   for t in range(concurrency)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        wall = time.monotonic() - t0
        if any(t.is_alive() for t in threads):
            raise AssertionError("a continuous-batching client hung")
        if errors:
            raise errors[0]
        bad = [i for i, r in enumerate(results) if strip_took(r) != seq[i]]
        if bad:
            raise AssertionError(f"responses {bad[:5]} of {concurrency} "
                                 "threads differ from sequential search")
        p50, p99 = (float(np.percentile(lat, q)) for q in (50, 99))
        return n / wall, p50, p99

    prev = (engine_mod.BATCHER_ENABLED, engine_mod.BATCHER_WINDOW_MS,
            engine_mod.BATCHER_MAX_BATCH)
    engine_mod.BATCHER_WINDOW_MS = 4.0
    engine_mod.BATCHER_MAX_BATCH = 64
    try:
        engine_mod.BATCHER_ENABLED = True
        s0 = eng.batcher.stats()
        for fn in counters.values():
            fn.launches = 0
        qps, p50, p99 = drive()
        launches = {name: fn.launches for name, fn in counters.items()}
        s1 = eng.batcher.stats()
        engine_mod.BATCHER_ENABLED = False
        off_qps, off_p50, off_p99 = drive()
    finally:
        (engine_mod.BATCHER_ENABLED, engine_mod.BATCHER_WINDOW_MS,
         engine_mod.BATCHER_MAX_BATCH) = prev
        eng.shutdown()
    batched = s1["batched"] - s0["batched"]
    groups = s1["dispatches"] - s0["dispatches"]
    bypass = s1["bypass"] - s0["bypass"]
    solo = n - batched - bypass
    per_query = (groups + solo + bypass) / n
    if per_query >= 1.0 or launches["batch_topk"] != groups:
        raise AssertionError(f"continuous batching: {per_query} dispatches "
                             f"per query, {groups} groups, {launches}")
    log(f"continuous: {n} searches from {concurrency} threads, window 4 ms: "
        f"{groups} groups ({batched} members, mean {batched / max(groups, 1):.2f}),"
        f" {solo} solo, {bypass} bypass; {per_query:.4f} dispatches per "
        f"query; qps {qps:.2f}, p50 {p50:.3f} ms, p99 {p99:.3f} ms; batcher "
        f"off: qps {off_qps:.2f}, p50 {off_p50:.3f} ms, p99 {off_p99:.3f} "
        f"ms; every response equal to sequential search on "
        f"{gpu_name_power()}")
    return {"dispatches_per_query": per_query, "groups": groups,
            "batched": batched, "solo": solo, "bypass": bypass,
            "qps": qps, "p50_ms": p50, "p99_ms": p99,
            "batcher_off": {"qps": off_qps, "p50_ms": off_p50,
                            "p99_ms": off_p99},
            "launches": launches}


# -- the quantized layout (K4): phase 2's checks and phase 7 ------------------

def build_quantized(raw, mapper, dtype: str) -> tuple:
    """The scale corpus ``raw`` in ``QUANT_SEGMENTS`` segments of 125,000
    docs (each at or above ``QUANTIZED_MIN_DOCS``, so the port quantizes
    them as the reference does) with ``dtype`` codes, their tables built
    on the host (timed) and staged on the card.  Returns ``(segments,
    searcher, stats)``."""
    import torch

    from opensearch_tpu_torch.index import codec
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing import corpus

    segs = corpus.make_segments(raw, QUANT_SEGMENTS, columns=scale_columns())
    searcher = ShardSearcher(segs, mapper, index_name=f"quant_{dtype}",
                             device=DEVICE)
    avgdl = searcher.ctx.field_stats("body").avgdl
    prev = codec.QUANTIZED_DTYPE
    codec.QUANTIZED_DTYPE = dtype
    try:
        t0 = time.monotonic()
        tables = [seg.quantized_table("body", avgdl) for seg in segs]
        quantize_s = time.monotonic() - t0
    finally:
        codec.QUANTIZED_DTYPE = prev
    for seg in segs:
        dseg = seg.device(searcher.device)
        if not dseg.quantized_mode:
            raise AssertionError(f"segment of {seg.n_docs} docs is not "
                                 "quantized")
        dseg.quantized("body", avgdl)
    torch.cuda.synchronize()
    stats = {key: sum(int(t.stats[key]) for t in tables)
             for key in ("terms", "postings", "exact_terms",
                         "exact_postings", "f32_bytes", "quant_bytes")}
    stats.update(dtype=dtype, width=[int(t.width) for t in tables],
                 segments=len(segs), docs_per_segment=segs[0].n_docs,
                 quantize_s=quantize_s)
    log(f"quantized {dtype}: {len(segs)} segments of {segs[0].n_docs} docs "
        f"quantized on the host in {quantize_s:.2f}s: {stats}")
    return segs, searcher, stats


def build_small_quantized(dtype: str) -> tuple:
    """A 20,000-doc corpus in 4 segments of 5,000 docs, under the
    reference's threshold but quantized all the same (``QUANTIZED_MODE``
    "on", as a user may set it) with ``dtype`` codes: K4 at another delta
    width (13 bits) than the scale shard's.  Returns ``(segments,
    searcher)``."""
    from opensearch_tpu_torch.index import codec
    from opensearch_tpu_torch.mapping.mapper import DocumentMapper
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing import corpus

    segs = corpus.make_segments(corpus.build_raw_corpus(20_000, seed=5), 4)
    mapper = DocumentMapper({"properties": {"body": {"type": "text"}}})
    prev = codec.QUANTIZED_MODE, codec.QUANTIZED_DTYPE
    codec.QUANTIZED_MODE, codec.QUANTIZED_DTYPE = "on", dtype
    try:
        searcher = ShardSearcher(segs, mapper, index_name=f"small_{dtype}",
                                 device=DEVICE)
        avgdl = searcher.ctx.field_stats("body").avgdl
        for seg in segs:
            dseg = seg.device(searcher.device)
            if not dseg.quantized_mode:
                raise AssertionError("QUANTIZED_MODE on did not quantize")
            dseg.quantized("body", avgdl)
    finally:
        codec.QUANTIZED_MODE, codec.QUANTIZED_DTYPE = prev
    return segs, searcher


def quantized_counters() -> dict:
    """K4's launch counters: its top-k entry and its per-slot entry."""
    from opensearch_tpu_torch.ops import cuda_bm25

    return {"term_bag_quantized_topk": cuda_bm25.term_bag_topk_quantized_cuda,
            "term_bag_quantized_scores": cuda_bm25.dense_quantized}


def phase_quantized_kernels(quant, f32_segs, f32_searcher, query_pairs):
    """K4 against its plain twin on the card, byte for byte: the top-k
    entry over the 8 quantized segments at every bag, mask and k the
    contract lists, with int8 and int16 codes, bags with and without
    guarded terms, a term some segments lack (their blocks have no slot),
    and over 4 small segments at another delta width; the
    per-slot entry on three bags; a mixed call over 2 quantized and 2 f32
    segments; and K4 against K2 over the same segments'
    ``dequantized()`` column staged as f32.  Then the top-k entry timed
    (one launch per query) on the median and the heaviest bag beside the
    plain twin, the library chain ``[torch.topk(zeros(
    n_pad).index_add_(dequantized ...), k) for each segment]``, K2 over
    the dequantized column and the bound."""
    import torch

    from opensearch_tpu_torch.index.segment import pad_pow2
    from opensearch_tpu_torch.ops import bm25, cuda_bm25
    from opensearch_tpu_torch.ops import quantized as qops

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(4321)
    fn = cuda_bm25.term_bag_topk_segments_cuda
    k4 = cuda_bm25.term_bag_topk_quantized_cuda
    qsegs, qsearcher, _stats = quant["int8"]
    avgdl = qsearcher.ctx.field_stats("body").avgdl

    def guarded(terms):
        for seg in qsegs:
            pf = seg.postings["body"]
            ex = np.diff(seg.quantized_table("body", avgdl).exact_offsets)
            if any(pf.term_id(t) >= 0 and ex[pf.term_id(t)] > 0
                   for t in terms):
                return True
        return False

    pf0 = qsegs[0].postings["body"]
    bags = [[f"t{a}", f"t{b}"] if a != b else [f"t{a}"]
            for a, b in query_pairs]
    by_size = sorted(bags, key=lambda t: df_sum(pf0, t))
    median_bag, heaviest_bag = by_size[len(by_size) // 2], by_size[-1]
    four_bag = by_size[len(by_size) // 4] + by_size[-2]
    coded = [b for b in by_size if not guarded(b)]
    unguarded_bag = coded[-1]
    # the median of the bags the parity guard left all quantized
    coded_bag = coded[len(coded) // 2]
    # the term of the first segment with the most postings there that
    # another segment lacks: that segment's blocks have no active slot
    present = [set(seg.postings["body"].terms) for seg in qsegs[1:]]
    absent_bag = [min((t for t in pf0.terms
                       if not all(t in p for p in present)),
                      key=lambda t: (-int(pf0.df[pf0.term_id(t)]), t))]

    median = topk_inputs(qsegs, qsearcher, match_query(median_bag))
    deleted = [seg._replace(live=seg.live & (torch.rand(
        seg.live.shape[0], device=dev, generator=gen) > 0.1))
        for seg in median]
    cases = {"median": (median, -np.inf),
             "heaviest": (topk_inputs(qsegs, qsearcher,
                                      match_query(heaviest_bag)),
                          -np.inf),
             "4-term": (topk_inputs(qsegs, qsearcher, match_query(four_bag)),
                        -np.inf),
             "and": (topk_inputs(qsegs, qsearcher,
                                match_query(heaviest_bag, operator="and")),
                     -np.inf),
             "deletes": (deleted, -np.inf),
             "unguarded": (topk_inputs(qsegs, qsearcher,
                                      match_query(unguarded_bag)), -np.inf),
             "code-dominated": (topk_inputs(qsegs, qsearcher,
                                           match_query(coded_bag)),
                                -np.inf),
             "absent from a segment": (topk_inputs(qsegs, qsearcher,
                                                  match_query(absent_bag)),
                                       -np.inf)}
    top = bm25.term_bag_topk_segments(median, k=100).numpy()[0]
    cut = float(np.float32(np.median(top[np.isfinite(top)])))
    cases["min_score"] = (median, cut)
    s16, q16, _st16 = quant["int16"]
    cases["int16 median"] = (topk_inputs(s16, q16, match_query(median_bag)),
                             -np.inf)
    cases["int16 heaviest"] = (topk_inputs(s16, q16,
                                           match_query(heaviest_bag)),
                               -np.inf)
    cases["int16 absent from a segment"] = (
        topk_inputs(s16, q16, match_query(absent_bag)), -np.inf)

    def exact_slots(inputs):
        return sum(int((seg.quant.slot_exact[seg.active] >= 0).sum())
                   for seg in inputs)

    if exact_slots(cases["heaviest"][0]) == 0 or \
            exact_slots(cases["unguarded"][0]) != 0 or \
            exact_slots(cases["code-dominated"][0]) != 0:
        raise AssertionError("K4 cases: need a bag with guarded terms and "
                             "bags without")
    if all(np.asarray(seg.active).any()
           for seg in cases["absent from a segment"][0]):
        raise AssertionError("K4 cases: need a segment with no active slot")
    # 4 small segments quantized at another width, int8 and int16
    small = {dtype: build_small_quantized(dtype)
             for dtype in ("int8", "int16")}
    s_pf0 = small["int8"][0][0].postings["body"]
    s_bags = sorted(bags, key=lambda t: df_sum(s_pf0, t))
    small_views = {}        # case -> (segments, avgdl) of its f32 view
    for dtype, (ssegs, ssearcher) in small.items():
        s_avgdl = ssearcher.ctx.field_stats("body").avgdl
        width = ssegs[0].quantized_table("body", s_avgdl).width
        if width == qsegs[0].quantized_table("body", avgdl).width:
            raise AssertionError("the small segments share the scale "
                                 "shard's width")
        for name, bag, extra in (
                ("median", s_bags[len(s_bags) // 2], {}),
                ("heaviest", s_bags[-1], {}),
                ("and", s_bags[-1], {"operator": "and"})):
            case = f"small {dtype} {name} (width {width})"
            cases[case] = (topk_inputs(ssegs, ssearcher,
                                       match_query(bag, **extra)), -np.inf)
            small_views[case] = (ssegs, s_avgdl)
    ks = (1, 10, 100, cuda_bm25.K_MAX, cuda_bm25.K_MAX + 1)
    for name, (inputs, ms) in cases.items():
        for k in ks:
            before = (k4.launches, fn.launches, fn.sorted_route_segments)
            got = fn(inputs, k=k, min_score=ms).numpy()
            ref = bm25.term_bag_topk_segments(inputs, k=k,
                                              min_score=ms).numpy()
            sorted_route = k > cuda_bm25.K_MAX
            moved = (k4.launches - before[0], fn.launches - before[1],
                     fn.sorted_route_segments - before[2])
            if moved != (int(not sorted_route), 0,
                         len(inputs) * sorted_route):
                raise AssertionError(f"K4 top-k {name} k={k}: launches "
                                     f"{moved}")
            for what, a, b in zip(("vals", "ids", "totals", "maxes"), got,
                                  ref):
                if a.tobytes() != b.tobytes():
                    raise AssertionError(
                        f"K4 top-k {name} k={k}: {what} differ from the "
                        "plain twin")
        log(f"K4 top-k {name} (min_score {ms}, {exact_slots(inputs)} "
            f"guarded slots): k {list(ks)} byte-equal to the plain twin "
            f"(vals, ids, totals, maxes); totals {int(ref[2].sum())}")

    # a mixed call: 2 quantized and 2 f32 segments, one launch of each
    f32_median = topk_inputs(f32_segs[:2], f32_searcher,
                             match_query(median_bag))
    mixed = [median[0], f32_median[0], median[1], f32_median[1]]
    for k in (10, cuda_bm25.K_MAX):
        before = (k4.launches, fn.launches)
        got = fn(mixed, k=k).numpy()
        ref = bm25.term_bag_topk_segments(mixed, k=k).numpy()
        if (k4.launches - before[0], fn.launches - before[1]) != (1, 1):
            raise AssertionError("mixed call: expected one K4 and one K2 "
                                 "launch")
        if any(a.tobytes() != b.tobytes() for a, b in zip(got, ref)):
            raise AssertionError(f"mixed call k={k} differs from the plain "
                                 "twin")
    log("K4 + K2 mixed call (2 quantized, 2 f32 segments): one launch of "
        "each, byte-equal to the plain twin at k 10 and K_MAX")

    # K4 against K2 over the same segments' dequantized column, staged
    # here only (the segments' own staging stays quantized)
    def as_f32(inputs, segs, avgdl=avgdl):
        out = []
        for inp, seg in zip(inputs, segs):
            pf = seg.postings["body"]
            qt = seg.quantized_table("body", avgdl)
            p_pad = pad_pow2(len(pf.doc_ids))
            ids = np.full(p_pad, seg.n_docs, np.int32)
            ids[: len(pf.doc_ids)] = pf.doc_ids
            deq = np.zeros(p_pad, np.float32)
            deq[: len(pf.doc_ids)] = qt.dequantized()
            out.append(inp._replace(doc_ids=torch.from_numpy(ids).to(dev),
                                    impacts=torch.from_numpy(deq).to(dev),
                                    quant=None))
        return out

    f32_views = {}
    for name in ("median", "heaviest", "and", "deletes", "min_score",
                 "code-dominated", "absent from a segment", *small_views):
        inputs, ms = cases[name]
        f32_views[name] = as_f32(inputs, *small_views.get(name, (qsegs,)))
        for k in (10, 100, cuda_bm25.K_MAX):
            a = fn(inputs, k=k, min_score=ms).numpy()
            b = fn(f32_views[name], k=k, min_score=ms).numpy()
            if any(x.tobytes() != y.tobytes() for x, y in zip(a, b)):
                raise AssertionError(f"K4 {name} k={k} differs from K2 over "
                                     "dequantized()")
    log(f"K4 byte-equal to K2 over the dequantized() column "
        f"({', '.join(f32_views)}; k 10, 100, K_MAX)")

    out = {}
    k = 10
    for name in ("median", "heaviest", "int16 median"):
        inputs = cases[name][0]
        views = f32_views.get(name) or as_f32(inputs, s16 if name.startswith(
            "int16") else qsegs)
        nbytes = 0.0
        ops = 0
        postings = 0
        exact_postings = 0
        for seg in inputs:
            q = seg.quant
            q_bytes = q.qvals.element_size()
            act = seg.active
            for (a, b), ex in zip(seg.rows[act], q.slot_exact[act]):
                n = int(b - a)
                postings += n
                exact_postings += n * int(ex >= 0)
                nbytes += n * (q.width / 8 + (4 if ex >= 0 else q_bytes))
                ops += n * (3 if ex >= 0 else 4)
            nbytes += seg.live.shape[0] + 8 * k + 8

        def lib_chain(views=views):
            for seg in views:
                acc = torch.zeros(seg.live.shape[0], dtype=torch.float32,
                                  device=dev)
                for (a, b), act, idf_v, w in zip(seg.rows, seg.active,
                                                 seg.idfs, seg.weights):
                    if act:
                        acc.index_add_(0, seg.doc_ids[a:b],
                                       seg.impacts[a:b] * float(idf_v),
                                       alpha=float(w))
                torch.topk(acc, k)

        ms, plain_ms = in_turns(
            lambda: fn(inputs, k=k),
            lambda: bm25.term_bag_topk_segments(inputs, k=k), 10)
        lib_ms = cuda_ms(lib_chain, 10)
        dev_ms = kernel_device_ms(lambda: fn(inputs, k=k), 20,
                                  "quant_topk_kernel")
        k2_ms = kernel_device_ms(lambda: fn(views, k=k), 20, "F32Rows")
        bms, by = bound_ms(nbytes, float(ops))
        bag = heaviest_bag if name == "heaviest" else median_bag
        log(f"K4 top-k {name} bag {bag} k={k} over {len(inputs)} quantized "
            f"segments ({postings} postings, {exact_postings} of guarded "
            f"terms), one launch per query: ms {ms:.4f} device_ms {dev_ms} "
            f"plain_ms {plain_ms:.4f} library_ms(index_add_ of dequantized "
            f"+ topk chain) {lib_ms:.4f} K2-over-dequantized device_ms "
            f"{k2_ms} bound_ms {bms:.5f} ({by}: {nbytes:.0f} bytes) on "
            f"{gpu_name_power()}")
        out[name] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
                     "bound_bytes": nbytes, "k2_dequantized_device_ms": k2_ms,
                     "bag": bag, "postings": postings,
                     "exact_postings": exact_postings}
    del f32_views
    return {**out["median"], "max_abs_err": 0.0,
            "heaviest": out["heaviest"], "int16": out["int16 median"]}


def dense_work(bags, scores: bool = True) -> tuple:
    """(bytes, operations) one dense call over ``bags`` must do: per
    posting of an active slot its doc id (f32: 4 bytes; quantized: width
    / 8 of packed delta) and, with scores, its impact (f32 4 bytes, a
    guarded term's exact 4, else the 1- or 2-byte code) and 3 operations
    (4 with the dequantizing multiply); 16 bytes of table a slot; 4
    bytes a doc per column written."""
    nbytes = ops = 0.0
    for b in bags:
        nbytes += 4.0 * b.n_pad
        for j in np.flatnonzero(b.active):
            n = int(b.rows[j, 1] - b.rows[j, 0])
            nbytes += 16
            if b.quant is None:
                nbytes += n * (8 if scores else 4)
                ops += 3 * n if scores else 0
                continue
            exact = b.quant.slot_exact[j] >= 0
            nbytes += n * b.quant.width / 8
            if scores:
                nbytes += n * (4 if exact else b.quant.qvals.element_size())
                ops += n * (3 if exact else 4)
    return nbytes, ops


def phase_fold(scale_segs, searcher, quant, bags) -> dict:
    """K2's and K4's dense (per-slot) entry, one launch over a table of
    every segment of a request per row layout (``term_bag_dense_kernel``),
    against its plain twins on the card, byte for byte, in every mode the
    paths call: scores (``match`` fast path), scores and counts (``and``,
    minimum_should_match), counts only (filter bags, ``postings_mask``);
    f32 over the 16 scale segments, int8 and int16 over the 8 quantized
    ones, and 2 f32 with 2 int8 segments in one call; the median bag, the
    heaviest bag and the 25-term code-heavy bag.  Each call must make
    exactly one launch per row layout.  Then timed at the median bag
    (scores only, as ``bool`` calls it) over the 16 f32 segments and over
    the 8 int8 ones, in turns with its plain twin, beside the per-segment
    kernel it replaced (``testing/k2_sweep.py`` ``OldFold``, one launch a
    segment) and the ``index_add_`` chain."""
    import torch

    from opensearch_tpu_torch.ops import bm25, cuda_bm25
    from opensearch_tpu_torch.testing.k2_sweep import (MODES, OldFold,
                                                       dense_bags, same)

    dev = torch.device(DEVICE)
    f32_fn, q_fn = cuda_bm25.dense_f32, cuda_bm25.dense_quantized

    def call(bg, sc, cn, want):
        before = (f32_fn.launches, q_fn.launches)
        out = cuda_bm25.term_bag_dense_cuda(bg, scores=sc, counts=cn)
        made = (f32_fn.launches - before[0], q_fn.launches - before[1])
        if made != want:
            raise AssertionError(f"a dense call made {made} (f32, "
                                 f"quantized) launches, not {want}")
        return out

    layouts = {"f32": searcher, "int8": quant["int8"][1],
               "int16": quant["int16"][1]}
    checked = {}
    for layout, srch in layouts.items():
        want = (1, 0) if layout == "f32" else (0, 1)
        for name, terms in bags.items():
            bg = dense_bags(srch, terms)
            for sc, cn in MODES:
                got = call(bg, sc, cn, want)
                torch.cuda.synchronize()
                if not same(got, bm25.term_bag_dense(bg, scores=sc,
                                                     counts=cn)):
                    raise AssertionError(f"the dense entry differs from its "
                                         f"plain twin: {layout} {name} "
                                         f"{terms} scores={sc} counts={cn}")
            checked.setdefault(layout, []).append(name)
            postings = sum(int((b.rows[b.active, 1] - b.rows[b.active, 0])
                               .sum()) for b in bg)
            log(f"K2/K4 dense entry {layout} {name} bag of {len(terms)} "
                f"terms ({postings} postings over {len(bg)} segments): "
                f"scores, scores + counts, counts only byte-equal to the "
                f"plain twins, one launch per call")
    # filter context (an unscored bag: the f32 columns; on the quantized
    # shards phase 10 stages them on demand) and a mixed call: 2 f32 + 2
    # int8 segments
    for name, terms in bags.items():
        bg = dense_bags(searcher, terms, scored=False)
        if not same(call(bg, False, True, (1, 0)), bm25.term_bag_dense(
                bg, scores=False, counts=True)):
            raise AssertionError(f"the dense entry differs from its plain "
                                 f"twin: filter bag {name}")
    mixed = dense_bags(searcher, bags["median"])[:2] + dense_bags(
        layouts["int8"], bags["median"])[:2]
    for sc, cn in MODES:
        if not same(call(mixed, sc, cn, (1, 1)), bm25.term_bag_dense(
                mixed, scores=sc, counts=cn)):
            raise AssertionError("the dense entry differs from its plain "
                                 "twin on a mixed call")
    log("K2/K4 dense entry: the filter-context bags and a call over 2 f32 "
        "+ 2 int8 segments (one launch each layout) byte-equal to the plain "
        "twins")

    gpu = gpu_name_power()

    def timed(bg, lib_rows):
        def dense():
            return cuda_bm25.term_bag_dense_cuda(bg, scores=True,
                                                 counts=False)

        def plain():
            return bm25.term_bag_dense(bg, scores=True, counts=False)

        old = OldFold(bg, True, False)

        def lib_chain():
            for b, (docs, vals) in zip(bg, lib_rows):
                acc = torch.zeros(b.n_pad, dtype=torch.float32, device=dev)
                for j in np.flatnonzero(b.active):
                    st, e = int(b.rows[j, 0]), int(b.rows[j, 1])
                    acc.index_add_(0, docs[st:e],
                                   vals[st:e] * float(b.idfs[j]),
                                   alpha=float(b.weights[j]))

        ms, plain_ms = in_turns(dense, plain, 10)
        old_ms = cuda_ms(old, 10)
        lib_ms = cuda_ms(lib_chain, 10)
        dev_ms = kernel_device_ms(dense, 10, "term_bag_dense_kernel")
        old_dev = kernel_device_ms(old, 5, "term_bag_fold_kernel")
        if dev_ms is None or old_dev is None:
            raise AssertionError("the profiler shows no dense kernel")
        nbytes, ops = dense_work(bg)
        bms, by = bound_ms(nbytes, ops)
        postings = sum(int((b.rows[b.active, 1] - b.rows[b.active, 0])
                           .sum()) for b in bg)
        return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
                "bound_bytes": nbytes, "replaced_ms": old_ms,
                "replaced_device_ms": old_dev * len(bg),
                "replaced_launches": len(bg), "max_abs_err": 0.0,
                "bag": bags["median"], "segments": len(bg),
                "postings": postings, "launches_per_call": 1,
                "checked": checked}

    # the median bag over the 16 f32 segments (one launch)
    f32_bags = dense_bags(searcher, bags["median"])
    f32_row = timed(f32_bags, [(b.doc_ids, b.impacts) for b in f32_bags])
    # over the 8 int8 segments, the chain over their dequantized columns
    qsegs, qsearcher, _stats = quant["int8"]
    q_bags = dense_bags(qsearcher, bags["median"])
    avgdl = qsearcher.ctx.field_stats("body").avgdl
    q_rows = []
    for seg in qsegs:
        pf = seg.postings["body"]
        n = len(pf.doc_ids)
        q_rows.append((torch.from_numpy(pf.doc_ids.astype(np.int32)).to(dev),
                       torch.from_numpy(seg.quantized_table(
                           "body", avgdl).dequantized()[:n]).to(dev)))
    q_row = timed(q_bags, q_rows)
    for what, row in (("K2 dense entry, f32", f32_row),
                      ("K4 dense entry, int8", q_row)):
        log(f"{what}, median bag {row['bag']} over {row['segments']} "
            f"segments in one launch ({row['postings']} postings), scores "
            f"only: ms {row['ms']:.4f} device_ms {row['device_ms']:.5f} "
            f"plain_ms {row['plain_ms']:.4f} library_ms(index_add_ chain) "
            f"{row['library_ms']:.4f} bound_ms {row['bound_ms']:.5f} "
            f"({row['bound_by']}: {row['bound_bytes']:.0f} bytes); the "
            f"replaced per-segment kernel ({row['replaced_launches']} "
            f"launches): ms {row['replaced_ms']:.4f} device_ms "
            f"{row['replaced_device_ms']:.5f}; on {gpu}")
    return {"term_bag_scores": f32_row, "term_bag_quantized_scores": q_row}


def plan_topk_cases(dev, gen) -> list:
    """``(name, entries, k list)`` of the plan top-k's edge cases on the
    card: ties, negative scores, -0.0 (every zero score spelled so, as a
    negative boost makes it), no match, fewer matches than k, k = n_pad,
    no live mask, ragged segments across tile bounds."""
    import torch

    from opensearch_tpu_torch.ops import bm25

    def entry(n, *, p_match=0.5, negative=False, neg_zero=False,
              live=True):
        s = torch.randint(0, 6, (n,), generator=gen).to(torch.float32) * 0.5
        if negative:
            s = torch.where(torch.rand(n, generator=gen) < 0.5, -s, s)
        if neg_zero:
            s = torch.where(s == 0, -0.0, -s)
        m = torch.rand(n, generator=gen) < p_match
        lv = torch.rand(n, generator=gen) < 0.9
        return bm25.PlanScores(s.to(dev), m.to(dev),
                               lv.to(dev) if live else None)

    return [("ties", [entry(n) for n in (1, 4095, 4096, 4097, 100_000)],
             (1, 10, 100, 256)),
            ("negative", [entry(n, negative=True) for n in (65536, 300)],
             (10, 256)),
            ("neg_zero", [entry(n, neg_zero=True) for n in (65536, 64)],
             (10, 100)),
            ("no_match", [entry(9000, p_match=0.0), entry(500)], (10,)),
            ("few", [entry(70_000, p_match=0.0002), entry(8)], (100, 256)),
            ("k_n_pad", [entry(256, p_match=0.95), entry(256)], (256,)),
            ("no_live", [entry(n, live=False) for n in (333, 8200)],
             (10, 100))]


def plan_topk_equal(got, want) -> bool:
    gv, gi, gt, gm = got.numpy()
    wv, wi, wt, wm = want.numpy()
    keep = wv > -np.inf
    return (gv.tobytes() == wv.tobytes() and (gi[keep] == wi[keep]).all()
            and gt.tobytes() == wt.tobytes() and gm.tobytes() == wm.tobytes())


def phase_plan_topk(scale_segs, searcher, gen) -> dict:
    """The plan top-k (``csrc/plan_topk.cu``, one launch over every
    segment) against ``plan_topk_segments`` (each segment's stable sort,
    ``plan_segment_topk``) on the card: values byte for byte,
    ids where the value is above -inf, totals and maxes, at k = 10, 100
    and 256 on phase 10's first ``bool`` request over the 16 scale
    segments (its plan's scores, matched and live masks), with and
    without ``min_score``, and on the edge cases of ``plan_topk_cases``;
    k = K_MAX + 1 takes the sort and is counted as such.  Then timed over
    the 16 x 65,536 docs at k = 10 in turns with the plain version,
    beside ``[torch.topk(where(m & live, s, -inf), k) for each segment]``."""
    import torch

    from opensearch_tpu_torch.ops import bm25, cuda_plan
    from opensearch_tpu_torch.search import plan as P
    from opensearch_tpu_torch.search.executor import build_arrays

    dev = torch.device(DEVICE)
    kernel = cuda_plan.plan_topk_segments_cuda
    body = phase10_bodies()["bool"][0]
    plan, bind = searcher.compiled(body["query"])
    items = []
    for seg in scale_segs:
        dseg = seg.device(dev)
        dims, ins = plan.prepare(bind, seg, dseg, searcher.ctx)
        A = build_arrays(dseg, plan.arrays(), searcher.mapper,
                         live=searcher.ctx.live_mask(seg, dseg),
                         partial_ok=plan.skip_arrays(dims))
        items.append((A, dims, ins))
    P.dense_prepass(plan, items)
    entries = [bm25.PlanScores(*plan.eval(A, dims, ins), A["live"])
               for A, dims, ins in items]
    cases = [("bool", entries, (10, 100, 256))] + plan_topk_cases(dev, gen)
    n_checks = 0
    for name, ents, ks in cases:
        for k in ks:
            for ms in (-np.inf, 1.0):
                before = kernel.launches
                got = bm25.plan_topk_segments_auto(ents, k=k, min_score=ms)
                if kernel.launches - before != 1:
                    raise AssertionError("a plan top-k call made "
                                         f"{kernel.launches - before} "
                                         "launches")
                if not plan_topk_equal(got, bm25.plan_topk_segments(
                        ents, k=k, min_score=ms)):
                    raise AssertionError(f"plan top-k {name} k={k} "
                                         f"min_score={ms} differs from the "
                                         "plain version")
                n_checks += 1
    before = kernel.sorted_route_segments
    if not plan_topk_equal(bm25.plan_topk_segments_auto(
            entries, k=cuda_plan.K_MAX + 1), bm25.plan_topk_segments(
            entries, k=cuda_plan.K_MAX + 1)) or \
            kernel.sorted_route_segments - before != len(entries):
        raise AssertionError("plan top-k above K_MAX: the sorted route")
    log(f"plan top-k: {n_checks} calls equal to the plain version (the bool "
        f"request over 16 segments at k = 10, 100, 256 and "
        f"{[c[0] for c in cases[1:]]}), one launch each; k = K_MAX + 1 "
        f"sorted ({len(entries)} segments)")

    # timed at 16 x 65,536 (the bool request's columns), k = 10
    k = 10

    def kern():
        return bm25.plan_topk_segments_auto(entries, k=k)

    def plain():
        return bm25.plan_topk_segments(entries, k=k)

    def library():
        return [torch.topk(torch.where(e.matched & e.live, e.scores,
                                       -torch.inf), k) for e in entries]

    ms, plain_ms = in_turns(kern, plain, 20)
    lib_ms = cuda_ms(library, 20)
    dev_ms = kernel_device_ms(kern, 20, "plan_topk_kernel")
    if dev_ms is None:
        raise AssertionError("the profiler shows no plan top-k kernel")
    docs = sum(e.scores.shape[0] for e in entries)
    nbytes = 6.0 * docs + len(entries) * (8 * k + 8)
    bms, by = bound_ms(nbytes, 0.0)
    row = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
           "bound_bytes": nbytes, "max_abs_err": 0.0, "k": k,
           "segments": len(entries), "docs": docs, "checks": n_checks}
    log(f"plan top-k over {len(entries)} segments ({docs} docs) in one "
        f"launch, k = {k}: ms {ms:.4f} device_ms {dev_ms:.5f} plain_ms "
        f"(stable sort per segment) {plain_ms:.4f} library_ms "
        f"([torch.topk(where(m & live, s, -inf), k)]) {lib_ms:.4f} "
        f"bound_ms {bms:.5f} ({by}: {nbytes:.0f} bytes); on "
        f"{gpu_name_power()}")
    return row


def positional_bytes(leaves) -> float:
    """Bytes K8 / K9 must move for ``leaves`` (``PositionalLeaf`` jobs):
    per job, each distinct slot row's doc ids and position offsets (4 + 4
    bytes an entry) and its positions (4 bytes each) read once, each
    anchor doc's length (4 bytes) read once, and its [n_pad] scores and
    matched (4 + 1 bytes a doc) written once."""
    total = 0.0
    for leaf in leaves:
        po = leaf.cols.pos_offsets
        total += 5.0 * leaf.n_pad + 4.0 * leaf.slots.n_anchor
        for e0, e1 in {tuple(int(x) for x in r) for r in leaf.slots.rows}:
            if e1 > e0:
                total += 8.0 * (e1 - e0) + 4.0 * (int(po[e1]) - int(po[e0]))
    return total


def phase_positions(scale_segs) -> dict:
    """K8 (``phrase_scores_cuda``) and K9 (``span_scores_cuda``,
    ``csrc/positions.cu``) against the request-wide plain entries
    (``ops.phrase.phrase_scores``, ``ops.span.span_scores``) on the card:
    scores and matched masks byte for byte and equal launch to launch, one
    launch a call with work.  Each set of ``testing/positions.py`` (2-6
    and 12 slots, stopword holes, duplicated terms, a missing and a
    one-posting term, a slot filling its bucket exactly, positions just
    below 2^22, a doc of 6,000 positions of the anchor; ordered,
    unordered and ``end`` spans, the full-bucket trap) is one call of all
    its cases, scored, with its first case again unscored.  Over the 16
    scale segments: each phrase and span case as one call of its 16 jobs
    (the heaviest phrase "t0 t0", "t0 t0 t0", 2-, 3- and 5-term phrases
    of ``phrase_query_log``, a phrase with a term some segments lack;
    ordered / unordered / ``end`` spans), then every phrase case in one
    call, and every span case.  Then each kernel timed at its heaviest
    case over one segment and over the 16 in one launch, in turns with
    its plain version (CUDA-event ms a call, profiler device ms), with its
    bound; no single PyTorch call computes either function."""
    import torch

    from opensearch_tpu_torch.index.segment import pad_pow2
    from opensearch_tpu_torch.ops import cuda_positions
    from opensearch_tpu_torch.ops import phrase as P
    from opensearch_tpu_torch.ops import span as S
    from opensearch_tpu_torch.search.compiler import _SPAN_NO_END
    from opensearch_tpu_torch.testing import corpus, positions

    dev = torch.device(DEVICE)
    kernels = {"phrase_freqs": (cuda_positions.phrase_scores_cuda,
                                P.phrase_scores),
               "span_near": (cuda_positions.span_scores_cuda,
                             S.span_scores)}
    checks = {"phrase_freqs": 0, "span_near": 0}
    weight = float(np.float32(3.7))

    def held(name, leaves, what):
        kernel, plain = kernels[name]
        before = kernel.launches
        got, again, want = kernel(leaves), kernel(leaves), plain(leaves)
        launched = kernel.launches - before
        work = any(cuda_positions._has_work(leaf, name == "span_near")
                   for leaf in leaves)
        if launched != 2 * work:
            raise AssertionError(f"{name} {what}: {launched} launches for "
                                 "two calls")
        matched = 0
        for (gs, gm), (as_, am), (ws, wm) in zip(got, again, want):
            if not (torch.equal(gs.view(torch.int32), ws.view(torch.int32))
                    and torch.equal(gm, wm)
                    and torch.equal(as_.view(torch.int32),
                                    gs.view(torch.int32))
                    and torch.equal(am, gm)):
                raise AssertionError(f"{name} {what}: differs from its "
                                     "plain version or from launch to "
                                     "launch")
            matched += int(wm.sum().item())
        checks[name] += len(leaves)
        return matched

    def avgdl(pf):
        return float(np.float32(np.mean(pf.doc_lens)))

    def phrase_leaf(pf, cols, n_pad, terms, offs, scored=True):
        return P.PositionalLeaf(cols, P.phrase_slots(pf, terms, offs),
                                n_pad, weight, avgdl(pf), scored)

    def span_leaf(pf, cols, n_pad, terms, ordered, slop, end, scored=True):
        return P.PositionalLeaf(cols, S.span_slots(pf, terms), n_pad,
                                weight, avgdl(pf), scored, ordered, slop,
                                end)

    def staged(pf):
        return P.stage_host_positions(pf, dev), pad_pow2(len(pf.doc_lens) + 1)

    t0 = time.monotonic()
    for name, pf, cases in positions.phrase_sets():
        cols, n_pad = staged(pf)
        leaves = [phrase_leaf(pf, cols, n_pad, terms, offs)
                  for terms, offs in cases]
        leaves.append(phrase_leaf(pf, cols, n_pad, *cases[0], scored=False))
        held("phrase_freqs", leaves, f"set {name}")
    for name, pf, cases in positions.span_sets():
        cols, n_pad = staged(pf)
        leaves = [span_leaf(pf, cols, n_pad, *case) for case in cases]
        leaves.append(span_leaf(pf, cols, n_pad, *cases[0], scored=False))
        held("span_near", leaves, f"set {name}")
    small = dict(checks)

    # the scale shapes: every case over every one of the 16 segments
    runs = corpus.phrase_query_log(200, seed=41, n_docs=SCALE_DOCS)
    by_len = {n: [r for r in runs if len(r) == n][:2] for n in (2, 3, 5)}
    pfs = [seg.postings["body"] for seg in scale_segs]
    lacking = next(f"t{t}" for t in range(20_000, 30_000)
                   if 0 < sum(pf.term_id(f"t{t}") >= 0 for pf in pfs)
                   < len(pfs))
    phrases = [["t0", "t0"], ["t0", "t0", "t0"], ["t0", lacking],
               [lacking, "t1"]]
    phrases += [[f"t{t}" for t in r] for n in (2, 3, 5) for r in by_len[n]]
    spans = [(["t0", "t1"], True, 0, _SPAN_NO_END),
             (["t0", "t2", "t1"], True, 3, _SPAN_NO_END),
             (["t0", "t1"], False, 2, _SPAN_NO_END),
             (["t0", "t0"], False, 1, _SPAN_NO_END),
             (["t0"], True, 0, 5), (["t3", lacking], True, 1, _SPAN_NO_END)]
    for r in by_len[5]:
        terms, slop = corpus.span_clauses(r, 3)
        spans.append(([f"t{t}" for t in terms], True, slop, _SPAN_NO_END))
    # staged here, apart from the segments' views: those stage their
    # positions on phase 14's first phrase, so phases 3-13 run as before
    staged_segs = [(pf, *staged(pf)) for pf in pfs]
    matched = {}
    every_phrase, every_span = [], []
    for terms in phrases:
        key = " ".join(terms)
        leaves = [phrase_leaf(pf, cols, n_pad, terms,
                              list(range(len(terms))))
                  for pf, cols, n_pad in staged_segs]
        matched[key] = held("phrase_freqs", leaves, key)
        every_phrase += leaves
    for terms, ordered, slop, end in spans:
        key = f"span {terms} ordered={ordered} slop={slop} end={end}"
        leaves = [span_leaf(pf, cols, n_pad, terms, ordered, slop, end)
                  for pf, cols, n_pad in staged_segs]
        matched[key] = held("span_near", leaves, key)
        every_span += leaves
    held("phrase_freqs", every_phrase, "every phrase case in one call")
    held("span_near", every_span, "every span case in one call")
    pf0 = pfs[0]
    tid = pf0.term_id("t0")
    t0_positions = [int(pf.pos_offsets[pf.offsets[pf.term_id("t0") + 1]]
                        - pf.pos_offsets[pf.offsets[pf.term_id("t0")]])
                    for pf in pfs]
    log(f"K8 / K9: {small['phrase_freqs']} phrase and "
        f"{small['span_near']} span jobs of the CPU test's sets (a call a "
        f"set), then {checks['phrase_freqs'] - small['phrase_freqs']} "
        f"phrase and {checks['span_near'] - small['span_near']} span jobs "
        f"over the 16 scale segments, byte-equal to the plain versions and "
        f"launch to launch ({time.monotonic() - t0:.1f}s); t0 holds "
        f"{sum(t0_positions)} positions ({max(t0_positions)} in one "
        f"segment, {int(pf0.df[tid])} docs of segment 0); a phrase on "
        f"{lacking}, which {sum(pf.term_id(lacking) < 0 for pf in pfs)} "
        f"segments lack; matches per case: {matched}")

    rows = {}
    for name, kernel_name, make in (
            ("phrase_freqs", "phrase_scores_kernel",
             lambda pf, cols, n_pad: phrase_leaf(pf, cols, n_pad,
                                                 ["t0", "t0"], [0, 1])),
            ("span_near", "span_scores_kernel",
             lambda pf, cols, n_pad: span_leaf(pf, cols, n_pad,
                                               ["t0", "t1"], False, 2,
                                               _SPAN_NO_END))):
        kernel, plain = kernels[name]
        row = {"library_ms": None, "max_abs_err": 0.0,
               "checks": checks[name]}
        for label, segs_, reps in (("one", staged_segs[:1], 20),
                                   ("", staged_segs, 5)):
            leaves = [make(*s_) for s_ in segs_]
            ms, plain_ms = in_turns(lambda: kernel(leaves),
                                    lambda: plain(leaves), reps)
            dev_ms = kernel_device_ms(lambda: kernel(leaves), 20,
                                      kernel_name)
            if dev_ms is None:
                raise AssertionError(f"the profiler shows no {kernel_name}")
            nbytes = positional_bytes(leaves)
            bms, by = bound_ms(nbytes, 0.0)
            pre = f"{label}_segment_" if label else ""
            row.update({f"{pre}ms": ms, f"{pre}device_ms": dev_ms,
                        f"{pre}plain_ms": plain_ms, f"{pre}bound_ms": bms,
                        f"{pre}bound_bytes": nbytes,
                        f"{pre}anchor_entries": sum(
                            leaf.slots.n_anchor for leaf in leaves)})
            row["bound_by"] = by
        rows[name] = row
    median = [phrase_leaf(pf, cols, n_pad, [f"t{t}" for t in by_len[3][0]],
                          [0, 1, 2]) for pf, cols, n_pad in staged_segs]
    rows["phrase_freqs"]["median_3_term_ms"] = cuda_ms(
        lambda: kernels["phrase_freqs"][0](median), 20)
    for name, what in (("phrase_freqs", '"t0 t0"'),
                       ("span_near", "unordered [t0, t1] slop 2")):
        r = rows[name]
        for pre, where in (("", "the 16 scale segments in one launch"),
                           ("one_segment_", "one scale segment")):
            log(f"{name} over {where} ({what}, {r[pre + 'anchor_entries']} "
                f"anchor entries): ms {r[pre + 'ms']:.4f} device_ms "
                f"{r[pre + 'device_ms']:.5f} plain_ms "
                f"{r[pre + 'plain_ms']:.4f} bound_ms "
                f"{r[pre + 'bound_ms']:.5f} ({r['bound_by']}: "
                f"{r[pre + 'bound_bytes']:.0f} bytes); library_ms null (no "
                f"single PyTorch call computes per-doc phrase or span "
                f"scores); on {gpu_name_power()}")
    log(f"phrase_freqs on a 3-term phrase of the log over the 16 "
        f"segments: {rows['phrase_freqs']['median_3_term_ms']:.4f} ms a call")
    return rows


def phase_quantized_scale(segs, mapper, searcher, build, counters) -> dict:
    """Phase 7: the 200 zipf ``match`` queries of phase 4 through
    ``ShardSearcher.search`` over the 8 quantized segments (qps, p50;
    one K4 top-k launch and no per-slot launch per query), then a
    ``bool`` / ``constant_score`` / ``count`` / large-``size`` sample (the
    per-slot entries), a sample byte-equal to the CPU searcher, and the
    resident bytes against the f32 layout of the same segments."""
    import torch

    from opensearch_tpu_torch.common.errors import NotYetPortedError
    from opensearch_tpu_torch.index import codec
    from opensearch_tpu_torch.index.segment import DeviceSegment
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing import corpus
    from opensearch_tpu_torch.testing.parity import bm25_mismatch

    def match_bodies(n, seed):
        return [{"query": {"match": {"body": f"t{a} t{b}"}}, "size": 10,
                 "_source": False}
                for a, b in corpus.zipf_query_log(n, seed=seed)]

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in counters.items()}

    match_qs = match_bodies(200, seed=7)
    pairs = corpus.zipf_query_log(8, seed=21)
    sample = [
        {"query": {"bool": {"must": [{"match": {"body": f"t{a} t{b}"}}],
                            "should": [{"match": {"body": "t3"}}]}},
         "size": 10, "_source": False} for a, b in pairs[:3]] + [
        {"query": {"bool": {"must": [{"match": {"body": f"t{a}"}}],
                            "filter": [{"match": {"body": f"t{b}"}}]}},
         "size": 10, "_source": False} for a, b in pairs[3:5]] + [
        {"query": {"constant_score": {"filter": {"match": {
            "body": f"t{pairs[5][0]} t{pairs[5][1]}"}}, "boost": 2.0}},
         "size": 10, "_source": False},
        {"query": {"match": {"body": f"t{pairs[6][0]} t{pairs[6][1]}"}},
         "size": 300, "_source": False},
        {"query": {"match": {"body": f"t{pairs[7][0]} t{pairs[7][1]}"}},
         "size": 10, "track_total_hits": False, "_source": False}]
    count_qs = [{"match": {"body": f"t{a} t{b}"}} for a, b in pairs[:3]]
    try:
        timed(searcher, match_bodies(20, seed=8))          # warm-up
        zero()
        m_qps, m_p50 = timed(searcher, match_qs)
        match_launches = counts()
        resident = searcher.resident_bytes()
        zero()
        for body in sample:
            searcher.search(body)
        gpu_counts = [searcher.count(q) for q in count_qs]
        sample_launches = counts()
        cpu = ShardSearcher(segs, mapper, index_name="quant_int8",
                            device="cpu")
        for body in match_qs[:5] + sample:
            bad = bm25_mismatch(searcher.search(body), cpu.search(body))
            if bad:
                raise AssertionError(f"quantized scale vs cpu "
                                     f"{json.dumps(body)[:80]}: {bad}")
        if gpu_counts != [cpu.count(q) for q in count_qs]:
            raise AssertionError("quantized scale: counts differ from the "
                                 "CPU searcher")
    except NotYetPortedError as e:
        raise AssertionError(f"quantized scale refused a query: {e}") from e
    per_query = {n: c / len(match_qs) for n, c in match_launches.items()}
    if per_query["term_bag_quantized_topk"] != 1.0 or any(
            per_query[n] for n in per_query
            if n != "term_bag_quantized_topk"):
        raise AssertionError(f"a match query on quantized segments must "
                             f"make one K4 top-k launch and no other: "
                             f"{per_query}")
    if not sample_launches["term_bag_quantized_scores"] or \
            not sample_launches["term_bag_scores"]:
        raise AssertionError(f"the sample must run K4's and K2's per-slot "
                             f"entries: {sample_launches}")
    # the f32 layout of the same segments, staged and measured, then freed
    avgdl = searcher.ctx.field_stats("body").avgdl
    prev = codec.QUANTIZED_MODE
    codec.QUANTIZED_MODE = "off"
    try:
        f32_bytes = 0
        for seg in segs:
            dseg = DeviceSegment(seg, searcher.device)
            dseg.impacts("body", avgdl)
            f32_bytes += dseg.nbytes()
            del dseg
    finally:
        codec.QUANTIZED_MODE = prev
    torch.cuda.empty_cache()
    if resident >= f32_bytes:
        raise AssertionError(f"quantized resident bytes {resident} not below "
                             f"the f32 layout's {f32_bytes}")
    gpu = gpu_name_power()
    log(f"quantized scale: {build['segments']} segments of "
        f"{build['docs_per_segment']} docs ({build['dtype']}, quantized in "
        f"{build['quantize_s']:.2f}s on the host, {build['exact_terms']} "
        f"guarded terms holding {build['exact_postings']} of "
        f"{build['postings']} postings); {len(match_qs)} match queries, qps "
        f"{m_qps:.2f}, p50 {m_p50:.3f} ms on {gpu}")
    log(f"quantized scale launches per match query: "
        f"{per_query['term_bag_quantized_topk']:.2f} K4 top-k, "
        f"{per_query['term_bag_quantized_scores']:.2f} K4 per-slot, "
        f"{per_query['term_bag_topk']:.2f} K2 top-k, "
        f"{per_query['term_bag_scores']:.2f} K2 per-slot; sample "
        f"(bool / constant_score / count / size 300 / untracked totals) "
        f"launches {sample_launches}; 5 match queries, the sample and 3 "
        f"counts byte-equal to the CPU searcher")
    log(f"quantized scale resident bytes on device: {resident} (after the "
        f"match queries) against {f32_bytes} for the f32 layout of the same "
        f"segments (x{f32_bytes / resident:.3f}); tables "
        f"{build['quant_bytes']} quantized against {build['f32_bytes']} f32 "
        f"bytes (codec stats); "
        f"{searcher.resident_bytes()} after the sample (filters stage the "
        f"f32 columns on demand)")
    return {"match_qps": m_qps, "match_p50_ms": m_p50,
            "launches_per_query": per_query,
            "sample_launches": sample_launches,
            "resident_bytes": resident, "f32_layout_bytes": f32_bytes,
            "build": build,
            "k4_launches": {n: match_launches[n] + sample_launches[n]
                            for n in ("term_bag_quantized_topk",
                                      "term_bag_quantized_scores")}}


# -- phase 8 ----------------------------------------------------------------

WRITE_DOCS = 160_000             # phase 8: docs indexed through the engine
WRITE_BULK = 1_000               # docs per bulk, one fsync each
WRITE_REFRESH_EVERY = 16_000     # docs between refreshes: 10 NRT segments
WRITE_REPLAY_DOCS = 1_000        # indexed last, then replayed after a kill
WRITE_MAPPING = {"properties": {"body": {"type": "text"},
                                "tag": {"type": "keyword"}}}
WRITE_TAGS = ("red", "green", "blue", "gold", "grey")


def device_allocated() -> int:
    import torch
    return torch.cuda.memory_allocated()


class WriteState:
    """The last acked state of every doc phase 8 writes (None when
    deleted), and what was updated or deleted."""

    def __init__(self, texts):
        self.texts = texts
        self.docs: dict = {}
        self.updated: set = set()
        self.deleted: set = set()
        self.conflicts = 0

    def source(self, i: int) -> dict:
        return {"body": self.texts[i], "tag": WRITE_TAGS[i % 5]}

    def live(self) -> int:
        return sum(src is not None for src in self.docs.values())

    def check(self, engine, ids) -> int:
        """Realtime ``get`` of ``ids`` against the acked state; returns
        how many were read."""
        for doc in ids:
            got = engine.get(doc)
            want = self.docs[doc]
            if (got is None) != (want is None) or \
                    (got is not None and got["_source"] != want):
                raise AssertionError(f"write path: get [{doc}] returned "
                                     f"{str(got)[:80]}, acked "
                                     f"{str(want)[:80]}")
        return len(ids)

    def sample(self, rng, n: int) -> list:
        keys = list(self.docs)
        picks = rng.choice(len(keys), size=min(n, len(keys)), replace=False)
        return sorted(self.updated | self.deleted
                      | {keys[int(i)] for i in picks})


def write_bulk(engine, state, rng, lo: int, hi: int) -> None:
    """Index docs ``lo`` to ``hi`` plus ~1% updates and ~0.5% deletes of
    earlier docs, then one ``ensure_synced()``: the writes are acked.
    Before each refresh, one write with a stale ``if_seq_no`` must be
    refused."""
    from opensearch_tpu_torch.common.errors import VersionConflictError

    for i in range(lo, hi):
        r = engine.index(str(i), state.source(i))
        if r.result != "created":
            raise AssertionError(f"write path: new doc [{i}] {r.result}")
        state.docs[str(i)] = state.source(i)
    n = hi - lo
    for j in rng.integers(0, hi, size=n // 100):
        doc = str(int(j))
        if state.docs[doc] is None:
            continue
        src = {"body": state.texts[int(rng.integers(0, hi))], "tag": "gold"}
        if engine.index(doc, src).result != "updated":
            raise AssertionError(f"write path: update of [{doc}] refused")
        state.docs[doc] = src
        state.updated.add(doc)
    for j in rng.integers(0, hi, size=n // 200):
        doc = str(int(j))
        if state.docs[doc] is None:
            continue
        if engine.delete(doc).result != "deleted":
            raise AssertionError(f"write path: delete of [{doc}] refused")
        state.docs[doc] = None
        state.deleted.add(doc)
    engine.ensure_synced()
    if hi % WRITE_REFRESH_EVERY:
        return
    doc = next(d for d in (str(int(j)) for j in rng.integers(0, hi, 50))
               if state.docs[d] is not None)
    stale = engine.get(doc)["_seq_no"] - 1
    try:
        engine.index(doc, {"body": "stale", "tag": "red"}, if_seq_no=stale)
    except VersionConflictError:
        state.conflicts += 1
    else:
        raise AssertionError(f"write path: a write to [{doc}] with the "
                             f"stale if_seq_no {stale} was accepted")


def write_bodies(seed: int, n: int = 20) -> list:
    """``n`` zipf ``match`` bodies and one ``bool`` with a ``term``
    filter on ``tag``."""
    from opensearch_tpu_torch.testing import corpus

    pairs = corpus.zipf_query_log(n + 1, seed=seed)
    a, b = pairs[-1]
    return [{"query": {"match": {"body": f"t{x} t{y}"}}, "size": 10,
             "_source": False} for x, y in pairs[:n]] + [
        {"query": {"bool": {"must": [{"match": {"body": f"t{a} t{b}"}}],
                            "filter": [{"term": {
                                "tag": WRITE_TAGS[seed % 5]}}]}},
         "size": 10, "_source": False}]


def against_cpu(engine, mapper, bodies, what: str) -> None:
    """``bodies`` on the engine's searcher, byte-equal to a searcher on
    the CPU over the same segments, with equal counts."""
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing.parity import bm25_mismatch

    searcher = engine.acquire_searcher()
    cpu = ShardSearcher(engine.segments, mapper, device="cpu")
    for body in bodies:
        bad = bm25_mismatch(searcher.search(body), cpu.search(body))
        if bad:
            raise AssertionError(f"write path {what}: "
                                 f"{json.dumps(body)[:80]}: {bad}")
    for q in ({"match_all": {}}, bodies[-1]["query"]):
        if searcher.count(q) != cpu.count(q):
            raise AssertionError(f"write path {what}: count of {q} differs "
                                 "from the CPU searcher")


def first_query_ms(engine, body) -> float:
    t0 = time.monotonic()
    engine.acquire_searcher().search(body)
    return (time.monotonic() - t0) * 1e3


def per_match(searcher, bodies, counters, want: str) -> tuple:
    """(qps, p50 ms, launches per query) of ``bodies`` (``match``); each
    query with a term in the shard must make one ``want`` launch and no
    other (a query none of whose terms occur makes none: the can-match
    skip)."""
    timed(searcher, bodies[:20])                          # warm-up
    c0 = {name: fn.launches for name, fn in counters.items()}
    qps, p50 = timed(searcher, bodies)
    reach = sum(any(searcher.ctx.df("body", t)
                    for t in b["query"]["match"]["body"].split())
                for b in bodies)
    per_query = {name: (fn.launches - c0[name]) / reach
                 for name, fn in counters.items()}
    if per_query[want] != 1.0 or any(v for name, v in per_query.items()
                                     if name != want):
        raise AssertionError(f"write path: a match query must make one "
                             f"{want} launch and no other: {per_query}")
    return qps, p50, per_query


def phase_write_path(counters) -> dict:
    """Phase 8: the write path on the card (see the module doc)."""
    import gc
    import shutil
    import tempfile

    from opensearch_tpu_torch.index import codec
    from opensearch_tpu_torch.index.engine import InternalEngine
    from opensearch_tpu_torch.mapping.mapper import DocumentMapper
    from opensearch_tpu_torch.testing import corpus

    t_phase = time.monotonic()
    mapper = DocumentMapper(WRITE_MAPPING)
    state = WriteState(corpus.render_texts(WRITE_DOCS + WRITE_REPLAY_DOCS,
                                           seed=42))
    rng = np.random.default_rng(81)
    path = tempfile.mkdtemp(prefix="chip_smoke_write_")
    quantized = [0]
    real_quantize = codec.quantize_postings

    def counted_quantize(*args, **kw):
        quantized[0] += 1
        return real_quantize(*args, **kw)

    def open_engine():
        t0 = time.monotonic()
        engine = InternalEngine(path, mapper, index_name="write",
                                device=DEVICE)
        return engine, time.monotonic() - t0

    match_qs = [{"query": {"match": {"body": f"t{a} t{b}"}}, "size": 10,
                 "_source": False}
                for a, b in corpus.zipf_query_log(200, seed=7)]
    codec.quantize_postings = counted_quantize
    for fn in counters.values():                # this path starts here
        fn.launches = 0
    try:
        engine, _ = open_engine()
        index_s, refresh_ms, visible_ms = 0.0, [], []
        for lo in range(0, WRITE_DOCS, WRITE_BULK):
            t0 = time.monotonic()
            write_bulk(engine, state, rng, lo, lo + WRITE_BULK)
            index_s += time.monotonic() - t0
            if (lo + WRITE_BULK) % WRITE_REFRESH_EVERY:
                continue
            t0 = time.monotonic()
            engine.refresh()
            refresh_ms.append((time.monotonic() - t0) * 1e3)
            bodies = write_bodies(seed=100 + len(refresh_ms))
            engine.acquire_searcher().search(bodies[0])
            visible_ms.append((time.monotonic() - t0) * 1e3)
            against_cpu(engine, mapper, bodies,
                        f"after refresh {len(refresh_ms)}")
        n_segments = len(engine.segments)
        read = state.check(engine, state.sample(rng, 2000))
        live = state.live()
        searcher = engine.acquire_searcher()
        if searcher.count({"match_all": {}}) != live or \
                engine.doc_count() != live:
            raise AssertionError(f"write path: {live} live docs acked, "
                                 f"count {searcher.count({'match_all': {}})}")
        f32 = per_match(searcher, match_qs, counters, "term_bag_topk")
        batch = match_qs[:64]
        seq = [strip_took(searcher.search(b)) for b in batch]
        k3_before = counters["batch_topk"].launches
        if [strip_took(r) for r in searcher.msearch(batch)] != seq or \
                counters["batch_topk"].launches - k3_before != 1:
            raise AssertionError("write path: an msearch batch of 64 on the "
                                 "engine's searcher must make one K3 launch "
                                 "and equal sequential search")
        old_resident = searcher.resident_bytes()
        del searcher
        gc.collect()
        before = device_allocated()
        t0 = time.monotonic()
        if engine.force_merge(2) != 2:
            raise AssertionError("write path: force_merge(2) did not give "
                                 "2 segments")
        merge_s = time.monotonic() - t0
        gc.collect()
        after = device_allocated()
        if after > before - old_resident:
            raise AssertionError(
                f"write path: {after} bytes allocated on the device after "
                f"the merge, more than {before} before it less the merged-"
                f"away segments' {old_resident}")
        merged = [seg.n_docs for seg in engine.segments]
        searcher = engine.acquire_searcher()
        if min(merged) < codec.QUANTIZED_MIN_DOCS or not all(
                seg.device(searcher.device).quantized_mode
                for seg in engine.segments):
            raise AssertionError(f"write path: merged segments {merged} "
                                 "are not all quantized")
        merge_first_ms = first_query_ms(engine, match_qs[0])
        against_cpu(engine, mapper, write_bodies(seed=300), "after merge")
        quant = per_match(searcher, match_qs, counters,
                          "term_bag_quantized_topk")
        del searcher
        engine.flush()
        engine.close()
        engine, recovery_s = open_engine()
        quantized[0] = 0
        cold_ms = first_query_ms(engine, match_qs[0])
        cold_quantized = quantized[0]
        sidecars = sorted(n for n in os.listdir(os.path.join(path, "segments"))
                          if n.endswith(".quant"))
        if cold_quantized != 2 or len(sidecars) != 2:
            raise AssertionError(f"write path: the first match after the "
                                 f"reopen quantized {cold_quantized} tables "
                                 f"and left sidecars {sidecars}")
        against_cpu(engine, mapper, write_bodies(seed=301), "after reopen")
        engine.close()
        engine, recovery2_s = open_engine()
        quantized[0] = 0
        warm_ms = first_query_ms(engine, match_qs[0])
        if quantized[0]:
            raise AssertionError(f"write path: the second reopen quantized "
                                 f"{quantized[0]} tables: sidecars unused")
        against_cpu(engine, mapper, write_bodies(seed=302),
                    "after the second reopen")
        replay = range(WRITE_DOCS, WRITE_DOCS + WRITE_REPLAY_DOCS)
        for i in replay:
            engine.index(str(i), state.source(i))
            state.docs[str(i)] = state.source(i)
        engine.ensure_synced()
        engine = None                            # killed: no close()
        gc.collect()
        engine, replay_s = open_engine()
        live = state.live()
        if engine.doc_count() != live:
            raise AssertionError(f"write path: {engine.doc_count()} docs "
                                 f"after the replay, {live} acked")
        engine.refresh()
        quantized[0] = 0
        shift_ms = first_query_ms(engine, match_qs[0])
        shift_quantized = quantized[0]
        read += state.check(engine, [str(i) for i in replay]
                            + state.sample(rng, 500))
        against_cpu(engine, mapper, write_bodies(seed=303),
                    "after the kill and replay")
        if engine.acquire_searcher().count({"match_all": {}}) != live:
            raise AssertionError("write path: count after the replay")
        engine.close()
        launches = {name: fn.launches for name, fn in counters.items()}
    finally:
        codec.quantize_postings = real_quantize
        shutil.rmtree(path, ignore_errors=True)
    if min(launches[n] for n in ("term_bag_topk", "term_bag_quantized_topk",
                                 "batch_topk")) <= 0:
        raise AssertionError(f"write path: a kernel never launched: "
                             f"{launches}")
    gpu = gpu_name_power()
    out = {
        "docs": WRITE_DOCS, "nrt_segments": n_segments,
        "merged_segments": merged, "live_docs": live,
        "docs_per_s": WRITE_DOCS / index_s, "index_s": index_s,
        "refresh_s": sum(refresh_ms) / 1e3,
        "refresh_ms_p50": float(np.median(refresh_ms)),
        "refresh_ms_max": max(refresh_ms),
        "refresh_to_first_search_ms_p50": float(np.median(visible_ms)),
        "refresh_to_first_search_ms_max": max(visible_ms),
        "f32_match_qps": f32[0], "f32_match_p50_ms": f32[1],
        "quantized_match_qps": quant[0], "quantized_match_p50_ms": quant[1],
        "merge_s": merge_s, "first_match_after_merge_ms": merge_first_ms,
        "recovery_s": recovery_s, "recovery2_s": recovery2_s,
        "replay_s": replay_s, "first_match_cold_ms": cold_ms,
        "first_match_sidecar_ms": warm_ms,
        "first_match_after_avgdl_shift_ms": shift_ms,
        "quantized_after_shift": shift_quantized,
        "device_bytes_before_merge": before,
        "device_bytes_after_merge": after,
        "merged_away_resident_bytes": old_resident,
        "gets_read_back": read, "stale_writes_refused": state.conflicts,
        "updated": len(state.updated), "deleted": len(state.deleted),
        "launches": launches,
        "launches_per_match_f32": f32[2], "launches_per_match_quantized":
            quant[2], "wall_s": time.monotonic() - t_phase}
    log(f"write path: {WRITE_DOCS} docs in bulks of {WRITE_BULK} (one fsync "
        f"each) at {out['docs_per_s']:.1f} docs/s with "
        f"{len(state.updated)} updates, {len(state.deleted)} deletes and "
        f"{state.conflicts} stale writes refused; {n_segments} refreshes: "
        f"refresh ms p50 {out['refresh_ms_p50']:.1f} max "
        f"{out['refresh_ms_max']:.1f}, refresh-to-first-search ms p50 "
        f"{out['refresh_to_first_search_ms_p50']:.1f} max "
        f"{out['refresh_to_first_search_ms_max']:.1f}; f32 match "
        f"({n_segments} segments) qps {f32[0]:.2f} p50 {f32[1]:.3f} ms; "
        f"force_merge(2) {merge_s:.1f} s into {merged} docs; quantized "
        f"match qps {quant[0]:.2f} p50 {quant[1]:.3f} ms; recovery "
        f"{recovery_s:.2f} s / {recovery2_s:.2f} s / replay of "
        f"{WRITE_REPLAY_DOCS} ops {replay_s:.2f} s; first match ms: after "
        f"the merge {merge_first_ms:.1f}, cold {cold_ms:.1f} (quantized "
        f"{cold_quantized} tables, sidecars written), with the sidecar "
        f"{warm_ms:.1f} (0 quantized), after the replay's avgdl shift "
        f"{shift_ms:.1f} ({shift_quantized} quantized); device bytes "
        f"{before} before the merge, {after} after it (merged-away "
        f"segments held {old_resident}); {read} gets read back; launches "
        f"{launches}; on {gpu}")
    return out


# -- phase 9 ----------------------------------------------------------------

SERVE_DOCS = 20_000              # phase 9: docs indexed through _bulk
SERVE_BULK = 1_000               # items of a _bulk request
SERVE_REFRESH_EVERY = 5_000      # docs between _refresh calls: 4 refreshes
SERVE_VECTORS = 5_000            # docs of the 128-d vectors index
SERVE_SAMPLE = 500               # acked ids read back by GET _doc


class HttpClient:
    """One keep-alive HTTP/1.1 connection to the node (a client's
    connection pool of one); ``call`` returns (status, parsed body)."""

    def __init__(self, port: int):
        import http.client
        self.conn = http.client.HTTPConnection("127.0.0.1", port,
                                               timeout=300)

    def call(self, method: str, path: str, body=None, ndjson=None):
        headers = {}
        data = None
        if ndjson is not None:
            data = ("\n".join(json.dumps(x) for x in ndjson)
                    + "\n").encode()
            headers["Content-Type"] = "application/x-ndjson"
        elif body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        self.conn.request(method, path, body=data, headers=headers)
        resp = self.conn.getresponse()
        payload = resp.read()
        return resp.status, (json.loads(payload) if payload else {})

    def ok(self, method: str, path: str, body=None, ndjson=None,
           want: int = 200):
        status, out = self.call(method, path, body, ndjson)
        if status != want:
            raise AssertionError(f"serving: {method} {path} answered "
                                 f"{status}, not {want}: "
                                 f"{json.dumps(out)[:300]}")
        return out

    def close(self):
        self.conn.close()


def serve_bulk(client, state, rng, lo: int, hi: int) -> int:
    """One ``_bulk`` of docs ``lo`` to ``hi`` of ``corpus`` with ~1%
    ``update`` and ~0.5% ``delete`` items of earlier docs; every item's
    answer is checked and the acked state kept.  The first request also
    carries a ``create`` of an existing id, which must be refused.
    Returns the number of items."""
    items, expect = [], []
    for i in range(lo, hi):
        items += [{"index": {"_index": "corpus", "_id": str(i)}},
                  state.source(i)]
        expect.append((str(i), "index", state.source(i)))
    n = hi - lo
    for j in rng.integers(0, max(lo, 1), size=n // 100):
        doc = str(int(j))
        if state.docs.get(doc) is None:
            continue
        tag = WRITE_TAGS[int(rng.integers(0, 5))]
        items += [{"update": {"_index": "corpus", "_id": doc}},
                  {"doc": {"tag": tag}}]
        expect.append((doc, "update", {**state.docs[doc], "tag": tag}))
        state.docs[doc] = {**state.docs[doc], "tag": tag}
    for j in rng.integers(0, max(lo, 1), size=n // 200):
        doc = str(int(j))
        if state.docs.get(doc) is None:
            continue
        items.append({"delete": {"_index": "corpus", "_id": doc}})
        expect.append((doc, "delete", None))
        state.docs[doc] = None
    if lo == 0:
        items += [{"create": {"_index": "corpus", "_id": "0"}},
                  {"body": "t1", "tag": "red"}]
        expect.append(("0", "create", "conflict"))
    out = client.ok("POST", "/_bulk", ndjson=items)
    if len(out["items"]) != len(expect):
        raise AssertionError("serving: _bulk answered "
                             f"{len(out['items'])} items for {len(expect)}")
    for (doc, action, src), item in zip(expect, out["items"]):
        (got_action, res), = item.items()
        if action == "create":
            # the reference refuses a create of an existing id inside
            # _bulk with its version-conflict message (status 400,
            # opensearch_tpu/indices/service.py:329-334)
            if "version conflict" not in res.get("error", {}).get(
                    "reason", ""):
                raise AssertionError(f"serving: a create of the existing "
                                     f"id [{doc}] was not refused: {res}")
            state.conflicts += 1
            continue
        if got_action != action or res.get("error") or \
                res["status"] not in (200, 201):
            raise AssertionError(f"serving: {action} [{doc}] answered "
                                 f"{res}")
        if action == "index":
            state.docs[doc] = src
        elif action == "update":
            state.updated.add(doc)
        else:
            state.deleted.add(doc)
    return len(expect)


def read_back(client, state, ids) -> int:
    """``GET /corpus/_doc/{id}`` of ``ids`` against the acked state."""
    for doc in ids:
        status, out = client.call("GET", f"/corpus/_doc/{doc}")
        want = state.docs[doc]
        if (want is None and status != 404) or (
                want is not None and (status != 200
                                      or out.get("_source") != want)):
            raise AssertionError(f"serving: GET [{doc}] answered {status} "
                                 f"{json.dumps(out)[:120]}, acked "
                                 f"{str(want)[:80]}")
    return len(ids)


def serve_sequential(client, bodies, counters, reach: int) -> tuple:
    """(qps, p50 ms, p99 ms, responses, launches per query that can
    match) of ``bodies`` sent one at a time as ``_search`` requests."""
    c0 = {name: fn.launches for name, fn in counters.items()}
    lat, out = [], []
    t0 = time.monotonic()
    for body in bodies:
        t = time.monotonic()
        out.append(client.ok("POST", "/corpus/_search", body))
        lat.append((time.monotonic() - t) * 1e3)
    wall = time.monotonic() - t0
    per_query = {name: (fn.launches - c0[name]) / reach
                 for name, fn in counters.items()}
    return (len(bodies) / wall, float(np.percentile(lat, 50)),
            float(np.percentile(lat, 99)), out, per_query)


def client_threads(port: int, bodies, threads: int) -> tuple:
    """(responses, latencies ms, wall s) of ``bodies`` sent as
    ``/corpus/_search`` requests from ``threads`` client threads, each on
    its own keep-alive connection."""
    import threading

    n = len(bodies)
    results, lat, errors = [None] * n, [0.0] * n, []

    def client_thread(t):
        client = HttpClient(port)
        try:
            for i in range(t, n, threads):
                t1 = time.monotonic()
                results[i] = client.ok("POST", "/corpus/_search", bodies[i])
                lat[i] = (time.monotonic() - t1) * 1e3
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
        finally:
            client.close()

    pool = [threading.Thread(target=client_thread, args=(t,),
                             name=f"serve-client-{t}", daemon=True)
            for t in range(threads)]
    t0 = time.monotonic()
    for t in pool:
        t.start()
    for t in pool:
        t.join(300)
    wall = time.monotonic() - t0
    if any(t.is_alive() for t in pool):
        raise AssertionError("serving: a concurrent client hung")
    if errors:
        raise errors[0]
    return results, lat, wall


def client_process_main(port: int, threads: int, in_path: str,
                        out_path: str) -> None:
    """``client_threads`` in a process of its own (run by
    ``serve_concurrent``): the bodies come from ``in_path``, the
    responses, latencies and wall time go to ``out_path``."""
    with open(in_path) as f:
        bodies = json.load(f)
    results, lat, wall = client_threads(port, bodies, threads)
    with open(out_path, "w") as f:
        json.dump({"results": results, "lat": lat, "wall": wall}, f)


def serve_concurrent(port: int, bodies, seq, threads: int,
                     own_process: bool) -> tuple:
    """(qps, p50 ms, p99 ms) of ``bodies`` sent as ``_search`` requests
    from ``threads`` client threads, in this process (their JSON and HTTP
    work shares the node's interpreter lock) or in a child process of
    their own; every response must equal the sequential one."""
    import tempfile

    if own_process:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_clients_") as d:
            in_path = os.path.join(d, "bodies.json")
            out_path = os.path.join(d, "out.json")
            with open(in_path, "w") as f:
                json.dump(bodies, f)
            subprocess.run(
                [sys.executable, "-c",
                 "import chip_smoke as cs; cs.client_process_main("
                 f"{port}, {threads}, {in_path!r}, {out_path!r})"],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                check=True, timeout=600)
            with open(out_path) as f:
                out = json.load(f)
        results, lat, wall = out["results"], out["lat"], out["wall"]
    else:
        results, lat, wall = client_threads(port, bodies, threads)
    bad = [i for i, r in enumerate(results)
           if strip_took(r) != seq[i]]
    if bad:
        raise AssertionError(f"serving: concurrent responses {bad[:5]} "
                             "differ from sequential ones")
    return (len(bodies) / wall, float(np.percentile(lat, 50)),
            float(np.percentile(lat, 99)))


def phase_serving(counters, then=None) -> dict:
    """Phase 9: the serving node on the card, over HTTP only (see the
    module doc).  ``then(node, state)``, when given, runs on the node
    after this phase has read its counts and before the node stops;
    what it returns is the result's ``"then"``, and its seconds are not
    in the phase's ``wall_s``."""
    import gc
    import shutil
    import tempfile

    import torch

    from opensearch_tpu_torch.node import Node
    from opensearch_tpu_torch.search import engine as engine_mod
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing import corpus
    from opensearch_tpu_torch.testing.parity import knn_mismatch

    t_phase = time.monotonic()
    path = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    state = WriteState(corpus.render_texts(SERVE_DOCS, seed=44))
    rng = np.random.default_rng(91)
    match_qs = [{"query": {"match": {"body": f"t{a} t{b}"}}, "size": 10}
                for a, b in corpus.zipf_query_log(200, seed=7)]
    log_qs = [{"query": {"match": {"body": f"t{a} t{b}"}}, "size": 10}
              for a, b in corpus.zipf_query_log(256, seed=7)]
    nodes = []
    for fn in counters.values():                # this path starts here
        fn.launches = 0
    try:
        node = Node(path, port=0, device=DEVICE).start()
        nodes.append(node)
        client = HttpClient(node.port)
        root = client.ok("GET", "/")
        health = client.ok("GET", "/_cluster/health")
        client.ok("PUT", "/corpus", {"settings": {"number_of_shards": 2},
                                     "mappings": WRITE_MAPPING})
        bulk_s, refresh_ms, ops = 0.0, [], 0
        for lo in range(0, SERVE_DOCS, SERVE_BULK):
            t0 = time.monotonic()
            ops += serve_bulk(client, state, rng, lo, lo + SERVE_BULK)
            bulk_s += time.monotonic() - t0
            if (lo + SERVE_BULK) % SERVE_REFRESH_EVERY == 0:
                t0 = time.monotonic()
                client.ok("POST", "/corpus/_refresh")
                refresh_ms.append((time.monotonic() - t0) * 1e3)
        sample = state.sample(rng, SERVE_SAMPLE)
        read = read_back(client, state, sample)
        live = state.live()
        count = client.ok("GET", "/corpus/_count")["count"]
        if count != live:
            raise AssertionError(f"serving: _count {count}, {live} acked "
                                 "live docs")
        svc = node.indices.get("corpus")
        searcher = svc.searcher()
        n_segments = len(searcher.segments)
        reach = sum(any(searcher.ctx.df("body", t)
                        for t in b["query"]["match"]["body"].split())
                    for b in match_qs)
        client.ok("POST", "/corpus/_search", match_qs[0])      # warm-up
        qps, p50, p99, seq_out, per_query = serve_sequential(
            client, match_qs, counters, reach)
        if per_query["term_bag_topk"] != 1.0 or any(
                v for name, v in per_query.items()
                if name != "term_bag_topk"):
            raise AssertionError(f"serving: a match _search must make one "
                                 f"K2 top-k launch and no other: "
                                 f"{per_query}")
        cpu = ShardSearcher(searcher.segments, svc.mapper,
                            index_name="corpus", device="cpu")
        for body, got in zip(match_qs, seq_out):
            want = json.loads(json.dumps(cpu.search(body)))
            if got["hits"] != want["hits"]:
                raise AssertionError(f"serving: {json.dumps(body)} over "
                                     "HTTP differs from the CPU searcher")
        del cpu
        lat = []
        for body in match_qs:
            t0 = time.monotonic()
            svc.search(body)
            lat.append((time.monotonic() - t0) * 1e3)
        inproc_p50 = float(np.percentile(lat, 50))
        # the same bodies through the REST controller in process (the
        # response encoded as the HTTP layer encodes it), and the HTTP
        # floor: a keep-alive round trip of GET /
        lat = []
        for body in match_qs:
            raw = json.dumps(body).encode()
            t0 = time.monotonic()
            status, resp = node.rest.dispatch("POST", "/corpus/_search", {},
                                              raw, "application/json")
            json.dumps(resp)
            lat.append((time.monotonic() - t0) * 1e3)
            if status != 200:
                raise AssertionError(f"serving: dispatch answered {status}")
        dispatch_p50 = float(np.percentile(lat, 50))
        lat = []
        for _ in range(200):
            t0 = time.monotonic()
            client.ok("GET", "/")
            lat.append((time.monotonic() - t0) * 1e3)
        root_p50 = float(np.percentile(lat, 50))
        # _msearch: one K3 launch for the batch of 64
        batch = log_qs[:64]
        seq64 = [strip_took(client.ok("POST", "/corpus/_search", b))
                 for b in batch]
        k3_before = counters["batch_topk"].launches
        lines = []
        for body in batch:
            lines += [{}, body]
        ms = client.ok("POST", "/corpus/_msearch", ndjson=lines)
        k3_msearch = counters["batch_topk"].launches - k3_before
        got64 = [strip_took({k: v for k, v in r.items() if k != "status"})
                 for r in ms["responses"]]
        if k3_msearch != 1 or got64 != seq64:
            raise AssertionError(f"serving: an _msearch of 64 made "
                                 f"{k3_msearch} K3 launches or differs "
                                 "from sequential _search")
        # 16 concurrent clients: the continuous batcher behind the real
        # IndexService (plans compiled by the sequential pass first)
        seq256 = [strip_took(client.ok("POST", "/corpus/_search", b))
                  for b in log_qs]
        eng = engine_mod.query_engine()
        prev = (engine_mod.BATCHER_WINDOW_MS, engine_mod.BATCHER_MAX_BATCH)
        engine_mod.BATCHER_WINDOW_MS, engine_mod.BATCHER_MAX_BATCH = 4.0, 64
        concurrent = {}
        try:
            for where in ("in_process", "own_process"):
                s0 = eng.batcher.stats()
                k3_before = counters["batch_topk"].launches
                c_qps, c_p50, c_p99 = serve_concurrent(
                    node.port, log_qs, seq256, 16,
                    own_process=where == "own_process")
                s1 = eng.batcher.stats()
                groups = s1["dispatches"] - s0["dispatches"]
                batched = s1["batched"] - s0["batched"]
                bypass = s1["bypass"] - s0["bypass"]
                solo = len(log_qs) - batched - bypass
                dispatches = (groups + solo + bypass) / len(log_qs)
                if dispatches >= 1.0 or \
                        counters["batch_topk"].launches - k3_before != groups:
                    raise AssertionError(
                        f"serving: {dispatches} dispatches per query from "
                        f"16 clients {where}, {groups} groups")
                concurrent[where] = {
                    "qps": c_qps, "p50_ms": c_p50, "p99_ms": c_p99,
                    "groups": groups, "batched": batched, "solo": solo,
                    "bypass": bypass, "dispatches_per_query": dispatches}
        finally:
            engine_mod.BATCHER_WINDOW_MS, engine_mod.BATCHER_MAX_BATCH = prev
        # the vectors index: one K1 launch per knn _search
        client.ok("PUT", "/vectors", {"mappings": {"properties": {
            "vec": {"type": "knn_vector", "dimension": DIM,
                    "space_type": "l2"}}}})
        vecs = corpus.random_vectors(SERVE_VECTORS, DIM, seed=45)
        t0 = time.monotonic()
        for lo in range(0, SERVE_VECTORS, SERVE_BULK):
            items = []
            for i in range(lo, lo + SERVE_BULK):
                items += [{"index": {"_index": "vectors", "_id": f"v{i}"}},
                          {"vec": vecs[i].tolist()}]
            if client.ok("POST", "/_bulk", ndjson=items)["errors"]:
                raise AssertionError("serving: a vectors _bulk item failed")
        client.ok("POST", "/vectors/_refresh")
        vec_bulk_s = time.monotonic() - t0
        vsvc = node.indices.get("vectors")
        vcpu = ShardSearcher(vsvc.searcher().segments, vsvc.mapper,
                             index_name="vectors", device="cpu")
        knn_qs = [{"query": {"knn": {"vec": {"vector": q.tolist(),
                                             "k": 10}}}, "size": 10}
                  for q in corpus.random_vectors(50, DIM, seed=46)]
        k1_before = counters["knn_topk"].launches
        plan_before = counters["plan_topk"].launches
        knn_lat, knn_out = [], []
        for body in knn_qs:
            t0 = time.monotonic()
            knn_out.append(client.ok("POST", "/vectors/_search", body))
            knn_lat.append((time.monotonic() - t0) * 1e3)
        k1_per_query = (counters["knn_topk"].launches - k1_before) / len(
            knn_qs)
        plan_per_query = (counters["plan_topk"].launches
                          - plan_before) / len(knn_qs)
        if k1_per_query != 1.0 or plan_per_query != 1.0:
            raise AssertionError(f"serving: {k1_per_query} K1 and "
                                 f"{plan_per_query} plan top-k launches per "
                                 "knn _search")
        for body, got in zip(knn_qs, knn_out):
            bad = knn_mismatch(got, json.loads(json.dumps(vcpu.search(body))))
            if bad:
                raise AssertionError(f"serving: knn over HTTP: {bad}")
        del vcpu
        multi = client.ok("GET", "/corpus,vectors/_search",
                          {"query": {"match_all": {}}, "size": 5})
        if multi["hits"]["total"]["value"] != live + SERVE_VECTORS or \
                multi["_shards"]["total"] != 3:
            raise AssertionError(f"serving: multi-index search answered "
                                 f"{json.dumps(multi)[:200]}")
        # aggs on corpus, and across corpus and vectors (each index
        # answers its partials, the coordinator reduces them), equal to
        # the CPU searcher over the corpus's segments
        agg_body = {"size": 0, "aggs": {
            "t": {"terms": {"field": "tag"}},
            "n": {"value_count": {"field": "tag"}}}}
        aggs = client.ok("POST", "/corpus/_search", agg_body)
        multi_aggs = client.ok("POST", "/corpus,vectors/_search", agg_body)
        want = json.loads(json.dumps(ShardSearcher(
            svc.searcher().segments, svc.mapper, index_name="corpus",
            device="cpu").search(dict(agg_body))["aggregations"]))
        if aggs["aggregations"] != want or \
                multi_aggs["aggregations"] != want or \
                not want["t"]["buckets"]:
            raise AssertionError(f"serving: aggs answered "
                                 f"{json.dumps(aggs)[:300]}, across "
                                 f"indices {json.dumps(multi_aggs)[:300]}")
        missing = client.call("GET", "/missing/_search")
        if missing[0] != 404 or missing[1] != {
                    "error": {"root_cause": [{
                        "type": "index_not_found_exception",
                        "reason": "no such index [missing]"}],
                        "type": "index_not_found_exception",
                        "reason": "no such index [missing]",
                        "metadata": {"index": "missing"}},
                    "status": 404}:
            raise AssertionError(f"serving: a missing index answered "
                                 f"{missing}")
        # merge, flush, delete the vectors index
        del searcher
        t0 = time.monotonic()
        client.ok("POST", "/corpus/_forcemerge?max_num_segments=1")
        merge_s = time.monotonic() - t0
        client.ok("POST", "/corpus/_flush")
        keep = match_qs[:20]
        before_restart = [strip_took(client.ok("POST", "/corpus/_search",
                                               b)) for b in keep]
        resident_vectors = vsvc.searcher().resident_bytes()
        del vsvc
        gc.collect()
        torch.cuda.synchronize()
        bytes_before = device_allocated()
        client.ok("DELETE", "/vectors")
        gc.collect()
        bytes_after = device_allocated()
        if bytes_after > bytes_before - resident_vectors:
            raise AssertionError(
                f"serving: {bytes_after} device bytes after DELETE "
                f"/vectors, more than {bytes_before} before it less the "
                f"index's {resident_vectors} resident")
        client.close()
        # restart on the same data path
        del svc
        t0 = time.monotonic()
        node.stop()
        node = Node(path, port=0, device=DEVICE).start()
        nodes.append(node)
        restart_s = time.monotonic() - t0
        client = HttpClient(node.port)
        t0 = time.monotonic()
        first = client.ok("POST", "/corpus/_search", keep[0])
        first_ms = (time.monotonic() - t0) * 1e3
        after_restart = [strip_took(first)] + [
            strip_took(client.ok("POST", "/corpus/_search", b))
            for b in keep[1:]]
        if after_restart != before_restart:
            raise AssertionError("serving: _search after the restart "
                                 "differs from before it")
        if client.call("HEAD", "/vectors")[0] != 404 or \
                sorted(node.indices.indices) != ["corpus"]:
            raise AssertionError("serving: the deleted index came back")
        if client.ok("GET", "/corpus/_count")["count"] != live:
            raise AssertionError("serving: _count changed across the "
                                 "restart")
        read += read_back(client, state, sample)
        client.close()
        launches = {name: fn.launches for name, fn in counters.items()}
        t_then = time.monotonic()
        after = then(node, state) if then is not None else None
        then_s = time.monotonic() - t_then
    finally:
        for n in nodes:
            n.stop()
        shutil.rmtree(path, ignore_errors=True)
    if min(launches[n] for n in ("term_bag_topk", "batch_topk",
                                 "knn_topk")) <= 0:
        raise AssertionError(f"serving: a kernel never launched: {launches}")
    gpu = gpu_name_power()
    out = {
        "docs": SERVE_DOCS, "shards": 2, "bulk_ops": ops,
        "bulk_ops_per_s": ops / bulk_s, "bulk_s": bulk_s,
        "refresh_ms": refresh_ms, "nrt_segments": n_segments,
        "live_docs": live, "gets_read_back": read,
        "create_conflicts": state.conflicts,
        "updated": len(state.updated), "deleted": len(state.deleted),
        "match_qps": qps, "match_p50_ms": p50, "match_p99_ms": p99,
        "match_inprocess_p50_ms": inproc_p50,
        "match_dispatch_p50_ms": dispatch_p50,
        "get_root_p50_ms": root_p50,
        "rest_http_p50_ms": p50 - inproc_p50,
        "launches_per_match": per_query, "msearch_k3_launches": k3_msearch,
        "concurrent_16": concurrent,
        "vectors": SERVE_VECTORS, "vectors_bulk_s": vec_bulk_s,
        "knn_p50_ms": float(np.percentile(knn_lat, 50)),
        "k1_launches_per_knn": k1_per_query,
        "merge_s": merge_s,
        "device_bytes_before_delete": bytes_before,
        "device_bytes_after_delete": bytes_after,
        "vectors_resident_bytes": resident_vectors,
        "restart_s": restart_s, "first_search_after_restart_ms": first_ms,
        "version": root["version"]["number"],
        "health": health["status"], "launches": launches,
        "then": after, "wall_s": time.monotonic() - t_phase - then_s}
    log(f"serving: node on {DEVICE}, {SERVE_DOCS} docs in "
        f"{SERVE_DOCS // SERVE_BULK} _bulk requests of {SERVE_BULK} into "
        f"2 shards ({ops} ops, one translog sync each) at "
        f"{out['bulk_ops_per_s']:.1f} ops/s with {len(state.updated)} "
        f"updates, {len(state.deleted)} deletes and {state.conflicts} "
        f"refused create; refresh ms {[round(x, 1) for x in refresh_ms]}; "
        f"{read} acked docs read back by GET (before and after the "
        f"restart); _count {live}; match _search over HTTP ({n_segments} "
        f"segments): qps {qps:.2f}, p50 {p50:.3f} ms, p99 {p99:.3f} ms "
        f"(IndexService.search in process p50 {inproc_p50:.3f} ms, the "
        f"REST controller's dispatch and encode in process p50 "
        f"{dispatch_p50:.3f} ms, a keep-alive GET / p50 {root_p50:.3f} ms; "
        f"so REST + HTTP {p50 - inproc_p50:.3f} ms), launches per match "
        f"{per_query}, equal to the CPU searcher; _msearch of 64: "
        f"{k3_msearch} K3 launch, equal to sequential; 16 clients "
        + "; ".join(
            f"{where}: qps {c['qps']:.2f}, p50 {c['p50_ms']:.3f} ms, p99 "
            f"{c['p99_ms']:.3f} ms, {c['groups']} groups, "
            f"{c['dispatches_per_query']:.4f} dispatches per query"
            for where, c in concurrent.items())
        + ", equal to sequential; "
        f"vectors: {SERVE_VECTORS} docs by _bulk in {vec_bulk_s:.2f} s, "
        f"knn p50 {out['knn_p50_ms']:.3f} ms, {k1_per_query:.2f} K1 "
        f"launches per knn _search, within tolerance of the CPU; aggs on "
        f"corpus and across corpus,vectors equal to the CPU searcher, "
        f"missing index 404; _forcemerge {merge_s:.2f} s; device "
        f"bytes {bytes_before} before DELETE /vectors, {bytes_after} after "
        f"(index resident {resident_vectors}); restart {restart_s:.2f} s, "
        f"first _search {first_ms:.1f} ms, 20 responses equal to before; "
        f"launches {launches}; on {gpu}")
    return out


# -- phase 10 ---------------------------------------------------------------

FILTER_QUERIES = 200             # phase 10: bool + filters, on each layout
COUNT_QUERIES = 50               # _count of terms + a month's range + exists
IDS_QUERIES = 50                 # ids queries of IDS_PER_QUERY ids
IDS_PER_QUERY = 10
HYBRID_QUERIES = 100             # hybrid [match pair, knn k = 10]
HTTP_HYBRIDS = 20                # ... over HTTP through phase 9's node
FOLD_SAMPLE = 5                  # of each kind, held to the CPU searcher
# the normalization processor of phase 10's pipeline
PIPELINE = {"normalization": {"technique": "min_max"},
            "combination": {"technique": "arithmetic_mean",
                            "parameters": {"weights": [0.3, 0.7]}}}
MONTH_STARTS = [f"2024-{m:02d}-01" for m in range(1, 13)] + ["2025-01-01"]


def scale_columns() -> dict:
    """The scale corpus's doc-value columns (``price``, ``ts``, ``tag``),
    the same for its f32 and its quantized layout."""
    from opensearch_tpu_torch.testing import corpus

    return corpus.doc_value_columns(SCALE_DOCS, seed=11)


def phase10_bodies() -> dict:
    """Phase 10's traffic, seeded: ``bool`` bodies (the match pairs of
    phase 4, a ``price`` range over ~40% of the docs, a ``tag`` term),
    ``_count`` queries (5 ``tag`` values, a month of ``ts``, ``exists``),
    ``ids`` bodies and ``hybrid`` bodies (a match pair and a ``knn`` on
    ``vec``, through ``PIPELINE``)."""
    from opensearch_tpu_torch.testing import corpus

    rng = np.random.default_rng(61)
    pairs = corpus.zipf_query_log(FILTER_QUERIES, seed=7)
    width = int(corpus.PRICE_MAX * 0.4)

    def tag():              # one of the 20 most common tags, zipf-drawn
        return corpus.tag_name(min(int(rng.zipf(1.3)) - 1, 19))

    bools = []
    for a, b in pairs:
        lo = int(rng.integers(0, corpus.PRICE_MAX - width))
        bools.append({"query": {"bool": {
            "must": [{"match": {"body": f"t{a} t{b}"}}],
            "filter": [{"range": {"price": {"gte": lo, "lt": lo + width}}},
                       {"term": {"tag": tag()}}]}},
            "size": 10, "_source": False})
    counts = []
    for _ in range(COUNT_QUERIES):
        m = int(rng.integers(0, 12))
        counts.append({"bool": {"filter": [
            {"terms": {"tag": [tag() for _ in range(5)]}},
            {"range": {"ts": {"gte": MONTH_STARTS[m],
                              "lt": MONTH_STARTS[m + 1]}}},
            {"exists": {"field": "price"}}]}})
    ids = [{"query": {"ids": {"values": [
        str(int(i)) for i in rng.integers(0, SCALE_DOCS,
                                          size=IDS_PER_QUERY)]}},
        "size": IDS_PER_QUERY, "_source": False}
        for _ in range(IDS_QUERIES)]
    hybrids = [{"query": {"hybrid": {"queries": [
        {"match": {"body": f"t{a} t{b}"}},
        {"knn": {"vec": {"vector": rng.standard_normal(DIM).astype(
            np.float32).tolist(), "k": 10}}}]}},
        "size": 10, "_source": False, "_hybrid_pipeline": PIPELINE}
        for a, b in corpus.zipf_query_log(HYBRID_QUERIES + HTTP_HYBRIDS,
                                          seed=17)]
    return {"bool": bools, "count": counts, "ids": ids,
            "hybrid": hybrids[:HYBRID_QUERIES],
            "http_hybrid": hybrids[HYBRID_QUERIES:]}


def timed_calls(fn, items) -> tuple:
    """(qps, p50 ms, results) of ``fn(item)`` over ``items`` one after
    another, each ending on a host read of its result."""
    lat, out = [], []
    t0 = time.monotonic()
    for item in items:
        t = time.monotonic()
        out.append(fn(item))
        lat.append((time.monotonic() - t) * 1e3)
    return len(items) / (time.monotonic() - t0), float(np.median(lat)), out


def phase_http_hybrid(node, state, counters) -> dict:
    """Phase 10's hybrids over HTTP, on phase 9's node before it stops
    (``phase_serving``'s ``then``): its ``corpus`` index (SERVE_DOCS
    docs in 2 shards) gains a ``vec`` field by ``PUT _mapping``, and
    phase 9's SERVE_VECTORS vectors reach its first SERVE_VECTORS live
    docs by ``_bulk`` ``update``; then ``PUT /_search/pipeline/p`` and
    HTTP_HYBRIDS hybrids by ``?search_pipeline=p``, their counts zeroed
    just before them and read just after, held to the CPU searcher."""
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing import corpus
    from opensearch_tpu_torch.testing.parity import knn_mismatch

    t_phase = time.monotonic()
    bodies = phase10_bodies()["http_hybrid"]
    client = HttpClient(node.port)
    client.ok("PUT", "/corpus/_mapping", {"properties": {"vec": {
        "type": "knn_vector", "dimension": DIM, "space_type": "l2"}}})
    vecs = corpus.random_vectors(SERVE_VECTORS, DIM, seed=45)
    live = [doc for doc, src in state.docs.items()
            if src is not None][:SERVE_VECTORS]
    t0 = time.monotonic()
    for lo in range(0, len(live), SERVE_BULK):
        items = []
        for i in range(lo, min(lo + SERVE_BULK, len(live))):
            items += [{"update": {"_index": "corpus", "_id": live[i]}},
                      {"doc": {"vec": vecs[i].tolist()}}]
        if client.ok("POST", "/_bulk", ndjson=items)["errors"]:
            raise AssertionError("phase 10: a vector update failed")
    client.ok("POST", "/corpus/_refresh")
    update_s = time.monotonic() - t0
    pipe = {"phase_results_processors": [
        {"normalization-processor": PIPELINE}]}
    client.ok("PUT", "/_search/pipeline/p", pipe)
    if client.ok("GET", "/_search/pipeline/p") != {"p": pipe}:
        raise AssertionError("phase 10: the pipeline reads back otherwise")
    plain = [{k: v for k, v in b.items() if k != "_hybrid_pipeline"}
             for b in bodies]
    path = "/corpus/_search?search_pipeline=p"
    client.ok("POST", path, plain[0])                       # warm-up
    for fn in counters.values():                # this path starts here
        fn.launches = 0
    qps, p50, out = timed_calls(lambda b: client.ok("POST", path, b), plain)
    launches = {n: c.launches for n, c in counters.items()}
    got = {n: v for n, v in launches.items() if v}
    if got != {"term_bag_topk": HTTP_HYBRIDS, "knn_topk": HTTP_HYBRIDS,
               "plan_topk": HTTP_HYBRIDS}:
        raise AssertionError(f"phase 10 hybrid over HTTP: launches {got}")
    svc = node.indices.get("corpus")
    segments = svc.searcher().segments
    cpu = ShardSearcher(segments, svc.mapper, index_name="corpus",
                        device="cpu")
    for body, resp in zip(bodies, out):
        ref = json.loads(json.dumps(cpu.search(dict(body))))
        bad = knn_mismatch(resp, ref)
        if bad or [h["_id"] for h in resp["hits"]["hits"]] != \
                [h["_id"] for h in ref["hits"]["hits"]]:
            raise AssertionError(f"phase 10 hybrid over HTTP vs cpu: {bad}")
    if not all(r["hits"]["hits"] for r in out):
        raise AssertionError("phase 10: a hybrid over HTTP found nothing")
    client.ok("DELETE", "/_search/pipeline/p")
    client.close()
    return {"qps": qps, "p50_ms": p50, "queries": HTTP_HYBRIDS,
            "launches_per_query": {n: v / HTTP_HYBRIDS
                                   for n, v in launches.items()},
            "launches": launches, "docs": len(state.docs),
            "live_docs": state.live(), "shards": 2,
            "vectors": len(live), "segments": len(segments),
            "vector_update_s": update_s,
            "wall_s": time.monotonic() - t_phase}


def phase_filters_hybrid(segs, mapper, searcher, qsegs, qsearcher,
                         counters, http=None) -> dict:
    """Phase 10: filters and hybrid on the card (see the module doc);
    ``http`` is what ``phase_http_hybrid`` returned on phase 9's node."""
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing.parity import (bm25_mismatch,
                                                     knn_mismatch)

    t_phase = time.monotonic()
    q = phase10_bodies()
    layouts = {"f32": (segs, searcher), "quantized": (qsegs, qsearcher)}
    cpu = {name: ShardSearcher(s, mapper, index_name=srch.index_name,
                               device="cpu")
           for name, (s, srch) in layouts.items()}

    def can_match(srch, body):
        plan, bind = srch.compiled(body["query"])
        return sum(bool(plan.can_match(bind, seg)) for seg in srch.segments)

    # warm-up: staging of the columns and the demand-staged tag postings
    for srch in (searcher, qsearcher):
        for body in q["bool"][:3]:
            srch.search(dict(body))
    searcher.count(q["count"][0])
    searcher.search(dict(q["ids"][0]))
    searcher.search(dict(q["hybrid"][0]))
    for fn in counters.values():                # this path starts here
        fn.launches = 0
    kinds, launches = {}, {}

    def run(kind, fn, items):
        before = {n: c.launches for n, c in counters.items()}
        qps, p50, out = timed_calls(fn, items)
        launches[kind] = {n: c.launches - before[n]
                          for n, c in counters.items()}
        kinds[kind] = {"qps": qps, "p50_ms": p50, "queries": len(items),
                       "launches_per_query": {
                           n: v / len(items)
                           for n, v in launches[kind].items()}}
        return out

    out = {}
    for name, (_s, srch) in layouts.items():
        out[f"bool_{name}"] = run(f"bool_{name}", lambda b, s=srch: s.search(
            dict(b)), q["bool"])
    out["count"] = run("count", searcher.count, q["count"])
    out["ids"] = run("ids", lambda b: searcher.search(dict(b)), q["ids"])
    out["hybrid"] = run("hybrid", lambda b: searcher.search(dict(b)),
                        q["hybrid"])
    # one dense launch per term-bag leaf and row layout of a request over
    # every segment it reaches: a bool f32 makes two (the match, the tag
    # filter), a quantized bool one of each layout (the match on the
    # quantized tables, the tag filter on the f32 columns), a count one
    # (the terms filter); one plan top-k per request with hits (bool, ids,
    # the knn of a hybrid); one K2 top-k and one K1 per hybrid
    n_f32, n_quant = (sum(can_match(srch, b) > 0 for b in q["bool"])
                      for srch in (searcher, qsearcher))
    want = {"bool_f32": {"term_bag_scores": 2 * n_f32, "plan_topk": n_f32},
            "bool_quantized": {"term_bag_scores": n_quant,
                               "term_bag_quantized_scores": n_quant,
                               "plan_topk": n_quant},
            "count": {"term_bag_scores": COUNT_QUERIES},
            "ids": {"plan_topk": IDS_QUERIES},
            "hybrid": {"term_bag_topk": HYBRID_QUERIES,
                       "knn_topk": HYBRID_QUERIES,
                       "plan_topk": HYBRID_QUERIES}}
    for kind, expect in want.items():
        got = {n: v for n, v in launches[kind].items() if v}
        if got != expect:
            raise AssertionError(f"phase 10 {kind}: launches {got}, "
                                 f"expected {expect}")
    # answers: hits found, and a sample equal to the CPU searcher
    for kind in ("bool_f32", "bool_quantized", "ids", "hybrid"):
        if sum(bool(r["hits"]["hits"]) for r in out[kind]) < \
                0.5 * len(out[kind]):
            raise AssertionError(f"phase 10 {kind}: most queries found "
                                 "nothing")
    for name, (_s, srch) in layouts.items():
        for body, got in list(zip(q["bool"], out[f"bool_{name}"]))[
                :FOLD_SAMPLE]:
            bad = bm25_mismatch(got, cpu[name].search(dict(body)))
            if bad:
                raise AssertionError(f"phase 10 bool {name} vs cpu: {bad}")
    for body, got in list(zip(q["count"], out["count"]))[:FOLD_SAMPLE]:
        if got != cpu["f32"].count(body):
            raise AssertionError("phase 10 count differs from the CPU")
    for body, got in list(zip(q["ids"], out["ids"]))[:FOLD_SAMPLE]:
        bad = bm25_mismatch(got, cpu["f32"].search(dict(body)))
        if bad:
            raise AssertionError(f"phase 10 ids vs cpu: {bad}")
    for body, got in list(zip(q["hybrid"], out["hybrid"]))[:FOLD_SAMPLE]:
        ref = cpu["f32"].search(dict(body))
        bad = knn_mismatch(got, ref)
        if bad or [h["_id"] for h in got["hits"]["hits"]] != \
                [h["_id"] for h in ref["hits"]["hits"]]:
            raise AssertionError(f"phase 10 hybrid vs cpu: {bad}")
    del cpu
    # the resident bytes of the columns this slice stages
    resident = {}
    for name, (s, srch) in layouts.items():
        dsegs = [seg.device(srch.device) for seg in s]
        resident[name] = {
            "numeric": sum(d.column_bytes("numeric") for d in dsegs),
            "ordinal": sum(d.column_bytes("ordinal") for d in dsegs),
            "tag_postings": sum(
                sum(t.numel() * t.element_size()
                    for t in d.postings["tag"].values()) for d in dsegs)}

    # the hybrids over HTTP, run on phase 9's node (phase_http_hybrid)
    if http is not None:
        kinds["http_hybrid"] = {k: http[k] for k in (
            "qps", "p50_ms", "queries", "launches_per_query")}
        launches["http_hybrid"] = http["launches"]
    totals = {n: sum(launches[k][n] for k in launches) for n in counters}
    gpu = gpu_name_power()
    wall = time.monotonic() - t_phase + (http["wall_s"] if http else 0.0)
    log("filters and hybrid: " + "; ".join(
        f"{k} qps {v['qps']:.2f}, p50 {v['p50_ms']:.3f} ms, launches per "
        f"query " + ", ".join(f"{n} {x:.2f}" for n, x in
                              v["launches_per_query"].items() if x)
        for k, v in kinds.items())
        + (f"; hybrids over HTTP on phase 9's node: {http['live_docs']} "
           f"live docs in {http['shards']} shards and {http['segments']} "
           f"segments, {http['vectors']} vectors added by _bulk update in "
           f"{http['vector_update_s']:.2f} s, {http['wall_s']:.2f} s in all"
           if http else "")
        + f"; one dense launch per leaf and layout and one plan top-k per "
        f"request; samples equal to "
        f"the CPU searcher (BM25 byte for byte, hybrids' ids equal and "
        f"scores within rtol 1e-5 / atol 1e-6); resident bytes of the new "
        f"columns {resident}; phase {wall:.2f} s; on {gpu}")
    return {"kinds": kinds, "launches": totals,
            "resident_bytes": resident, "wall_s": wall,
            "http_index": http and {k: http[k] for k in (
                "docs", "live_docs", "shards", "vectors", "segments",
                "vector_update_s", "wall_s")}}


# -- phase 11 ---------------------------------------------------------------

AGG_DH = 50                      # date_histogram on ts, per layout
AGG_HIST = 50                    # range on price + histogram, per layout
AGG_TERMS = 50                   # match pair + terms on tag, per layout
AGG_METRICS = 20                 # match_all + 12 metric aggs, per layout
HTTP_AGGS = 20                   # terms + value_count on tag over HTTP
AGG_SAMPLE = 2                   # of each kind, held to the CPU searcher
AGG_PROFILE = 5                  # of each kind, timed by layer
DAY_MS = 86_400_000


def phase11_bodies() -> dict:
    """Phase 11's traffic, seeded, shaped on nyc_taxis'
    ``date_histogram_agg`` and ``distance_amount_agg`` operations and
    config 5: per kind a list of ``(body, expected K5 calls)``."""
    from opensearch_tpu_torch.testing import corpus

    rng = np.random.default_rng(81)
    dh_aggs = {"per_day": {"date_histogram": {
        "field": "ts", "calendar_interval": "day"},
        "aggs": {"fare": {"stats": {"field": "fare"}}}}}
    dh = []
    for i in range(AGG_DH):
        body = {"size": 0, "aggs": dh_aggs}
        if i < AGG_DH // 2:            # 21 days, as nyc_taxis' operation
            lo = corpus.TS_START_MS + int(rng.integers(0, 344)) * DAY_MS
            body["query"] = {"range": {"ts": {"gte": lo,
                                              "lt": lo + 21 * DAY_MS}}}
        dh.append((body, 2))           # the min/max pass, the buckets
    hist = [({"size": 0,
              "query": {"bool": {"filter": [{"range": {"price": {
                  "gte": 0, "lt": 5000}}}]}},
              "aggs": {"by_price": {"histogram": {"field": "price",
                                                  "interval": 500},
                                    "aggs": {"fare": {"stats": {
                                        "field": "fare"}}}}}}, 2)
            for _ in range(AGG_HIST)]
    terms = [({"query": {"match": {"body": f"t{a} t{b}"}}, "size": 10,
               "_source": False,
               "aggs": {"tags": {"terms": {"field": "tag", "size": 10},
                                 "aggs": {"avg_fare": {"avg": {
                                     "field": "fare"}},
                                     "max_price": {"max": {
                                         "field": "price"}}}}}}, 1)
             for a, b in corpus.zipf_query_log(AGG_TERMS, seed=7)]
    metric_aggs = {f"{m}_{f}": {m: {"field": f}}
                   for f in ("price", "fare")
                   for m in ("min", "max", "avg", "sum", "value_count",
                             "stats")}
    metrics = [({"size": 0, "query": {"match_all": {}},
                 "aggs": metric_aggs}, 1)         # one call, both columns
               for _ in range(AGG_METRICS)]
    lo = corpus.TS_START_MS + 100 * DAY_MS
    window = {"range": {"ts": {"gte": lo, "lt": lo + 21 * DAY_MS}}}
    one = [
        {"size": 0, "aggs": {"r": {"range": {"field": "price", "ranges": [
            {"to": 1000}, {"from": 1000, "to": 5000}, {"from": 5000}]},
            "aggs": {"f": {"avg": {"field": "fare"}}}}}},
        {"size": 0, "aggs": {"f": {"filters": {"filters": {
            "t0": {"term": {"tag": corpus.tag_name(0)}},
            "t1": {"term": {"tag": corpus.tag_name(1)}}}},
            "aggs": {"s": {"sum": {"field": "fare"}}}}}},
        {"size": 0, "aggs": {"m": {"missing": {"field": "fare"}}}},
        {"size": 0, "aggs": {"c": {"cardinality": {"field": "tag"}}}},
        {"size": 0, "aggs": {"p": {"percentiles": {
            "field": "fare", "percents": [1, 50, 99]}}}},
        {"size": 0, "query": window,
         "aggs": {"tp": {"terms": {"field": "price", "size": 5}}}},
        {"size": 0, "query": window, "aggs": {"comp": {"composite": {
            "size": 5, "after": {"tag": corpus.tag_name(3)},
            "sources": [{"tag": {"terms": {"field": "tag"}}}]},
            "aggs": {"f": {"max": {"field": "fare"}}}}}},
        {"size": 0, "query": window, "aggs": {"tags": {
            "terms": {"field": "tag", "size": 3},
            "aggs": {"top": {"top_hits": {
                "size": 2, "sort": [{"fare": {"order": "desc"}}]}}}}}},
        {"size": 0, "aggs": {"per_day": {**dh_aggs["per_day"], "aggs": {
            "total": {"sum": {"field": "fare"}},
            "cum": {"cumulative_sum": {"buckets_path": "total"}}}},
            "best": {"max_bucket": {"buckets_path": "per_day>total"}}}},
    ]
    return {"date_histogram": dh, "histogram": hist, "terms_hits": terms,
            "metrics": metrics, "one_of_each": [(b, None) for b in one]}


class LayerClock:
    """Host seconds spent, per request, in ``ShardSearcher._run_full``
    (the query phase, synchronized at its end), in the search package's
    collector calls (``AggregationExecutor._collect``: K5's launch, its
    copy back and the unpacking) and in ``AggregationExecutor.run`` /
    ``collect`` (the rest of the aggregation: host work around them);
    installed only around the requests it times."""

    def __init__(self):
        import torch

        from opensearch_tpu_torch.search import aggs as aggs_mod
        from opensearch_tpu_torch.search import executor

        self.t = {"run_full": 0.0, "collect": 0.0, "aggs": 0.0}
        sync = torch.cuda.synchronize
        clock = self
        real_full = executor.ShardSearcher._run_full
        real_collect = aggs_mod.AggregationExecutor._collect
        real_run = aggs_mod.AggregationExecutor.run

        def run_full(self, *a, **kw):
            t0 = time.monotonic()
            out = list(real_full(self, *a, **kw))
            sync()
            clock.t["run_full"] += time.monotonic() - t0
            return iter(out)

        def collect(*a, **kw):
            t0 = time.monotonic()
            out = real_collect(*a, **kw)
            clock.t["collect"] += time.monotonic() - t0
            return out

        def run(self, *a, **kw):
            t0 = time.monotonic()
            out = real_run(self, *a, **kw)
            clock.t["aggs"] += time.monotonic() - t0
            return out

        self.patches = [(executor.ShardSearcher, "_run_full", run_full,
                         real_full),
                        (aggs_mod.AggregationExecutor, "_collect",
                         staticmethod(collect),
                         aggs_mod.AggregationExecutor.__dict__["_collect"]),
                        (aggs_mod.AggregationExecutor, "run", run, real_run)]

    def __enter__(self):
        for owner, name, new, _old in self.patches:
            setattr(owner, name, new)
        return self

    def __exit__(self, *exc):
        for owner, name, _new, old in self.patches:
            setattr(owner, name, old)


def phase_http_aggs(node, state, counters) -> dict:
    """Phase 11's requests over HTTP, on phase 9's node before it stops
    (``phase_serving``'s ``then``): HTTP_AGGS ``_search`` bodies with
    ``terms`` on ``tag`` and ``value_count`` on ``tag``, each sent with
    ``?request_cache=false``, their counts zeroed just before them and
    read just after (one K5 call for the ``terms`` and one for the
    ``value_count``, each over every segment of both shards; no K3),
    every answer equal to the CPU searcher."""
    from opensearch_tpu_torch.ops import cuda_aggs
    from opensearch_tpu_torch.search.executor import ShardSearcher

    k5 = cuda_aggs.bucket_collect_cuda
    bodies = [{"size": 0, "aggs": {
        "tags": {"terms": {"field": "tag", "size": 3 + i % 5}},
        "n": {"value_count": {"field": "tag"}}}} for i in range(HTTP_AGGS)]
    client = HttpClient(node.port)
    path = "/corpus/_search?request_cache=false"
    client.ok("POST", path, bodies[0])                      # warm-up
    for fn in [*counters.values(), k5]:         # this path starts here
        fn.launches = 0
    k5.kernels = 0
    qps, p50, out = timed_calls(lambda b: client.ok("POST", path, b), bodies)
    launches = {n: c.launches for n, c in counters.items()}
    k5_n = k5.launches
    if k5_n != 2 * HTTP_AGGS or any(launches.values()):
        raise AssertionError(f"phase 11 aggs over HTTP: K5 {k5_n}, "
                             f"others {launches}")
    svc = node.indices.get("corpus")
    cpu = ShardSearcher(svc.searcher().segments, svc.mapper,
                        index_name="corpus", device="cpu")
    for body, resp in zip(bodies, out):
        want = json.loads(json.dumps(cpu.search(dict(body))))
        if resp["aggregations"] != want["aggregations"] or \
                resp["hits"]["total"] != want["hits"]["total"]:
            raise AssertionError("phase 11: aggs over HTTP differ from "
                                 "the CPU searcher")
    if not out[0]["aggregations"]["tags"]["buckets"]:
        raise AssertionError("phase 11: terms over HTTP found no bucket")
    client.close()
    return {"qps": qps, "p50_ms": p50, "requests": HTTP_AGGS,
            "k5_launches_per_request": k5_n / HTTP_AGGS,
            "k5_kernels_per_request": k5.kernels / HTTP_AGGS,
            "segments": len(svc.searcher().segments),
            "live_docs": state.live()}


def phase_aggs(segs, mapper, searcher, qsegs, qsearcher, counters,
               http=None) -> dict:
    """Phase 11: aggregations on the card at full width (see the module
    doc); ``http`` is what ``phase_http_aggs`` returned on phase 9's
    node."""
    import torch

    from opensearch_tpu_torch.ops import cuda_aggs
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing.parity import bm25_mismatch

    t_phase = time.monotonic()
    k5 = cuda_aggs.bucket_collect_cuda
    traffic = phase11_bodies()
    layouts = {"f32": (segs, searcher), "quantized": (qsegs, qsearcher)}
    # warm-up: plans compiled, every column staged
    for _s, srch in layouts.values():
        for kind in ("date_histogram", "histogram", "terms_hits",
                     "metrics"):
            srch.search(dict(traffic[kind][0][0]))
    torch.cuda.synchronize()
    for fn in [*counters.values(), k5]:         # this path starts here
        fn.launches = 0
    k5.kernels = 0
    kinds, outs = {}, {}
    for lname, (_s, srch) in layouts.items():
        n_seg = len(srch.segments)
        for kind, items in traffic.items():
            before, kernels0 = k5.launches, k5.kernels
            plan0 = counters["plan_topk"].launches
            qps, p50, out = timed_calls(lambda b: srch.search(dict(b)),
                                        [b for b, _n in items])
            per = (k5.launches - before) / len(items)
            kernels = (k5.kernels - kernels0) / len(items)
            # one plan top-k per request with hits, none with size 0
            plan_per = (counters["plan_topk"].launches - plan0) / len(items)
            if plan_per != (1.0 if kind == "terms_hits" else 0.0):
                raise AssertionError(f"phase 11 {lname} {kind}: {plan_per} "
                                     "plan top-k launches per request")
            want = items[0][1]
            if want is not None and per != want:
                raise AssertionError(f"phase 11 {lname} {kind}: {per} K5 "
                                     f"calls per request, not {want}")
            n_aggs = max(len(b["aggs"]) for b, _n in items)
            if per > n_aggs * 2 * n_seg:
                raise AssertionError(f"phase 11 {lname} {kind}: {per} K5 "
                                     "calls per request")
            kinds[f"{lname} {kind}"] = {
                "qps": qps, "p50_ms": p50, "requests": len(items),
                "k5_launches_per_request": per,
                "k5_kernels_per_request": kernels,
                "plan_topk_per_request": plan_per}
            outs[(lname, kind)] = out
    launches = {n: c.launches for n, c in counters.items()}
    k5_total = k5.launches
    if launches.get("batch_topk"):
        raise AssertionError(f"phase 11: an aggs body reached K3 "
                             f"({launches['batch_topk']} launches)")
    # where a request's time goes, on the f32 layout
    layers = {}
    for kind, items in traffic.items():
        if kind == "one_of_each":
            continue
        with LayerClock() as clock:
            t0 = time.monotonic()
            for body, _n in items[:AGG_PROFILE]:
                searcher.search(dict(body))
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        n = min(AGG_PROFILE, len(items))
        layers[kind] = {
            "ms_per_request": wall / n * 1e3,
            "run_full_ms": clock.t["run_full"] / n * 1e3,
            "k5_and_copy_ms": clock.t["collect"] / n * 1e3,
            "aggs_host_ms": (clock.t["aggs"] - clock.t["collect"]) / n * 1e3}
    # samples of each kind against the CPU searcher, byte for byte
    for lname, (lsegs, srch) in layouts.items():
        cpu = ShardSearcher(lsegs, mapper, index_name=srch.index_name,
                            device="cpu")
        for kind, items in traffic.items():
            picks = range(len(items)) if kind == "one_of_each" else \
                sorted({0, len(items) - 1})[:AGG_SAMPLE]
            for i in picks:
                body = items[i][0]
                got = json.loads(json.dumps(outs[(lname, kind)][i]))
                want = json.loads(json.dumps(cpu.search(dict(body))))
                if got["aggregations"] != want["aggregations"] or \
                        bm25_mismatch(got, want):
                    raise AssertionError(
                        f"phase 11 {lname} {kind} #{i} differs from the CPU "
                        f"searcher: {json.dumps(got['aggregations'])[:300]} "
                        f"vs {json.dumps(want['aggregations'])[:300]}")
                if not got["aggregations"]:
                    raise AssertionError(f"phase 11 {kind}: no aggregations")
        del cpu
    wall = time.monotonic() - t_phase
    gpu = gpu_name_power()
    log("aggregations: "
        + "; ".join(f"{k}: qps {v['qps']:.2f}, p50 {v['p50_ms']:.3f} ms, "
                    f"{v['k5_launches_per_request']:.2f} K5 calls "
                    f"({v['k5_kernels_per_request']:.2f} kernels) a request"
                    for k, v in kinds.items())
        + "; f32 per request (ms, synchronized): "
        + "; ".join(f"{k} {v['ms_per_request']:.3f} = run_full "
                    f"{v['run_full_ms']:.3f} + K5 and copy "
                    f"{v['k5_and_copy_ms']:.3f} + aggs host "
                    f"{v['aggs_host_ms']:.3f} + rest"
                    for k, v in layers.items())
        + (f"; over HTTP on phase 9's node ({http['segments']} segments, "
           f"{http['live_docs']} live docs): qps {http['qps']:.2f}, p50 "
           f"{http['p50_ms']:.3f} ms, {http['k5_launches_per_request']:.2f}"
           f" K5 calls a request" if http else "")
        + f"; K5 calls {k5_total}, K3 launches 0; samples equal to the "
        f"CPU searcher byte for byte; phase {wall:.2f} s; on {gpu}")
    return {"kinds": kinds, "layers": layers, "launches": launches,
            "k5_launches": k5_total, "k5_kernels": k5.kernels, "http": http,
            "wall_s": wall}


SCRIPT_L2 = 100                  # phase 12: knn_score l2 over match_all
SCRIPT_SPACE = 20                # ... cosinesimil, and innerproduct
SCRIPT_FILTERED = 20             # knn_score l2 under a bool filter child
SCRIPT_GENERAL = 20              # general sources (three forms in turn)
SCRIPT_MIN_SCORE = 10            # knn_score l2 with min_score
SCRIPT_PROFILE = 10              # knn_score l2 timed by layer
# The CPU searcher's answers are checked for every kind's first
# SCRIPT_CHECK_FIRST requests and for every filtered and min_score one:
# each CPU answer scores all 1M rows in the kernel's float64 order, and
# checking all 190 took most of a phase meant to take about a minute.
SCRIPT_CHECK_FIRST = 10
SCRIPT_CHECK_ALL = ("filtered", "min_score")
# knn_score l2 of two N(0, 1) 128-d vectors is 1 / (1 + ~256): this keeps
# the rows closer than 221 (about one in eight)
SCRIPT_MIN = 0.0045


def knn_score_body(vec, space, query=None, **extra) -> dict:
    """A ``script_score`` with the k-NN plugin's ``knn_score`` script on
    ``vec`` (BASELINE config 2), size 10."""
    return {"query": {"script_score": {
        "query": query or {"match_all": {}},
        "script": {"lang": "knn", "source": "knn_score",
                   "params": {"field": "vec", "query_value": vec,
                              "space_type": space}}, **extra}},
        "size": 10, "_source": False}


def source_body(source, params, query=None) -> dict:
    return {"query": {"script_score": {
        "query": query or {"match_all": {}},
        "script": {"source": source, "params": params}}},
        "size": 10, "_source": False}


def phase12_bodies() -> dict:
    """Phase 12's traffic, seeded: {kind: [(body, distinct vector
    functions, exact)]}, every vector new (so every request compiles and
    makes its own K1 launches).  ``exact``: the answer equals the CPU
    searcher's byte for byte (a script with ``Math.log`` runs CUDA's
    ``logf``, which may differ from the CPU's by an ulp: ids equal and
    scores within rtol 1e-5 / atol 1e-6)."""
    from opensearch_tpu_torch.testing import corpus

    rng = np.random.default_rng(71)
    width = int(corpus.PRICE_MAX * 0.4)

    def vec():
        return rng.standard_normal(DIM).astype(np.float32).tolist()

    def l2(n, **extra):
        return [(knn_score_body(vec(), "l2", **extra), 1, True)
                for _ in range(n)]

    filtered = []
    for _ in range(SCRIPT_FILTERED + 1):
        lo = int(rng.integers(0, corpus.PRICE_MAX - width))
        filtered.append((knn_score_body(vec(), "l2", query={"bool": {
            "filter": [{"range": {"price": {"gte": lo, "lt": lo + width}}},
                       {"term": {"tag": corpus.tag_name(
                           min(int(rng.zipf(1.3)) - 1, 4))}}]}}), 1, True))
    general = []
    pairs = corpus.zipf_query_log(SCRIPT_GENERAL + 2, seed=23)
    for i, (a, b) in enumerate(pairs):
        if i % 3 == 0:
            general.append((source_body(
                "cosineSimilarity(params.query_value, doc['vec']) + 1.0",
                {"query_value": vec()}), 1, True))
        elif i % 3 == 1:
            general.append((source_body(
                "_score * dotProduct(params.query_value, doc['vec'])",
                {"query_value": vec()},
                {"match": {"body": f"t{a} t{b}"}}), 1, True))
        else:
            general.append((source_body(
                "Math.log(doc['price'].value + params.offset)",
                {"offset": i + 1}), 0, False))
    return {"l2": l2(SCRIPT_L2),
            "cosinesimil": [(knn_score_body(vec(), "cosinesimil"), 1, True)
                            for _ in range(SCRIPT_SPACE)],
            "innerproduct": [(knn_score_body(vec(), "innerproduct"), 1,
                              True) for _ in range(SCRIPT_SPACE)],
            "filtered": filtered[1:], "general": general[2:],
            "min_score": l2(SCRIPT_MIN_SCORE, min_score=SCRIPT_MIN),
            "profile": l2(SCRIPT_PROFILE),
            "warm_up": l2(1) + filtered[:1] + general[1:2]}


def script_mismatch(got: dict, want: dict, exact: bool):
    """None when a script_score answer equals the CPU searcher's: byte
    for byte (ids, scores, totals) when ``exact``, else ids equal and
    scores within rtol 1e-5 / atol 1e-6."""
    from opensearch_tpu_torch.testing.parity import (bm25_mismatch,
                                                     knn_mismatch)
    if exact:
        return bm25_mismatch(got, want)
    if [h["_id"] for h in got["hits"]["hits"]] != \
            [h["_id"] for h in want["hits"]["hits"]]:
        return "ids differ"
    return knn_mismatch(got, want)


class ScriptClock:
    """Host seconds per request in ``ShardSearcher.compiled`` (parse,
    script compile and the K1 pre-pass, synchronized at its end), in
    ``ShardSearcher._topk`` less its merge (the per-segment plan path:
    prepare, the eager program and top-k of each segment, one read-back)
    and in ``_merge_topk`` + ``_response`` (the host merge and the
    response); installed only around the requests it times."""

    def __init__(self):
        import torch

        from opensearch_tpu_torch.search import executor

        self.t = {"compile_k1": 0.0, "topk": 0.0, "merge": 0.0,
                  "response": 0.0}
        sync = torch.cuda.synchronize
        clock = self
        cls = executor.ShardSearcher
        real = {n: cls.__dict__[n] for n in ("compiled", "_topk",
                                              "_merge_topk", "_response")}

        def timed(name, key, synced):
            def wrapper(self, *a, **kw):
                t0 = time.monotonic()
                out = real[name](self, *a, **kw)
                if synced:
                    sync()
                clock.t[key] += time.monotonic() - t0
                return out
            return wrapper

        self.patches = [(cls, "compiled", timed("compiled", "compile_k1",
                                                True)),
                        (cls, "_topk", timed("_topk", "topk", False)),
                        (cls, "_merge_topk", timed("_merge_topk", "merge",
                                                   False)),
                        (cls, "_response", timed("_response", "response",
                                                 False))]
        self.real = real

    def __enter__(self):
        for owner, name, new in self.patches:
            setattr(owner, name, new)
        return self

    def __exit__(self, *exc):
        for owner, name, _new in self.patches:
            setattr(owner, name, self.real[name])


def phase_http_script(node, state, counters) -> dict:
    """Phase 12's requests over HTTP, on phase 9's node before it stops
    (``phase_serving``'s ``then``, after ``phase_http_hybrid`` gave its
    ``corpus`` index -- SERVE_DOCS docs in 2 shards -- SERVE_VECTORS
    128-d ``vec`` values), merged by ``_forcemerge`` to one segment a
    shard: as in the reference, a vector function over a segment without
    the field's column answers 400, and the segments written before
    ``vec`` was mapped have none.  Then 10 ``script_score`` ``_search``
    requests to ``/corpus/_search`` (``knn_score`` in the three spaces
    over the docs with a ``vec``, one over ``match_all`` and one under a
    ``bool`` filter on ``tag``, ``_score`` times ``l2Squared`` over a
    ``match``, ``Math.sqrt`` of ``l2Squared``), their counts zeroed just
    before them and read just after (one K1 scores launch per request
    and vector function, no K1 top-k), each held to the CPU searcher."""
    from opensearch_tpu_torch.search.executor import ShardSearcher

    t_phase = time.monotonic()
    rng = np.random.default_rng(73)
    client = HttpClient(node.port)

    def vec():
        return rng.standard_normal(DIM).astype(np.float32).tolist()

    has_vec = {"exists": {"field": "vec"}}
    bodies = [(knn_score_body(vec(), space, has_vec), 1, True)
              for space in ("l2", "l2", "l2", "cosinesimil", "cosinesimil",
                            "innerproduct")]
    bodies += [(knn_score_body(vec(), "l2"), 1, True),
               (knn_score_body(vec(), "innerproduct", {"bool": {
                   "filter": [has_vec, {"term": {"tag": "red"}}]}}), 1,
                True),
               (source_body("_score * l2Squared(params.q, doc['vec'])",
                            {"q": vec()}, {"match": {"body": "t1 t2"}}),
                1, True),
               (source_body("1 / (1 + Math.sqrt(l2Squared(params.q, "
                            "doc['vec'])))", {"q": vec()}, has_vec), 1,
                False)]
    t0 = time.monotonic()
    client.ok("POST", "/corpus/_forcemerge?max_num_segments=1")
    merge_s = time.monotonic() - t0
    path = "/corpus/_search"
    client.ok("POST", path, knn_score_body(vec(), "l2", has_vec))  # warm-up
    for fn in counters.values():                # this path starts here
        fn.launches = 0
    qps, p50, out = timed_calls(lambda b: client.ok("POST", path, b[0]),
                                bodies)
    launches = {n: c.launches for n, c in counters.items()}
    want = sum(n for _b, n, _e in bodies)
    # (the match child and the tag filter run K2's dense entry)
    if launches["knn_scores"] != want or launches["knn_topk"] or \
            launches["plan_topk"] != len(bodies):
        raise AssertionError(f"phase 12 over HTTP: launches {launches}, "
                             f"want {want} K1 scores, no K1 top-k and one "
                             "plan top-k a request")
    svc = node.indices.get("corpus")
    segments = svc.searcher().segments
    cpu = ShardSearcher(segments, svc.mapper, index_name="corpus",
                        device="cpu")
    for (body, _n, exact), resp in zip(bodies, out):
        bad = script_mismatch(resp, json.loads(json.dumps(
            cpu.search(dict(body)))), exact)
        if bad or not resp["hits"]["hits"]:
            raise AssertionError(f"phase 12 over HTTP vs cpu: {bad}")
    client.close()
    return {"qps": qps, "p50_ms": p50, "requests": len(bodies),
            "launches": launches, "segments": len(segments),
            "docs": len(state.docs), "live_docs": state.live(),
            "shards": 2, "force_merge_s": merge_s,
            "wall_s": time.monotonic() - t_phase}


def phase_script_score(segs, mapper, searcher, counters, http=None) -> dict:
    """Phase 12: ``script_score`` at full width on phase 4's 16 f32
    segments (SIFT-1M's shape: 1,000,000 128-d float32 vectors, random
    from the seed, with the ``price`` / ``tag`` columns), BASELINE
    config 2's traffic (see the module doc); ``http`` is what
    ``phase_http_script`` returned on phase 9's node."""
    import torch

    from opensearch_tpu_torch.search.executor import ShardSearcher

    t_phase = time.monotonic()
    traffic = phase12_bodies()
    profile = traffic.pop("profile")
    # warm-up: each plan shape once (vectors of their own)
    for body, _n, _e in traffic.pop("warm_up"):
        searcher.search(dict(body))
    torch.cuda.synchronize()
    for fn in counters.values():                # this path starts here
        fn.launches = 0
    kinds, outs = {}, {}
    for kind, items in traffic.items():
        before = counters["knn_scores"].launches
        plan0 = counters["plan_topk"].launches
        dense0 = counters["term_bag_scores"].launches
        qps, p50, out = timed_calls(lambda b: searcher.search(dict(b[0])),
                                    items)
        got = counters["knn_scores"].launches - before
        want = sum(n for _b, n, _e in items)
        if got != want:
            raise AssertionError(f"phase 12 {kind}: {got} K1 scores "
                                 f"launches for {len(items)} requests, not "
                                 f"{want}")
        if counters["plan_topk"].launches - plan0 != len(items):
            raise AssertionError(f"phase 12 {kind}: "
                                 f"{counters['plan_topk'].launches - plan0} "
                                 f"plan top-k launches for {len(items)} "
                                 "requests")
        # one dense launch per request and term-bag leaf: the filtered
        # kind's tag term, the general kind's match children
        dense = counters["term_bag_scores"].launches - dense0
        if dense != sum(json.dumps(b).count('"match": {"body"') + json.dumps(
                b).count('"term": {"tag"') for b, _n, _e in items):
            raise AssertionError(f"phase 12 {kind}: {dense} dense launches")
        kinds[kind] = {"qps": qps, "p50_ms": p50, "requests": len(items),
                       "k1_scores_per_request": got / len(items)}
        outs[kind] = out
    launches = {n: c.launches for n, c in counters.items()}
    if launches["knn_topk"]:
        raise AssertionError(f"phase 12: {launches['knn_topk']} K1 top-k "
                             "launches")
    n_req = sum(len(v) for v in traffic.values())
    all_qps = n_req / sum(v["requests"] / v["qps"] for v in kinds.values())
    # where a request's time goes (knn_score l2, synchronized layers)
    with ScriptClock() as clock:
        t0 = time.monotonic()
        for body, _n, _e in profile:
            searcher.search(dict(body))
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    n = len(profile)
    layers = {"ms_per_request": wall / n * 1e3,
              "compile_and_k1_ms": clock.t["compile_k1"] / n * 1e3,
              "plan_path_ms": (clock.t["topk"] - clock.t["merge"]) / n * 1e3,
              "merge_and_response_ms": (clock.t["merge"]
                                        + clock.t["response"]) / n * 1e3}
    # the checked answers against the CPU searcher (SCRIPT_CHECK_*); every
    # l2 top-10 against a knn query on the card
    cpu = ShardSearcher(segs, mapper, index_name=searcher.index_name,
                        device="cpu")
    t_cpu = time.monotonic()
    checked = {}
    for kind, items in traffic.items():
        n = len(items) if kind in SCRIPT_CHECK_ALL else SCRIPT_CHECK_FIRST
        checked[kind] = min(n, len(items))
        for i, ((body, _n, exact), got) in enumerate(
                zip(items[:n], outs[kind])):
            got = json.loads(json.dumps(got))
            bad = script_mismatch(got, json.loads(json.dumps(
                cpu.search(dict(body)))), exact)
            if bad or (kind != "min_score" and not got["hits"]["hits"]):
                raise AssertionError(f"phase 12 {kind} #{i} vs the CPU "
                                     f"searcher: {bad or 'no hits'}")
    cpu_s = time.monotonic() - t_cpu
    del cpu
    for (body, _n, _e), got in zip(traffic["l2"], outs["l2"]):
        vec = body["query"]["script_score"]["script"]["params"][
            "query_value"]
        knn = searcher.search({"query": {"knn": {"vec": {
            "vector": vec, "k": 10}}}, "size": 10, "_source": False})
        if [h["_id"] for h in got["hits"]["hits"]] != \
                [h["_id"] for h in knn["hits"]["hits"]]:
            raise AssertionError("phase 12: knn_score l2 top-10 ids differ "
                                 "from the knn query's")
    if http:
        for name, v in http["launches"].items():
            launches[name] += v
    phase_s = time.monotonic() - t_phase
    gpu = gpu_name_power()
    log("script_score: "
        + "; ".join(f"{k}: qps {v['qps']:.2f}, p50 {v['p50_ms']:.3f} ms, "
                    f"{v['k1_scores_per_request']:.2f} K1 scores launches a "
                    f"request" for k, v in kinds.items())
        + f"; all {n_req}: qps {all_qps:.2f}; knn_score l2 per request "
        f"(ms, synchronized): {layers['ms_per_request']:.3f} = compile + K1 "
        f"{layers['compile_and_k1_ms']:.3f} + per-segment plan path "
        f"{layers['plan_path_ms']:.3f} + merge and response "
        f"{layers['merge_and_response_ms']:.3f} + rest; K1 top-k launches "
        f"0; {sum(checked.values())} of {n_req} answers equal to the CPU "
        f"searcher's ({checked}; cut for time: the rest of each kind's, "
        f"{cpu_s:.1f} s on the CPU); every l2 top-10 equal to the knn "
        f"query's"
        + (f"; over HTTP on phase 9's corpus index ({http['requests']} "
           f"requests, {http['docs']} docs in {http['shards']} shards, "
           f"{http['segments']} segments): qps {http['qps']:.2f}, p50 "
           f"{http['p50_ms']:.3f} ms" if http else "")
        + f"; phase {phase_s:.2f} s; on {gpu}")
    return {"kinds": kinds, "qps": all_qps, "requests": n_req,
            "layers": layers, "launches": launches, "http": http,
            "cpu_checked": checked, "cpu_check_s": cpu_s,
            "wall_s": phase_s}


# -- phase 2: K6 and K7 ------------------------------------------------------

def ann_hits_mismatch(got: dict, want: dict):
    """None when two ANN responses hold the same ids in the same order
    with scores within rtol 1e-5 / atol 1e-6 (the card and the CPU sum
    in the same float64 order, so they are equal in practice), else a
    message."""
    from opensearch_tpu_torch.ops.knn import ATOL, RTOL

    gh, wh = got["hits"]["hits"], want["hits"]["hits"]
    if [h["_id"] for h in gh] != [h["_id"] for h in wh]:
        return (f"ids differ: {[h['_id'] for h in gh]} vs "
                f"{[h['_id'] for h in wh]}")
    for g, w in zip(gh, wh):
        if abs(g["_score"] - w["_score"]) > ATOL + RTOL * abs(w["_score"]):
            return f"scores differ: {g} vs {w}"
    return None


def ivf_check_sets(dev, gen, d: int, pq: bool) -> list:
    """(staged index, live mask) of four segments of clustered d-wide
    vectors trained on the card: 20,000 rows (nlist 141), 600 (nlist
    24), 40 rows in 30 clusters (most of one row) and 12,000 (nlist
    271); some rows without the field, ~10% of every live mask
    deleted."""
    import torch

    from opensearch_tpu_torch.index.segment import pad_pow2
    from opensearch_tpu_torch.ops import ivf
    from opensearch_tpu_torch.testing.corpus import clustered_vectors

    m = 3 if d == 3 else 10
    out = []
    for s, (n, nlist) in enumerate(((20_000, 141), (600, 24), (40, 30),
                                    (12_000, 271))):
        x = clustered_vectors(n, d, 64, seed=40 + s)
        valid = np.ones(n, bool)
        valid[s::13] = False
        idx = (ivf.IvfPqIndex.build(x, valid, nlist, m=m, device=dev) if pq
               else ivf.IvfIndex.build(x, valid, nlist, device=dev))
        live = torch.rand(pad_pow2(n + 1), device=dev, generator=gen) > 0.1
        out.append((ivf.stage_index(idx, dev), live))
    return out


def ivf_skew_sets(dev, gen, d: int, pq: bool, m: int = 0,
                  names=None) -> list:
    """(staged index, live mask) of the layouts of ``testing/ann.py``
    ``SKEWED`` (those of ``names``, else all), laid out by hand (IVF-PQ:
    ``m`` subspaces, else 3 at d = 3 and 10), ~10% of every live mask
    deleted."""
    import torch

    from opensearch_tpu_torch.index.segment import pad_pow2
    from opensearch_tpu_torch.ops import ivf
    from opensearch_tpu_torch.testing import ann

    m = (m or (3 if d == 3 else 10)) if pq else 0
    out = []
    for s, (name, sizes) in enumerate(ann.SKEWED.items()):
        if names and name not in names:
            continue
        idx = ann.skewed_index(sizes, d, m, seed=50 + s)
        live = torch.rand(pad_pow2(sum(sizes) + 1), device=dev,
                          generator=gen) > 0.1
        out.append((ivf.stage_index(idx, dev), live))
    return out


def phase_ivf_kernels(dev, gen) -> dict:
    """K6 (``ivf_search_segments_cuda``) and K7
    (``ivfpq_search_segments_cuda``) byte-equal to their plain twins
    (``ops/ivf.py`` ``ivf_search_segments`` / ``ivfpq_search_segments``)
    and launch to launch: the segments of ``ivf_check_sets`` in one
    call, those of ``ivf_skew_sets`` in another, and 3 queries at d = 3
    and 100; then two skewed layouts at ``ann.WIDE_D`` = 768 (K7 at m =
    8 and at m = ``cuda_ivf.M_MAX``); K6 in the three spaces, K7 in l2;
    nprobe 1, nlist // 8 and nlist; k 1, 10, K_MAX and K_MAX + 1 (the
    sorted route, counted),
    each capped at a segment's candidates as the compiler caps it; one
    launch per call and route.  Phase 13 times them at the main path's
    shape."""
    import torch

    from opensearch_tpu_torch.ops import cuda_ivf, ivf
    from opensearch_tpu_torch.testing import ann
    from opensearch_tpu_torch.testing.corpus import clustered_vectors

    t0 = time.monotonic()
    checked = 0
    for pq in (False, True):
        fn = (cuda_ivf.ivfpq_search_segments_cuda if pq
              else cuda_ivf.ivf_search_segments_cuda)
        groups = [(3, ivf_check_sets, 0), (100, ivf_check_sets, 0),
                  (3, ivf_skew_sets, 0), (100, ivf_skew_sets, 0)]
        groups += [(ann.WIDE_D, ivf_skew_sets, m)
                   for m in (ann.WIDE_MS if pq else (0,))]
        for d, make, m_wide in groups:
            sets = (make(dev, gen, d, pq) if d != ann.WIDE_D else
                    make(dev, gen, d, pq, m_wide,
                         names=("full_cluster", "nlist_3")))
            qs = torch.from_numpy(clustered_vectors(3, d, 64, seed=40)).to(
                dev)
            if make is ivf_skew_sets:     # near the largest cluster's rows
                st0 = sets[0][0]
                qs = torch.stack([st0.rows[ann.TIE_STRIDE - 2] if st0.rows
                                  is not None else qs[0],
                                  st0.centroids[0], st0.centroids[-1]])
            spaces = ("l2",) if pq else ("l2", "cosinesimil",
                                         "innerproduct")
            for space in spaces:
                for rule in ("1", "nlist // 8", "nlist"):
                    for k in (1, 10, cuda_ivf.K_MAX, cuda_ivf.K_MAX + 1):
                        items = []
                        for st, live in sets:
                            nprobe = {"1": 1, "nlist": st.nlist}.get(
                                rule, max(1, st.nlist // 8))
                            items.append(ivf.IvfSegment(
                                st, live, nprobe,
                                min(k, live.shape[0], nprobe * st.c_pad)))
                        before = (fn.launches, fn.sorted_route_segments)

                        def call():
                            return (fn(items, qs) if pq
                                    else fn(items, qs, space=space))
                        got = call()
                        moved = (fn.launches - before[0],
                                 fn.sorted_route_segments - before[1])
                        big = sum(s.k > cuda_ivf.K_MAX for s in items)
                        if moved != (int(big < len(items)) + int(big > 0),
                                     big):
                            raise AssertionError(
                                f"K{7 if pq else 6} {make.__name__} d={d} "
                                f"{rule} k={k}: "
                                f"{moved} launches / sorted segments, "
                                f"want {big} sorted")
                        again = call()
                        want = (ivf.ivfpq_search_segments(items, qs) if pq
                                else ivf.ivf_search_segments(items, qs,
                                                             space=space))
                        for name, (a, b) in (("plain", (got, want)),
                                             ("run-to-run", (got, again))):
                            if not (torch.equal(a[0].view(torch.int32),
                                                b[0].view(torch.int32))
                                    and torch.equal(a[1], b[1])):
                                raise AssertionError(
                                    f"K{7 if pq else 6} {make.__name__} "
                                    f"d={d} m={m_wide} {space} "
                                    f"nprobe {rule} k={k}: not byte-equal "
                                    f"({name})")
                        checked += 1
        log(f"K{7 if pq else 6} ({'IVF-PQ, l2' if pq else 'IVF, 3 spaces'})"
            f": byte-equal to its plain twin and run to run at d = 3 and "
            f"100, nprobe 1 / nlist // 8 / nlist, k 1 / 10 / K_MAX / "
            f"K_MAX + 1, 4 trained segments (deletes, rows without the "
            f"field, clusters of one row, nlist 271) or the 5 skewed "
            f"layouts (a cluster of c_pad rows, one holding most of a "
            f"segment, nlist 1, 3 and 2,000, ties across chunk "
            f"boundaries) x 3 queries a call; two skewed layouts at d = "
            f"{ann.WIDE_D}" + (f", m = {' and '.join(map(str, ann.WIDE_MS))}"
                               if pq else ""))
    checked += ivf_back_to_back(dev, gen)
    log(f"K6 / K7 checks: {checked} calls in {time.monotonic() - t0:.1f}s")
    return {"checked_calls": checked, "max_abs_err": 0.0}


def ivf_back_to_back(dev, gen, n_calls: int = 96) -> int:
    """K6 (three spaces) and K7 calls queued back to back with no sync
    between them, the kernels after each probe starting as programmatic
    dependents while the card still runs earlier calls: K6 and K7 in
    turn over the skewed layouts at d = 100, each call its own query,
    nprobe and k; then each result held to its plain twin byte for
    byte.  Returns the calls checked."""
    import torch

    from opensearch_tpu_torch.ops import cuda_ivf, ivf
    from opensearch_tpu_torch.testing.corpus import clustered_vectors

    sets = {pq: ivf_skew_sets(dev, gen, 100, pq) for pq in (False, True)}
    qs = torch.from_numpy(clustered_vectors(n_calls, 100, 64, seed=41)).to(
        dev)
    spaces = ("l2", "cosinesimil", "innerproduct")
    jobs = []
    for i in range(n_calls):
        pq = i % 2 == 1
        items = [ivf.IvfSegment(st, live, max(1, st.nlist * (i % 5) // 4),
                                min((1, 10, 100)[i % 3], st.c_pad))
                 for st, live in sets[pq]]
        q = qs[i: i + 1]
        space = "l2" if pq else spaces[(i // 2) % 3]
        got = (cuda_ivf.ivfpq_search_segments_cuda(items, q) if pq else
               cuda_ivf.ivf_search_segments_cuda(items, q, space=space))
        jobs.append((pq, items, q, space, got))
    for i, (pq, items, q, space, got) in enumerate(jobs):
        want = (ivf.ivfpq_search_segments(items, q) if pq else
                ivf.ivf_search_segments(items, q, space=space))
        if not (torch.equal(got[0].view(torch.int32),
                            want[0].view(torch.int32))
                and torch.equal(got[1], want[1])):
            raise AssertionError(f"K{7 if pq else 6} back-to-back call {i} "
                                 f"({space}): not byte-equal (plain)")
    log(f"K6 / K7: {n_calls} calls queued back to back, each byte-equal "
        f"to its plain twin")
    return n_calls


def phase_ivf_searcher(dev) -> None:
    """A ``knn`` on an ``ivf`` field over three segments, one without the
    field, on the card equal to the CPU searcher (one K6 launch)."""
    from opensearch_tpu_torch.index.segment import Segment
    from opensearch_tpu_torch.mapping.mapper import DocumentMapper
    from opensearch_tpu_torch.ops import cuda_ivf
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing import corpus

    x = corpus.clustered_vectors(4_000, 100, 64, seed=44)
    segs = corpus.vector_segments(x, 2, similarity="cosinesimil")
    bare = Segment("no_vectors", 10)
    bare.doc_ids = [f"b{i}" for i in range(10)]
    bare.id_to_local = {d: i for i, d in enumerate(bare.doc_ids)}
    bare.sources = [b"{}"] * 10
    segs.insert(1, bare)
    mapper = DocumentMapper({"properties": {"vec": {
        "type": "knn_vector", "dimension": 100,
        "method": {"name": "ivf", "space_type": "cosinesimil"}}}})
    card = ShardSearcher(segs, mapper, device=dev)
    cpu = ShardSearcher(segs, mapper, device="cpu")
    fn = cuda_ivf.ivf_search_segments_cuda
    for q in corpus.clustered_vectors(5, 100, 64, seed=45):
        body = {"size": 10, "query": {"knn": {"vec": {
            "vector": q.tolist(), "k": 10}}}}
        before = fn.launches
        got = card.search(body)
        if fn.launches - before != 1:
            raise AssertionError("ivf searcher: not one K6 launch a query")
        bad = ann_hits_mismatch(got, cpu.search(body))
        if bad or len(got["hits"]["hits"]) != 10:
            raise AssertionError(f"ivf searcher vs cpu: {bad}")
    log("K6 through ShardSearcher over 3 segments (one without the "
        "field): 5 queries equal to the CPU searcher, one launch each")


# -- phase 13 -----------------------------------------------------------------

ANN_DOCS = 1_183_514             # testing/ann.py DOCS: GloVe-100's shape
ANN_KINDS = {"cos_default": 100, "cos_nprobe8": 50, "cos_full": 50,
             "l2_pq": 100, "filtered": 20}
ANN_CHECK = 5                    # of each ANN kind, held to the CPU searcher
ANN_FILTER_CHECK = 2             # ... of the filtered (exact) kind
ANN_FILTER = {"range": {"price": {"lt": 4000}}}
# distinct knn bodies each ANN searcher answers before the timed windows:
# a searcher keeps each body's prepared columns (its winners, n_pad a
# segment) in a cache of 1,024 (query, segment) entries, and the first
# ~64 distinct 16-segment queries grow the device pool (5 cudaMalloc a
# query); the windows measure the state a serving node settles in
ANN_WARM = 70
HTTP_ANN_VECTORS = 5_000
HTTP_ANN_REQUESTS = 10


def time_ivf_kernels(segs, flat, pqs, held, dev) -> dict:
    """K6 and K7 at the main path's shape (the 16 segments, default
    nprobe, k = 10, one query): ms per call in turns with the plain twin,
    the probe's and the scan's own device ms, the bound, ``torch.topk``
    over ``flat_v @ q`` of the probed rows as the library yardstick, and
    exact K1 over the same segments."""
    import torch

    from opensearch_tpu_torch.ops import cuda_ivf, cuda_knn, ivf, knn
    from opensearch_tpu_torch.testing.k6_sweep import ivf_bound, kernels_ms

    q = torch.from_numpy(held[:1].copy()).to(dev)
    out = {}
    live = [seg.device(dev).live for seg in segs]
    k1_segs = [knn.KnnSegment(seg.device(dev).vector["vec"]["values"],
                              seg.device(dev).vector["vec"]["exists"], lv)
               for seg, lv in zip(segs, live)]
    k1_ms = cuda_ms(lambda: cuda_knn.knn_topk_segments_cuda(
        k1_segs, q[0], space="cosinesimil", k=10), 20)
    k1_dev = kernel_device_ms(lambda: cuda_knn.knn_topk_segments_cuda(
        k1_segs, q[0], space="cosinesimil", k=10), 20, "knn_topk_kernel")
    for name, pq, staged, space in (
            ("ivf_search", False, flat, "cosinesimil"),
            ("ivfpq_search", True, pqs, "l2")):
        items = [ivf.IvfSegment(st, lv, max(1, st.nlist // 8), 10)
                 for st, lv in zip(staged, live)]
        if pq:
            def kernel():
                return cuda_ivf.ivfpq_search_segments_cuda(items, q)

            def plain():
                return ivf.ivfpq_search_segments(items, q)
        else:
            def kernel():
                return cuda_ivf.ivf_search_segments_cuda(items, q,
                                                         space=space)

            def plain():
                return ivf.ivf_search_segments(items, q, space=space)
        got, want = kernel(), plain()
        err = float((got[0] - want[0]).abs().nan_to_num(0.0).max())
        if not torch.equal(got[1], want[1]):
            raise AssertionError(f"{name} at the main path's shape: ids "
                                 "differ from the plain twin")
        ms, plain_ms = in_turns(kernel, plain, 5)
        per, dev_ms, span = kernels_ms(kernel)
        per = per or {}
        probe_dev = per.get("ivf_probe_kernel")
        table_dev = per.get("ivfpq_lut_kernel") if pq else None
        scan_dev = per.get("ivfpq_scan_kernel" if pq else "ivf_scan_kernel")
        # the library yardstick: the probed rows (flat layout) of each
        # segment, gathered beforehand
        fvs = []
        for st, it in zip(flat, items):
            rows, _f = ivf._probed(st, ivf.probe(st.centroids, q[0],
                                                 it.nprobe))
            fvs.append(st.rows[rows])
        lib_ms = cuda_ms(lambda: [torch.topk(fv @ q[0], 10) for fv in fvs],
                         20)
        nbytes, flops = ivf_bound(items, q[0], pq)
        bms, by = bound_ms(nbytes, flops, FP64_FLOPS_PER_S)
        out[name] = {"ms": ms, "device_ms": dev_ms, "span_ms": span,
                     "probe_device_ms": probe_dev, "scan_device_ms": scan_dev,
                     "table_device_ms": table_dev,
                     "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": bms, "bound_by": by, "bound_bytes": nbytes,
                     "max_abs_err": err, "k1_exact_ms": k1_ms,
                     "k1_exact_device_ms": k1_dev,
                     "probed_rows": sum(fv.shape[0] for fv in fvs)}
        log(f"K{7 if pq else 6} {name} over {len(items)} segments, nprobe "
            f"{items[0].nprobe}, k=10, one query: ms {ms:.4f} device_ms "
            f"{dev_ms} (probe {probe_dev}, "
            + (f"table pass {table_dev}, " if pq else "")
            + f"scan {scan_dev}; span a call {span}) plain_ms "
            f"{plain_ms:.4f} library_ms (topk(flat_v @ q) over "
            f"{out[name]['probed_rows']} probed rows) {lib_ms:.4f} bound_ms "
            f"{bms:.6f} ({by}: {nbytes} bytes); exact K1 over the same "
            f"segments {k1_ms:.4f} ms, device {k1_dev}; on "
            f"{gpu_name_power()}")
    return out


def byte_equal_indexes(a, b) -> bool:
    import torch

    for name in a.__dataclass_fields__:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or x.shape != y.shape:
                return False
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            if not torch.equal(x, y):
                return False
        elif x != y:
            return False
    return True


def phase_ann(counters) -> dict:
    """Phase 13: ANN at GloVe-100's shape (module doc)."""
    import torch

    from opensearch_tpu_torch.ops import cuda_ivf, ivf
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing import ann

    t_phase = time.monotonic()
    dev = torch.device(DEVICE)
    # a held-out query per request, and one more per kind to warm up (a
    # searcher caches a compiled body, so a repeated one launches nothing)
    segs, held = ann.corpus_segments(
        ANN_DOCS, sum(ANN_KINDS.values()) + len(ANN_KINDS) + 2 * ANN_WARM)
    searchers = {name: ShardSearcher(segs, ann.mapper(space, method),
                                     index_name="glove", device=dev)
                 for name, space, method in (
                     ("cos", "cosinesimil", True), ("l2", "l2", True),
                     ("cos_exact", "cosinesimil", False),
                     ("l2_exact", "l2", False))}
    torch.cuda.synchronize()
    corpus_s = time.monotonic() - t_phase
    # training and staging (warm-up, outside the timed windows)
    builds = {}
    for name in ("ivf_pq", "ivf"):
        t0 = time.monotonic()
        for seg in segs:
            seg.ann_index("vec", {"name": name, "m": ann.M}, dev)
        torch.cuda.synchronize()
        builds[name] = (time.monotonic() - t0) / len(segs)
    nlist = segs[0].ann_index("vec", {"name": "ivf", "m": ann.M}, dev).nlist
    flat, pqs, ref_bytes = [], [], {"ivf": 0, "ivf_pq": 0}
    for seg in segs:
        dseg = seg.device(dev)
        for name, out in (("ivf", flat), ("ivf_pq", pqs)):
            idx = seg.ann_index("vec", {"name": name, "m": ann.M}, dev)
            out.append(dseg.ann_staged(idx))
            cells = idx.nlist * idx.c_pad
            ref_bytes[name] += (idx.centroids.numel() * 4 + cells * 5 + (
                cells * ann.M + idx.codebooks.numel() * 4 if name == "ivf_pq"
                else cells * ann.DIM * 4))
    staged_bytes = {"ivf": sum(st.nbytes() for st in flat),
                    "ivf_pq": sum(st.nbytes() for st in pqs)}
    # two trainings of one segment on the card: byte-equal
    dv = segs[0].vector_dv["vec"]
    for cls, kw in ((ivf.IvfIndex, {}), (ivf.IvfPqIndex, {"m": ann.M})):
        a = cls.build(dv.values, dv.exists, nlist, device=dev, **kw)
        b = cls.build(dv.values, dv.exists, nlist, device=dev, **kw)
        if not byte_equal_indexes(a, b):
            raise AssertionError(f"phase 13: two {cls.__name__} trainings "
                                 "of one segment differ")
        del a, b
    log(f"ANN corpus: {ANN_DOCS} x {ann.DIM} clustered vectors "
        f"({ann.CENTERS} centres) in {len(segs)} segments of "
        f"{segs[0].n_docs}, nlist {nlist}, c_pad {flat[0].c_pad}; built in "
        f"{corpus_s:.1f}s; training per segment: ivf_pq "
        f"{builds['ivf_pq']:.3f}s, ivf {builds['ivf']:.3f}s; two trainings "
        f"byte-equal; staged bytes ivf {staged_bytes['ivf']} / ivf_pq "
        f"{staged_bytes['ivf_pq']} against the reference's padded layout "
        f"{ref_bytes['ivf']} / {ref_bytes['ivf_pq']}")

    qs = iter(held)
    extra = {"cos_default": {}, "cos_nprobe8": {
        "method_parameters": {"nprobe": 8}}, "cos_full": {
        "method_parameters": {"nprobe": nlist}}, "l2_pq": {},
        "filtered": {"filter": ANN_FILTER}}
    on = {"cos_default": "cos", "cos_nprobe8": "cos", "cos_full": "cos",
          "l2_pq": "l2", "filtered": "cos"}
    for name in ("cos", "l2"):                  # warm-up (ANN_WARM)
        for _ in range(ANN_WARM):
            searchers[name].search(ann.body(next(qs)))
    bodies = {}
    for kind, n in ANN_KINDS.items():
        searchers[on[kind]].search(ann.body(next(qs), **extra[kind]))
        bodies[kind] = [ann.body(next(qs), **extra[kind]) for _ in range(n)]
    torch.cuda.synchronize()
    k6, k7 = (cuda_ivf.ivf_search_segments_cuda,
              cuda_ivf.ivfpq_search_segments_cuda)
    every = {**counters, "ivf_search": k6, "ivfpq_search": k7}
    for fn in every.values():                   # this path starts here
        fn.launches = 0
    results, kinds = {}, {}
    for kind, group in bodies.items():
        before = {n: fn.launches for n, fn in every.items()}
        qps, p50, out = timed_calls(searchers[on[kind]].search, group)
        moved = {n: fn.launches - before[n] for n, fn in every.items()}
        results[kind] = out
        kinds[kind] = {"qps": qps, "p50_ms": p50, "queries": len(group),
                       "k6_per_query": moved["ivf_search"] / len(group),
                       "k7_per_query": moved["ivfpq_search"] / len(group),
                       "k1_topk_per_query": moved["knn_topk"] / len(group)}
        want = {"l2_pq": (0, 1, 0), "filtered": (0, 0, 1)}.get(kind,
                                                               (1, 0, 0))
        if (moved["ivf_search"], moved["ivfpq_search"],
                moved["knn_topk"]) != tuple(w * len(group) for w in want):
            raise AssertionError(f"phase 13 {kind}: launches {moved}, want "
                                 f"K6 / K7 / K1 {want} a query")
    launches = {n: fn.launches for n, fn in every.items()}
    # recall@10 against exact K1 on the card; nprobe = nlist is exact
    for kind, out in results.items():
        if kind == "filtered":
            continue
        exact = searchers["l2_exact" if kind == "l2_pq" else "cos_exact"]
        hits = []
        for body, resp in zip(bodies[kind], out):
            ids = [h["_id"] for h in resp["hits"]["hits"]]
            truth = [h["_id"] for h in exact.search(body)["hits"]["hits"]]
            if kind == "cos_full" and ids != truth:
                raise AssertionError(f"phase 13 nprobe = nlist: ids {ids} "
                                     f"differ from exact K1's {truth}")
            hits.append(len(set(ids) & set(truth)) / len(truth))
        kinds[kind]["recall_at_10"] = float(np.mean(hits))
    # a sample held to the CPU searcher over the same segments (it reuses
    # the indexes trained on the card)
    cpu = {name: ShardSearcher(segs, ann.mapper(space, True),
                               index_name="glove", device="cpu")
           for name, space in (("cos", "cosinesimil"), ("l2", "l2"))}
    checked = 0
    for kind, out in results.items():
        n = ANN_FILTER_CHECK if kind == "filtered" else ANN_CHECK
        for body, resp in list(zip(bodies[kind], out))[:n]:
            bad = ann_hits_mismatch(resp, cpu[on[kind]].search(body))
            if bad:
                raise AssertionError(f"phase 13 {kind} vs cpu: {bad}")
            checked += 1
    kern = time_ivf_kernels(segs, flat, pqs, held, dev)
    log("ann: " + "; ".join(
        f"{kind} {v['qps']:.2f} qps p50 {v['p50_ms']:.3f} ms"
        + (f" recall@10 {v['recall_at_10']:.4f}" if "recall_at_10" in v
           else "")
        + f" K6/K7/K1 a query {v['k6_per_query']:.2f}/"
          f"{v['k7_per_query']:.2f}/{v['k1_topk_per_query']:.2f}"
        for kind, v in kinds.items())
        + f"; {checked} answers equal to the CPU searcher (a sample: "
        f"{ANN_CHECK} of each ANN kind, {ANN_FILTER_CHECK} filtered); "
        f"{time.monotonic() - t_phase:.1f}s")
    return {"kinds": kinds, "launches": launches, "nlist": nlist,
            "c_pad": flat[0].c_pad, "build_s_per_segment": builds,
            "staged_bytes": staged_bytes, "reference_padded_bytes": ref_bytes,
            "checked_vs_cpu": checked, "kernels": kern,
            "wall_s": time.monotonic() - t_phase}


def phase_http_ann(node, state, counters) -> dict:
    """Over HTTP on phase 9's node before it stops: an index ``ann``
    (``vec``: 100 dims, ``ivf`` in the cosine space) fed
    HTTP_ANN_VECTORS clustered vectors by ``_bulk``, then
    HTTP_ANN_REQUESTS ``knn`` ``_search`` requests, their counts zeroed
    just before them and read just after (one K6 launch each), each held
    to the CPU searcher over the index's segments."""
    from opensearch_tpu_torch.ops import cuda_ivf
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing import ann
    from opensearch_tpu_torch.testing.corpus import clustered_vectors

    t_phase = time.monotonic()
    client = HttpClient(node.port)
    client.ok("PUT", "/ann", {"mappings": {"properties": {"vec": {
        "type": "knn_vector", "dimension": ann.DIM,
        "method": {"name": "ivf", "space_type": "cosinesimil"}}}}})
    # the vectors, the requests' query vectors, and a warm-up's (a node
    # caches a compiled body, so a repeated one launches nothing)
    x = clustered_vectors(HTTP_ANN_VECTORS + HTTP_ANN_REQUESTS + 1, ann.DIM,
                          64, seed=74)
    for lo in range(0, HTTP_ANN_VECTORS, SERVE_BULK):
        lines = []
        for i in range(lo, min(lo + SERVE_BULK, HTTP_ANN_VECTORS)):
            lines += [{"index": {"_index": "ann", "_id": f"a{i}"}},
                      {"vec": x[i].tolist()}]
        if client.ok("POST", "/_bulk", ndjson=lines)["errors"]:
            raise AssertionError("phase 9 ANN: _bulk reported errors")
    client.ok("POST", "/ann/_refresh")
    bodies = [ann.body(q) for q in x[HTTP_ANN_VECTORS: -1]]
    client.ok("POST", "/ann/_search", ann.body(x[-1]))   # trains the indexes
    every = {**counters, "ivf_search": cuda_ivf.ivf_search_segments_cuda}
    for fn in every.values():                   # this path starts here
        fn.launches = 0
    qps, p50, out = timed_calls(
        lambda b: client.ok("POST", "/ann/_search", b), bodies)
    launches = {n: c.launches for n, c in every.items()}
    if launches["ivf_search"] != len(bodies) or launches["knn_topk"]:
        raise AssertionError(f"phase 9 ANN over HTTP: launches {launches}, "
                             "want one K6 launch a request and no K1")
    svc = node.indices.get("ann")
    cpu = ShardSearcher(svc.searcher().segments, svc.mapper,
                        index_name="ann", device="cpu")
    for body, resp in zip(bodies, out):
        bad = ann_hits_mismatch(resp, json.loads(json.dumps(
            cpu.search(dict(body)))))
        if bad or len(resp["hits"]["hits"]) != 10:
            raise AssertionError(f"phase 9 ANN over HTTP vs cpu: {bad}")
    client.ok("DELETE", "/ann")
    client.close()
    return {"qps": qps, "p50_ms": p50, "requests": len(bodies),
            "launches": launches, "wall_s": time.monotonic() - t_phase}


def phase_http_phrase(node, state, counters) -> dict:
    """Over HTTP on phase 9's node before it stops: HTTP_PHRASES
    requests to ``corpus`` (20,000 rendered docs in 2 shards): 6
    ``match_phrase`` ``_search`` bodies and 4 URI searches, 2 of a quoted
    ``q=body:"..."`` (a ``match_phrase``) and 2 of a bare ``q`` (a
    ``multi_match`` over every text field), their counts zeroed just
    before them and read just after (K8 launches; no K1, K3 or K4), each
    answer's hits equal to the CPU searcher's."""
    from urllib.parse import quote

    from opensearch_tpu_torch.ops import cuda_positions
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing import corpus

    k8 = cuda_positions.phrase_scores_cuda
    runs = corpus.phrase_query_log(HTTP_PHRASES, seed=49,
                                   n_docs=SERVE_DOCS, corpus_seed=44,
                                   lengths=(2, 3))
    requests = []
    for i, run in enumerate(runs):
        text = " ".join(f"t{t}" for t in run)
        if i < 6:
            q = {"match_phrase": {"body": text}}
            requests.append(("POST", "/corpus/_search", {"query": q}, q))
        else:
            qs = f'body:"{text}"' if i < 8 else text
            requests.append(("GET", f"/corpus/_search?q={quote(qs)}", None,
                             {"query_string": {"query": qs}}))
    client = HttpClient(node.port)
    every = {**counters, "phrase_freqs": k8}
    for fn in every.values():                   # this path starts here
        fn.launches = 0
    qps, p50, out = timed_calls(
        lambda r: client.ok(r[0], r[1], r[2]), requests)
    launches = {n: c.launches for n, c in every.items()}
    if launches["phrase_freqs"] <= 0 or launches["knn_topk"] or \
            launches["batch_topk"] or launches.get("term_bag_quantized_topk"):
        raise AssertionError(f"phase 9 phrases over HTTP: launches "
                             f"{launches}")
    svc = node.indices.get("corpus")
    cpu = ShardSearcher(svc.searcher().segments, svc.mapper,
                        index_name="corpus", device="cpu")
    for (_m, path, _b, query), resp in zip(requests, out):
        want = json.loads(json.dumps(cpu.search({"query": query})))
        if resp["hits"] != want["hits"]:
            raise AssertionError(f"phase 9: {path} {json.dumps(query)} "
                                 "over HTTP differs from the CPU searcher")
    found = sum(bool(r["hits"]["hits"]) for r in out)
    if found < len(out) - 1:
        raise AssertionError(f"phase 9 phrases over HTTP: {found} of "
                             f"{len(out)} found a hit")
    client.close()
    return {"qps": qps, "p50_ms": p50, "requests": len(requests),
            "found": found, "launches": launches,
            "k8_launches_per_request": launches["phrase_freqs"]
            / len(requests)}


# -- phase 14 ----------------------------------------------------------------

PHRASE_KINDS = {"phrase": 100, "phrase_t0": 20, "phrase_prefix": 20,
                "multi_match": 20, "span_ordered": 20,
                "span_unordered": 20, "span_first": 10, "intervals": 10,
                "bool_range": 20}
PHRASE_CHECK = 4                 # of each kind, held to the CPU searcher
PHRASE_INT8 = 20                 # phrase bodies also sent to the int8 layout
HTTP_PHRASES = 10                # match_phrase / ?q= requests in phase 9


def phase14_bodies() -> dict:
    """Phase 14's requests by kind (``PHRASE_KINDS``), from seeded runs of
    the scale corpus (``testing/corpus.py`` ``phrase_query_log``: each
    run occurs at least once): ``match_phrase`` of 2-3 tokens; 18 runs
    whose first token is t0 (the reference anchors on t0, the port on
    the rarest slot) with "t0 t0" and "t0 t0 t0" (anchored on t0 by
    both); ``match_phrase_prefix`` (the run's last token as the prefix,
    ``max_expansions`` 10); ``multi_match`` ``phrase`` over ``body^2``
    and ``tag`` (a dis_max of a phrase and a term bag); ordered
    ``span_near`` of 2-3 clauses of a run (slop 0-3, the gap the run
    needs); unordered ``span_near`` of a run's last and first tokens;
    ``span_first``; ordered ``intervals`` ``match`` (max_gaps 0-2); and a
    ``bool`` of a ``match_phrase`` and a ``range`` on ``price``."""
    from opensearch_tpu_torch.testing import corpus

    rng = np.random.default_rng(47)
    runs = corpus.phrase_query_log(400, seed=45, n_docs=SCALE_DOCS)
    short = [r for r in runs if len(r) <= 3]
    longer = [r for r in runs if len(r) >= 3]
    on_t0 = [r for r in corpus.phrase_query_log(
        400, seed=46, n_docs=SCALE_DOCS, lengths=(2, 3)) if r[0] == 0]

    def text(run):
        return " ".join(f"t{t}" for t in run)

    def body(q):
        return {"query": q, "size": 10, "_source": False}

    def near(terms, slop, ordered):
        return body({"span_near": {"clauses": [
            {"span_term": {"body": f"t{t}"}} for t in terms],
            "slop": int(slop), "in_order": ordered}})

    def phrase(run):
        return body({"match_phrase": {"body": text(run)}})

    return {
        "phrase": [phrase(r) for r in short[:100]],
        "phrase_t0": ([phrase(r) for r in on_t0[:18]]
                      + [phrase((0, 0)), phrase((0, 0, 0))]),
        "phrase_prefix": [body({"match_phrase_prefix": {"body": {
            "query": text(r), "max_expansions": 10}}})
            for r in short[100:120]],
        "multi_match": [body({"multi_match": {
            "query": text(r), "fields": ["body^2", "tag"],
            "type": "phrase"}}) for r in short[120:140]],
        "span_ordered": [near(*corpus.span_clauses(r, 2 + i % 2), True)
                         for i, r in enumerate(longer[:20])],
        "span_unordered": [near((r[-1], r[0]), len(r) - 2, False)
                           for r in longer[20:40]],
        "span_first": [body({"span_first": {
            "match": {"span_term": {"body": f"t{r[0]}"}},
            "end": int(rng.integers(1, 11))}}) for r in short[140:150]],
        "intervals": [body({"intervals": {"body": {"match": {
            "query": text(r), "ordered": True,
            "max_gaps": int(rng.integers(0, 3))}}}})
            for r in longer[40:50]],
        "bool_range": [body({"bool": {
            "must": [{"match_phrase": {"body": text(r)}}],
            "filter": [{"range": {"price": {"gte": int(lo),
                                            "lt": int(lo) + 4000}}}]}})
            for r, lo in zip(short[150:170],
                             rng.integers(0, 6000, size=20))],
    }


def phase_phrase(segs, mapper, searcher, qsearcher) -> dict:
    """Phase 14: phrase and proximity search at full width, on phase 4's
    16 f32 segments (1,000,000 docs, positions staged on the first
    phrase: ``DeviceSegment.ensure_positions``).  Every body of
    ``phase14_bodies`` once, kind after kind, with K8 / K9's counts zeroed
    just before and read just after: qps, p50, p99 and launches a request
    by kind; the first PHRASE_CHECK of each kind held to the CPU searcher
    over the same segments byte for byte; the first PHRASE_INT8 phrase
    bodies sent to phase 7's 8 int8 segments too, whose answers must
    equal the f32 layout's (phrase scores read no impacts)."""
    import torch

    from opensearch_tpu_torch.ops import cuda_positions
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing.parity import bm25_mismatch

    t_phase = time.monotonic()
    k8, k9 = cuda_positions.phrase_scores_cuda, cuda_positions.span_scores_cuda
    bodies = phase14_bodies()
    before = searcher.resident_bytes()
    t0 = time.monotonic()
    searcher.search(bodies["phrase"][0])     # stages every segment's positions
    torch.cuda.synchronize()
    stage_s = time.monotonic() - t0
    staged = searcher.resident_bytes() - before
    p = segs[0].device(searcher.device).postings["body"]
    col_bytes = {name: sum(seg.device(searcher.device).postings["body"][name]
                           .nbytes for seg in segs)
                 for name in ("positions", "pos_offsets", "doc_lens")}
    warm = [b for kind in ("phrase_t0", "span_ordered") for b in
            bodies[kind][-1:]]
    for b in warm:
        searcher.search(b)
    torch.cuda.synchronize()
    kinds, out, found = {}, {}, 0
    for kind, items in bodies.items():
        k8.launches = k9.launches = 0          # this path starts here
        lat, resps, most = [], [], 0
        t0 = time.monotonic()
        for b in items:
            n8, n9 = k8.launches, k9.launches
            t = time.monotonic()
            resps.append(searcher.search(b))
            lat.append((time.monotonic() - t) * 1e3)
            most = max(most, k8.launches - n8, k9.launches - n9)
        wall = time.monotonic() - t0
        if most > 1:
            raise AssertionError(f"phase 14 {kind}: a request launched K8 "
                                 f"or K9 {most} times")
        for r in resps:
            hits = r["hits"]["hits"]
            if len(hits) > 10 or not all(np.isfinite(h["_score"])
                                         for h in hits):
                raise AssertionError(f"phase 14 {kind}: bad hits")
            found += bool(hits)
        out[kind] = resps
        kinds[kind] = {"n": len(items), "qps": len(items) / wall,
                       "p50_ms": float(np.percentile(lat, 50)),
                       "p99_ms": float(np.percentile(lat, 99)),
                       "k8_per_request": k8.launches / len(items),
                       "k9_per_request": k9.launches / len(items),
                       "k8": k8.launches, "k9": k9.launches}
    n_bodies = sum(len(v) for v in bodies.values())
    if found < 0.9 * n_bodies:
        raise AssertionError(f"phase 14: only {found} of {n_bodies} "
                             "requests found hits")
    launches = {"phrase_freqs": sum(k["k8"] for k in kinds.values()),
                "span_near": sum(k["k9"] for k in kinds.values())}
    if min(launches.values()) <= 0:
        raise AssertionError(f"phase 14: K8 or K9 never launched: "
                             f"{launches}")
    t0 = time.monotonic()
    cpu = ShardSearcher(segs, mapper, index_name="scale", device="cpu")
    checked = 0
    for kind, items in bodies.items():
        for b, got in zip(items[:PHRASE_CHECK], out[kind]):
            want = cpu.search(b)
            bad = bm25_mismatch(got, want)
            if bad or got["hits"]["max_score"] != want["hits"]["max_score"]:
                raise AssertionError(f"phase 14 {kind} vs cpu: {bad}: "
                                     f"{json.dumps(b)}")
            checked += 1
    cpu_s = time.monotonic() - t0
    del cpu
    q_lat = []
    for b, want in zip(bodies["phrase"][:PHRASE_INT8], out["phrase"]):
        t = time.monotonic()
        got = qsearcher.search(b)
        q_lat.append((time.monotonic() - t) * 1e3)
        bad = bm25_mismatch(got, want)
        if bad or got["hits"]["max_score"] != want["hits"]["max_score"]:
            raise AssertionError(f"phase 14 int8 vs f32: {bad}")
    gpu = gpu_name_power()
    log(f"phrase and proximity: positions staged on the first phrase in "
        f"{stage_s:.2f}s, {staged} bytes on the card over {len(segs)} "
        f"segments ({col_bytes}, doc_ids/tfs already staged: "
        f"{p['doc_ids'].nbytes + p['tfs'].nbytes} bytes a segment)")
    for kind, k in kinds.items():
        log(f"phrase {kind}: {k['n']} requests, qps {k['qps']:.2f}, p50 "
            f"{k['p50_ms']:.3f} ms, p99 {k['p99_ms']:.3f} ms, K8 "
            f"{k['k8_per_request']:.2f} and K9 {k['k9_per_request']:.2f} "
            f"launches a request, on {gpu}")
    log(f"phrase checks: {checked} answers byte-equal to the CPU searcher "
        f"({cpu_s:.1f}s), {PHRASE_INT8} phrase answers on the 8 int8 "
        f"segments equal to the f32 layout's (p50 "
        f"{float(np.median(q_lat)):.3f} ms); {found} of {n_bodies} "
        f"requests found hits")
    return {"kinds": kinds, "launches": launches, "checked": checked,
            "int8_equal": PHRASE_INT8, "int8_p50_ms": float(np.median(q_lat)),
            "staged_bytes": staged, "stage_s": stage_s,
            "column_bytes": col_bytes, "found": found,
            "requests": n_bodies, "wall_s": time.monotonic() - t_phase}


# -- phase 15 ----------------------------------------------------------------

SORT_KINDS = {"ts_desc": 20, "fare_score": 20, "tag_price": 20,
              "collapse_tag": 10, "rescore_phrase": 10, "fetch": 10}
SORT_PAGES = 3                   # search_after pages held to one deep page
SORT_PAGE = 10
SORT_CHECK = 2                   # of each kind, held to the CPU searcher
SORT_SPLIT_REPS = 10             # the host split's repetitions a body
HTTP_SORT_DOCS = 2_000           # docs of phase 9's second index
SORT_PAGE_FIELDS = [{"ts": "desc"}, {"fare": "asc"}, {"price": "asc"}]


def phase15_bodies() -> dict:
    """Phase 15's requests by kind (``SORT_KINDS``), seeded: a
    ``match_all`` sorted by ``ts`` desc (pages of 10 at ``from`` 0, 10,
    ...: the newest logs); a ``match`` pair sorted by [``fare`` asc,
    ``_score``]; a ``bool`` of a ``match`` pair and a ``price`` range
    sorted by [``tag`` asc, ``price`` desc]; a ``match`` pair collapsed
    on ``tag``; a ``match`` pair rescored by a ``match_phrase`` of a
    corpus run over a window of 100; a ``match`` pair with
    ``highlight``, ``explain`` and ``docvalue_fields``."""
    from opensearch_tpu_torch.testing import corpus

    rng = np.random.default_rng(150)
    pairs = corpus.zipf_query_log(sum(SORT_KINDS.values()), seed=151)
    runs = corpus.phrase_query_log(SORT_KINDS["rescore_phrase"], seed=152,
                                   n_docs=SCALE_DOCS, lengths=(2, 3))
    width = int(corpus.PRICE_MAX * 0.4)
    it = iter(pairs)

    def match():
        a, b = next(it)
        return {"match": {"body": f"t{a} t{b}"}}

    def body(query, **extra):
        return {"query": query, "size": 10, "_source": False, **extra}

    out = {"ts_desc": [body({"match_all": {}}, sort=[{"ts": "desc"}],
                            **{"from": 10 * i})
                       for i in range(SORT_KINDS["ts_desc"])],
           "fare_score": [body(match(), sort=[{"fare": "asc"}, "_score"])
                          for _ in range(SORT_KINDS["fare_score"])],
           "tag_price": [], "collapse_tag": [], "rescore_phrase": [],
           "fetch": []}
    for _ in range(SORT_KINDS["tag_price"]):
        lo = int(rng.integers(0, corpus.PRICE_MAX - width))
        out["tag_price"].append(body(
            {"bool": {"must": [match()], "filter": [{"range": {"price": {
                "gte": lo, "lt": lo + width}}}]}},
            sort=[{"tag": "asc"}, {"price": "desc"}]))
    out["collapse_tag"] = [body(match(), collapse={"field": "tag"})
                           for _ in range(SORT_KINDS["collapse_tag"])]
    out["rescore_phrase"] = [body(match(), rescore={
        "window_size": 100, "query": {
            "rescore_query": {"match_phrase": {
                "body": " ".join(f"t{t}" for t in run)}},
            "query_weight": 0.5, "rescore_query_weight": 2.0}})
        for run in runs]
    out["fetch"] = [body(match(), highlight={"fields": {"body": {}}},
                         explain=True,
                         docvalue_fields=["price", "ts", "tag",
                                          {"field": "fare"}])
                    for _ in range(SORT_KINDS["fetch"])]
    return out


def sort_split(searcher, body) -> dict:
    """Median host ms of one field-sorted request by part over
    SORT_SPLIT_REPS runs, the card synchronized after each part:
    compile (the plan cache), ``run_full`` (the plan over every
    segment), the key build (the matched rows and each clause's keys),
    the sorts (the stable chain), the read-back of the page and the
    fetch."""
    import torch

    from opensearch_tpu_torch.search import sorting

    specs = sorting.parse_sort(body["sort"])
    parts = {k: [] for k in ("compile", "run_full", "keys", "sorts",
                             "read_back", "fetch")}
    needs_scores = any(s["field"] == "_score" for s in specs)
    for _ in range(SORT_SPLIT_REPS):
        t = time.monotonic()
        (plan, bind), ckey = searcher.compiled(body.get("query"),
                                               scored=needs_scores,
                                               with_key=True)
        marks = [time.monotonic()]
        views = list(searcher._run_full(plan, bind, plan.arrays(), None,
                                        ckey=ckey))
        torch.cuda.synchronize()
        marks.append(time.monotonic())
        keys = sorting.row_keys(searcher, views,
                                sorting.matched_rows(searcher, views), specs)
        torch.cuda.synchronize()
        marks.append(time.monotonic())
        ordered = sorting.order_keys(searcher, keys)
        torch.cuda.synchronize()
        marks.append(time.monotonic())
        rows, _ = ordered.take(body.get("from", 0) + body["size"])
        marks.append(time.monotonic())
        searcher._hits_from_rows(rows, False)
        marks.append(time.monotonic())
        for name, a, b in zip(parts, [t] + marks[:-1], marks):
            parts[name].append((b - a) * 1e3)
    return {name: float(np.median(v)) for name, v in parts.items()}


def sort_device_share(searcher, body, reps: int = 5,
                      attempts: int = 3) -> dict:
    """Device ms a request of ``body`` under ``torch.profiler`` over
    ``reps`` requests, the part in sort kernels (``torch.sort``'s and
    ``torch.unique``'s radix sorts: names holding "sort" or "radix"),
    the device's idle share of the requests' wall time and the largest
    device entry; the first of ``attempts`` windows that shows device
    events counts (None values when none does)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from opensearch_tpu_torch.testing.profile_scale import (_device_self_us,
                                                            _is_device)
    searcher.search(body)
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.monotonic()
            for _ in range(reps):
                searcher.search(body)
            torch.cuda.synchronize()
            wall = (time.monotonic() - t) * 1e3 / reps
        events = [e for e in prof.key_averages() if _is_device(e)]
        total = sum(_device_self_us(e) for e in events) / 1e3 / reps
        if total <= 0:
            continue
        sorts = sum(_device_self_us(e) for e in events
                    if "sort" in e.key.lower() or "radix" in e.key.lower())
        top = max(events, key=_device_self_us)
        return {"device_ms": total, "sort_ms": sorts / 1e3 / reps,
                "sort_share": sorts / 1e3 / reps / total,
                "idle_share": max(0.0, 1 - total / wall),
                "top": top.key[:80],
                "top_ms": _device_self_us(top) / 1e3 / reps}
    return {"device_ms": None, "sort_ms": None, "sort_share": None,
            "idle_share": None, "top": None, "top_ms": None}


def phase_sort(segs, mapper, searcher, counters) -> dict:
    """Phase 15: the search request's result features at full width, on
    phase 4's 16 f32 segments (``price``, ``ts``, ``fare``, ``tag``: a
    dictionary of its own per segment).  Every body of ``phase15_bodies``
    once, kind after kind, the kernels' counts zeroed just before the
    first and read after the last (the match leaves' dense entry, K2's
    top-k under a rescore, K8 in the rescore's phrase); p50 host ms and
    the bytes read back a request by kind
    (``ShardSearcher.read_back_bytes``: a
    ``match_all`` sorted by ``ts`` must read back under 1 MB, where the
    scores and mask of every segment are the bytes printed beside it);
    SORT_PAGES ``search_after`` pages of a ``match_all`` sorted by
    ``SORT_PAGE_FIELDS`` equal to one deep page; the first SORT_CHECK of
    each kind and the pages byte-equal to the CPU searcher over the same
    segments (its ms beside); the host split of two sorted bodies
    (``sort_split``); the device ms a request of each kind and its part
    in sort kernels (``sort_device_share``)."""
    from opensearch_tpu_torch.search import sorting
    from opensearch_tpu_torch.search.executor import ShardSearcher

    t_phase = time.monotonic()
    bodies = phase15_bodies()
    for b in (bodies["ts_desc"][0], bodies["fare_score"][0],
              bodies["tag_price"][0]):
        searcher.search(b)                 # warm: the key columns, ranks
    for fn in counters.values():           # this path starts here
        fn.launches = 0
    kinds, out = {}, {}
    for kind, items in bodies.items():
        lat, nbytes, resps = [], [], []
        for b in items:
            searcher.read_back_bytes = 0
            t = time.monotonic()
            resps.append(searcher.search(b))
            lat.append((time.monotonic() - t) * 1e3)
            nbytes.append(searcher.read_back_bytes)
        for r in resps:
            hits = r["hits"]["hits"]
            if not hits or len(hits) > 10:
                raise AssertionError(f"phase 15 {kind}: {len(hits)} hits")
        out[kind] = resps
        kinds[kind] = {"n": len(items),
                       "p50_ms": float(np.percentile(lat, 50)),
                       "p99_ms": float(np.percentile(lat, 99)),
                       "read_back_bytes_p50": float(np.median(nbytes)),
                       "read_back_bytes_max": int(max(nbytes))}
    launches = {n: c.launches for n, c in counters.items()}
    for name in ("term_bag_scores", "term_bag_topk", "phrase_freqs"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 15: {name} never launched: "
                                 f"{launches}")
    full = sum(seg.device(searcher.device).n_pad * 5 for seg in segs)
    if kinds["ts_desc"]["read_back_bytes_max"] >= 1 << 20:
        raise AssertionError(f"phase 15: a sorted page read back "
                             f"{kinds['ts_desc']['read_back_bytes_max']} "
                             "bytes")
    for r in out["collapse_tag"]:
        tags = [h["fields"]["tag"][0] for h in r["hits"]["hits"]]
        if len(set(tags)) != len(tags):
            raise AssertionError("phase 15: collapse kept a tag twice")
    # search_after pages against one deep page
    deep = searcher.search({"sort": SORT_PAGE_FIELDS, "_source": False,
                            "size": SORT_PAGES * SORT_PAGE})
    pages, after = [], None
    page_bodies = []
    for _ in range(SORT_PAGES):
        b = {"sort": SORT_PAGE_FIELDS, "size": SORT_PAGE, "_source": False}
        if after is not None:
            b["search_after"] = after
        page_bodies.append(b)
        hits = searcher.search(b)["hits"]["hits"]
        pages += hits
        after = hits[-1]["sort"]
    if [(h["_id"], h["sort"]) for h in pages] != \
            [(h["_id"], h["sort"]) for h in deep["hits"]["hits"]]:
        raise AssertionError("phase 15: search_after pages differ from "
                             "the deep page")
    # the split, the device's share by kind, then the CPU searcher over
    # the same segments
    split = {"ts_desc": sort_split(searcher, bodies["ts_desc"][0]),
             "fare_score": sort_split(searcher, bodies["fare_score"][0])}
    device = {kind: sort_device_share(searcher, bodies[kind][1])
              for kind in bodies}
    t0 = time.monotonic()
    cpu = ShardSearcher(segs, mapper, index_name="scale", device="cpu")
    cpu_ms, checked = {}, 0
    for kind, items in bodies.items():
        lat = []
        for b, got in zip(items[:SORT_CHECK], out[kind]):
            t = time.monotonic()
            want = cpu.search(b)
            lat.append((time.monotonic() - t) * 1e3)
            if strip_took(got) != strip_took(want):
                raise AssertionError(f"phase 15 {kind} vs cpu: "
                                     f"{json.dumps(b)[:200]}")
            checked += 1
        cpu_ms[kind] = float(np.median(lat))
    for b in page_bodies + [{"sort": SORT_PAGE_FIELDS, "_source": False,
                             "size": SORT_PAGES * SORT_PAGE}]:
        if strip_took(searcher.search(b)) != strip_took(cpu.search(b)):
            raise AssertionError(f"phase 15 pages vs cpu: {json.dumps(b)}")
        checked += 1
    cpu_s = time.monotonic() - t0
    del cpu
    gpu = gpu_name_power()
    for kind, k in kinds.items():
        log(f"sort {kind}: {k['n']} requests, p50 {k['p50_ms']:.3f} ms, "
            f"p99 {k['p99_ms']:.3f} ms, read back "
            f"{k['read_back_bytes_p50']:.0f} "
            f"bytes a request (max {k['read_back_bytes_max']}), CPU "
            f"searcher {cpu_ms[kind]:.3f} ms, on {gpu}")
    for name, parts in split.items():
        log(f"sort split {name}: " + ", ".join(
            f"{p} {ms:.3f}" for p, ms in parts.items()) + f" ms, on {gpu}")
    for kind, d in device.items():
        log(f"sort device {kind}: {json.dumps(d)}, on {gpu}")
    log(f"sort checks: {checked} answers byte-equal to the CPU searcher "
        f"({cpu_s:.1f}s), {SORT_PAGES} search_after pages equal to one "
        f"deep page; every segment's scores and mask would be {full} "
        f"bytes; launches {launches}")
    return {"kinds": kinds, "split": split, "device": device,
            "cpu_ms": cpu_ms,
            "checked": checked, "launches": launches,
            "full_read_back_bytes": full,
            "wall_s": time.monotonic() - t_phase}


def phase_http_sort(node, state, counters) -> dict:
    """Over HTTP on phase 9's node before it stops: an index
    ``corpus_b`` (1 shard, phase 8's mapping) fed HTTP_SORT_DOCS rendered
    docs by ``_bulk``, then sorted, collapsed, rescored and fetched
    ``_search`` requests to ``corpus`` and across ``corpus,corpus_b``,
    their counts zeroed just before and read just after (a match leaf's
    dense entry or K2's top-k ran), each answer's hits equal to the
    CPU searchers' (the two-index ones merged by the node's own
    coordinator merge)."""
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing import corpus

    client = HttpClient(node.port)
    client.ok("PUT", "/corpus_b", {"settings": {"number_of_shards": 1},
                                   "mappings": WRITE_MAPPING})
    texts = corpus.render_texts(HTTP_SORT_DOCS, seed=153)
    lines = []
    for i, text in enumerate(texts):
        lines += [{"index": {"_index": "corpus_b", "_id": f"b{i}"}},
                  {"body": text, "tag": WRITE_TAGS[i % len(WRITE_TAGS)]}]
    client.ok("POST", "/_bulk?refresh=true", ndjson=lines)
    m = {"match": {"body": "t1 t7"}}
    requests = [
        ("corpus", {"sort": [{"tag": "asc"}, "_doc"], "size": 10}),
        ("corpus,corpus_b", {"sort": [{"tag": "desc"}, "_doc"],
                             "from": 5, "size": 20}),
        ("corpus,corpus_b", {"query": m, "sort": [{"tag": "asc"},
                                                  "_score"]}),
        ("corpus_b", {"sort": [{"tag": "asc"}, "_doc"],
                      "search_after": ["green", 100]}),
        ("corpus", {"query": m, "collapse": {"field": "tag"}}),
        ("corpus", {"query": m, "highlight": {"fields": {"body": {}}},
                    "explain": True, "docvalue_fields": ["tag"],
                    "size": 3}),
        ("corpus", {"query": m, "rescore": {"window_size": 50, "query": {
            "rescore_query": {"match_phrase": {"body": "t1 t7"}}}}}),
    ]
    for fn in counters.values():                # this path starts here
        fn.launches = 0
    qps, p50, outs = timed_calls(
        lambda r: client.ok("POST", f"/{r[0]}/_search", r[1]), requests)
    launches = {n: c.launches for n, c in counters.items()}
    if launches["term_bag_scores"] + launches["term_bag_topk"] <= 0:
        raise AssertionError(f"phase 9 sorts over HTTP: launches "
                             f"{launches}")
    cpus = {name: ShardSearcher(node.indices.get(name).searcher().segments,
                                node.indices.get(name).mapper,
                                index_name=name, device="cpu")
            for name in ("corpus", "corpus_b")}
    for (names, body), resp in zip(requests, outs):
        targets = names.split(",")
        if len(targets) == 1:
            want = cpus[names].search(body)
        else:
            size = body.get("size", 10)
            from_ = body.get("from", 0)
            sub = {**body, "from": 0, "size": from_ + size}
            want = node.rest._merge_responses(
                [cpus[t].search(sub) for t in targets], body, from_, size)
        want = json.loads(json.dumps(want))
        if resp["hits"] != want["hits"] or not resp["hits"]["hits"]:
            raise AssertionError(f"phase 9: /{names}/_search "
                                 f"{json.dumps(body)} over HTTP differs "
                                 "from the CPU searcher")
    client.close()
    return {"qps": qps, "p50_ms": p50, "requests": len(requests),
            "launches": launches}


# -- phase 16 ----------------------------------------------------------------

REL_PER_KIND = 10                # requests of each kind of phase 16
REL_CHECK = 1                    # of each kind, held to the CPU searcher
REL_CHECK_ULP = 5                # of each REL_ULP_KINDS kind
REL_PROFILE = 3                  # requests of a kind under the profiler
# kinds whose scores go through float64 (or float32 script) transcendental
# functions: the card's and the CPU's libm may round them apart in the
# last bit, so an answer that is not byte-equal holds to 2 float32 ulps
# (and rtol REL_ULP_RTOL), ids equal but for neighbours within that, and
# each score that differs is printed with its doc and ulp distance
REL_ULP_KINDS = ("distance_feature_geo", "rank_feature", "fs_sum",
                 "fs_geo", "fs_random_script")
REL_ULP_RTOL = 2.4e-7
MIDTOWN = (40.758, -73.9855)
LOWER_MANHATTAN = (40.76, -74.02, 40.70, -73.97)    # top, left, bottom, right
# the device kernels of the port's hand-written CUDA (the rest are torch's)
HAND_KERNELS = ("term_bag_dense_kernel", "term_bag_topk_kernel",
                "plan_topk_kernel", "knn_scores_kernel", "knn_topk_kernel")


def phase16_bodies() -> dict:
    """Phase 16's requests by kind, REL_PER_KIND each, seeded: the
    multi-term queries on ``body`` (``wildcard`` ``t12*``-like patterns
    of up to 1,111 terms a segment, ``t1*``-like ones of up to 11,111,
    case-insensitive ones (``query_string`` ``body:T12*``: the DSL's
    ``wildcard`` takes no ``case_insensitive``); ``regexp`` ``t1[0-9]{3}``-like; ``fuzzy`` at
    distance 1, and 2 with a ``prefix_length``; ``match`` of two terms
    with ``fuzziness: AUTO``; ``match_bool_prefix`` with ``fuzziness``),
    ``boosting`` (``match`` t0 t10576, a ``tag`` term negative),
    ``terms_set`` over four ``body`` terms with ``min_terms``,
    ``distance_feature`` on ``ts`` and on ``pickup``, ``rank_feature`` on
    ``fare`` (saturation with and without a pivot, log, sigmoid),
    ``more_like_this`` of a text, ``geo_distance`` at 2 and 20 km around
    Midtown, a lower-Manhattan ``geo_bounding_box``, an 8-vertex
    ``geo_polygon``, ``exists`` on ``pickup``, and ``function_score``
    over ``match`` t0 t10576 in three forms (a ``ts`` gauss, a ``fare``
    ``log1p`` factor and a ``tag`` filter weighted 2 under ``score_mode:
    sum``; a ``pickup`` gauss; ``random_score`` with a seed plus a
    ``script_score`` function ``cosineSimilarity(params.q, doc['vec']) +
    1.0``, which launches K1's scores entry)."""
    from opensearch_tpu_torch.testing import corpus

    n = REL_PER_KIND
    rng = np.random.default_rng(160)
    pairs = corpus.zipf_query_log(4 * n, seed=161)
    base = {"match": {"body": "t0 t10576"}}

    def jitter(scale=0.01):
        return (round(MIDTOWN[0] + float(rng.normal(0, scale)), 6),
                round(MIDTOWN[1] + float(rng.normal(0, scale)), 6))

    def box():
        dy, dx = (float(v) for v in rng.uniform(-0.005, 0.005, size=2))
        top, left, bottom, right = LOWER_MANHATTAN
        return {"top_left": {"lat": round(top + dy, 6),
                             "lon": round(left + dx, 6)},
                "bottom_right": {"lat": round(bottom + dy, 6),
                                 "lon": round(right + dx, 6)}}

    def octagon():
        lat, lon = jitter()
        r = float(rng.uniform(0.01, 0.03))
        return [{"lat": round(lat + r * np.cos(a), 6),
                 "lon": round(lon + 1.3 * r * np.sin(a), 6)}
                for a in np.arange(8) * np.pi / 4]

    def rank(i):
        form = i % 4
        if form == 0:
            return {"rank_feature": {"field": "fare",
                                     "saturation": {"pivot": 8.0 + i}}}
        if form == 1:
            return {"rank_feature": {"field": "fare", "boost": 1.0 + i}}
        if form == 2:
            return {"rank_feature": {"field": "fare", "log": {
                "scaling_factor": 1.0 + i}}}
        return {"rank_feature": {"field": "fare", "sigmoid": {
            "pivot": 6.0 + i, "exponent": 0.6}}}

    qvecs = corpus.random_vectors(n, DIM, seed=162)
    day = 86_400_000
    queries = {
        "wildcard_t12": [{"wildcard": {"body": f"t{p}*"}}
                         for p in range(12, 12 + n)],
        "wildcard_t1": [{"wildcard": {"body": p}} for p in (
            "t1*", "t2*", "t1?*", "t2?*", "t1??*", "t2??*", "t1*1",
            "t2*2", "t1*3", "t2*4")[:n]],
        "wildcard_nocase": [{"query_string": {"query": f"body:T{p}*"}}
                            for p in range(12, 12 + n)],
        "regexp": [{"regexp": {"body": f"t{d}[0-9]{{3}}"}}
                   for d in range(1, 10)][:n] + [
            {"regexp": {"body": "t1[0-4][0-9]{2}"}}][: max(0, n - 9)],
        "fuzzy_d1": [{"fuzzy": {"body": {"value": f"t{1234 + 111 * i}",
                                         "fuzziness": 1}}}
                     for i in range(n)],
        "fuzzy_d2": [{"fuzzy": {"body": {"value": f"t{1234 + 111 * i}",
                                         "fuzziness": 2,
                                         "prefix_length": 2}}}
                     for i in range(n)],
        "match_fuzzy": [{"match": {"body": {
            "query": f"t{1234 + i} t{567 + i}", "fuzziness": "AUTO"}}}
            for i in range(n)],
        "bool_prefix_fuzzy": [{"match_bool_prefix": {"body": {
            "query": f"t{1234 + i} t{56 + i}", "fuzziness": 1}}}
            for i in range(n)],
        "boosting": [{"boosting": {
            "positive": base,
            "negative": {"term": {"tag": corpus.tag_name(i)}},
            "negative_boost": round(0.2 + 0.05 * i, 2)}}
            for i in range(n)],
        "terms_set": [{"terms_set": {"body": {
            "terms": [f"t{a}", f"t{b}", f"t{2 + i}", f"t{20 + i}"],
            "minimum_should_match_field": "min_terms"}}}
            for i, (a, b) in enumerate(pairs[:n])],
        "distance_feature_ts": [{"distance_feature": {
            "field": "ts", "origin": corpus.TS_START_MS + 30 * day * i,
            "pivot": "7d"}} for i in range(n)],
        "distance_feature_geo": [{"distance_feature": {
            "field": "pickup", "origin": "%.6f,%.6f" % jitter(),
            "pivot": "1km"}} for _ in range(n)],
        "rank_feature": [rank(i) for i in range(n)],
        "more_like_this": [{"more_like_this": {
            "fields": ["body"], "like": " ".join(
                f"t{t}" for pair in pairs[n + 2 * i: n + 2 * i + 2]
                for t in pair) + f" t{100 + i} t{100 + i}",
            "min_term_freq": 1, "min_doc_freq": 1, "max_query_terms": 12}}
            for i in range(n)],
        "geo_distance_2km": [{"geo_distance": {
            "distance": "2km", "pickup": "%.6f,%.6f" % jitter()}}
            for _ in range(n)],
        "geo_distance_20km": [{"geo_distance": {
            "distance": "20km", "pickup": "%.6f,%.6f" % jitter()}}
            for _ in range(n)],
        "geo_bbox": [{"geo_bounding_box": {"pickup": box()}}
                     for _ in range(n)],
        "geo_polygon": [{"geo_polygon": {"pickup": {"points": octagon()}}}
                        for _ in range(n)],
        "exists_geo": [{"exists": {"field": "pickup",
                                   "boost": round(1.0 + 0.1 * i, 1)}}
                       for i in range(n)],
        "fs_sum": [{"function_score": {"query": base, "functions": [
            {"gauss": {"ts": {"origin": corpus.TS_START_MS + 20 * day * i,
                              "scale": "30d"}}},
            {"field_value_factor": {"field": "fare", "modifier": "log1p"}},
            {"filter": {"term": {"tag": corpus.tag_name(i)}},
             "weight": 2.0}], "score_mode": "sum"}} for i in range(n)],
        "fs_geo": [{"function_score": {"query": base, "gauss": {
            "pickup": {"origin": "%.6f,%.6f" % jitter(), "scale": "2km"}}}}
            for _ in range(n)],
        "fs_random_script": [{"function_score": {"query": base, "functions": [
            {"random_score": {"seed": 1000 + i}},
            {"script_score": {"script": {
                "source": "cosineSimilarity(params.q, doc['vec']) + 1.0",
                "params": {"q": [round(float(x), 6) for x in qvecs[i]]}}}}],
            "score_mode": "sum"}} for i in range(n)],
    }
    return {kind: [{"query": q, "size": 10, "_source": False} for q in qs]
            for kind, qs in queries.items()}


def expansion_ms(segs, mapper, query, reps: int = 3) -> dict:
    """Host ms of a multi-term query's dictionary walk over every segment
    apart from the rest of the request (``ExpandTermsPlan.expand``, a
    request's own walk: each distinct term tested once), the median of
    ``reps`` walks with the segments' sorted dictionaries listed first,
    as a searcher's compile context holds them; the terms it matches and
    the most of them a segment holds."""
    from opensearch_tpu_torch.search.compiler import (ShardContext,
                                                      compile_query)
    from opensearch_tpu_torch.search.query_dsl import parse_query

    ctx = ShardContext(segs, mapper, "cpu")
    plan, bind = compile_query(parse_query(query), ctx)
    lat = []
    for _ in range(reps):
        t = time.monotonic()
        terms = plan.expand(bind, ctx)
        lat.append((time.monotonic() - t) * 1e3)
    return {"ms": float(np.median(lat)), "terms": len(terms),
            "max_terms_per_segment": max(
                sum(t in seg.postings[plan.field].terms for t in terms)
                for seg in segs)}


def relevance_device(searcher, body, reps: int = REL_PROFILE,
                     attempts: int = 3, fresh_plans: bool = False) -> dict:
    """Device ms a request of ``body`` under ``torch.profiler`` over
    ``reps`` requests, its device kernels a request (the hand-written
    ones of ``HAND_KERNELS`` apart from torch's own, copies and memsets
    left out) and the device's idle share of the requests' wall time;
    the first of ``attempts`` windows with device events counts (None
    values when none does).  ``fresh_plans`` empties the searcher's plan
    cache before each request, so that a join's pre-pass runs in each."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from opensearch_tpu_torch.common.cache import BoundedCache
    from opensearch_tpu_torch.testing.profile_scale import (_device_self_us,
                                                            _is_device)

    def search():
        if fresh_plans:
            searcher._plan_cache = BoundedCache(searcher._plan_cache.limit)
        searcher.search(body)

    search()
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.monotonic()
            for _ in range(reps):
                search()
            torch.cuda.synchronize()
            wall = (time.monotonic() - t) * 1e3 / reps
        events = [e for e in prof.key_averages() if _is_device(e)]
        total = sum(_device_self_us(e) for e in events) / 1e3 / reps
        if total <= 0:
            continue
        kernels = [e for e in events
                   if not e.key.startswith(("Memcpy", "Memset"))]
        hand = sum(e.count for e in kernels
                   if any(h in e.key for h in HAND_KERNELS))
        return {"device_ms": total,
                "idle_share": max(0.0, 1 - total / wall),
                "hand_kernels": hand / reps,
                "torch_kernels": (sum(e.count for e in kernels) - hand)
                / reps}
    return {"device_ms": None, "idle_share": None, "hand_kernels": None,
            "torch_kernels": None}


def f32_ulps(a: float, b: float) -> int:
    """Float32 units in the last place between two scores (of one sign)."""
    ia, ib = (int(np.asarray(x, np.float32).view(np.int32)) for x in (a, b))
    return abs(ia - ib)


def score_diffs(got: dict, want: dict) -> list:
    """``(rank, id, card score, CPU score, ulps)`` of every rank whose
    score is not the CPU's, the ids of both where they differ."""
    out = []
    for i, (g, w) in enumerate(zip(got["hits"]["hits"],
                                   want["hits"]["hits"])):
        if g["_score"] != w["_score"] or g["_id"] != w["_id"]:
            hid = (g["_id"] if g["_id"] == w["_id"]
                   else f"{g['_id']}/{w['_id']}")
            out.append((i, hid, g["_score"], w["_score"],
                        f32_ulps(g["_score"], w["_score"])))
    return out


def relevance_mismatch(got: dict, want: dict, rtol: float):
    """None when ``got`` answers as ``want``: byte for byte (JSON) with
    ``rtol`` 0, else the same totals and hit count, each score within 2
    float32 ulps and ``rtol`` of the other's and the same id at each rank
    but where the neighbouring scores lie within it."""
    if rtol == 0.0:
        return None if strip_took(got) == strip_took(want) else "differs"
    if got["hits"]["total"] != want["hits"]["total"]:
        return f"totals {got['hits']['total']} vs {want['hits']['total']}"
    ga, wa = got["hits"]["hits"], want["hits"]["hits"]
    if len(ga) != len(wa):
        return f"{len(ga)} hits vs {len(wa)}"
    for i, (g, w) in enumerate(zip(ga, wa)):
        if (abs(g["_score"] - w["_score"]) > rtol * abs(w["_score"])
                or (g["_id"] == w["_id"]
                    and f32_ulps(g["_score"], w["_score"]) > 2)):
            return f"score {i}: {g['_score']} vs {w['_score']}"
        if g["_id"] != w["_id"]:
            near = [h["_score"] for h in wa[max(0, i - 1): i + 2]]
            if max(near) - min(near) > 2 * rtol * abs(w["_score"]):
                return f"id {i}: {g['_id']} vs {w['_id']}"
    return None


def phase_relevance(segs, mapper, searcher, counters, http=None) -> dict:
    """Phase 16: the relevance-shaping, multi-term and geo queries at
    full width, on phase 4's 16 f32 segments (``pickup`` geo_point and
    ``min_terms`` long of ``relevance_columns`` beside ``ts``, ``fare``,
    ``tag`` and ``vec``).  A body of each kind once (warm), then every
    body of ``phase16_bodies`` kind after kind, the counts zeroed just
    before the first and read after the last: p50 host ms and the
    launches a request by route and kind (K1 scores, the dense entry,
    the plan top-k, K2's top-k); the dictionary expansion of ``t12*`` and
    ``t1*`` timed apart (``expansion_ms``); under ``torch.profiler`` the
    device ms, kernels (hand-written and torch's) and idle share a
    request of each kind (``relevance_device``); the first REL_CHECK of
    each kind (REL_CHECK_ULP of REL_ULP_KINDS) held to the CPU searcher
    over the same segments byte for byte, an answer of REL_ULP_KINDS that
    is not by ``relevance_mismatch``, each score that differs printed
    with its doc and ulp distance (``score_diffs``)."""
    from opensearch_tpu_torch.search.executor import ShardSearcher

    t_phase = time.monotonic()
    bodies = phase16_bodies()
    for items in bodies.values():
        searcher.search({**items[0], "size": 3})   # warm: plans, columns
    routes = ("knn_scores", "term_bag_scores", "plan_topk",
              "term_bag_topk")
    for fn in counters.values():                   # this path starts here
        fn.launches = 0
    kinds, out = {}, {}
    for kind, items in bodies.items():
        before = {n: counters[n].launches for n in routes}
        lat, resps = [], []
        for b in items:
            t = time.monotonic()
            resps.append(searcher.search(b))
            lat.append((time.monotonic() - t) * 1e3)
        for r in resps:
            hits = r["hits"]["hits"]
            if len(hits) > 10 or not all(np.isfinite(h["_score"])
                                         for h in hits):
                raise AssertionError(f"phase 16 {kind}: bad hits")
        if sum(bool(r["hits"]["hits"]) for r in resps) < len(resps) - 1:
            raise AssertionError(f"phase 16 {kind}: requests without hits")
        out[kind] = resps
        kinds[kind] = {"n": len(items),
                       "p50_ms": float(np.percentile(lat, 50)),
                       "p99_ms": float(np.percentile(lat, 99)),
                       "launches_per_request": {
                           n: (counters[n].launches - before[n]) / len(items)
                           for n in routes}}
    launches = {n: c.launches for n, c in counters.items()}
    for name in ("knn_scores", "term_bag_scores", "plan_topk"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 16: {name} never launched: "
                                 f"{launches}")
    per = kinds["fs_random_script"]["launches_per_request"]
    if per["knn_scores"] != 1.0:
        raise AssertionError(f"phase 16: {per['knn_scores']} K1 scores "
                             "launches a script function request, not 1")
    for kind in ("fs_sum", "boosting", "terms_set"):
        per = kinds[kind]["launches_per_request"]
        if per["plan_topk"] != 1.0 or not 1 <= per["term_bag_scores"] <= 2:
            raise AssertionError(f"phase 16 {kind}: launches a request "
                                 f"{per}")
    expand = {q: expansion_ms(segs, mapper, {"wildcard": {"body": q}})
              for q in ("t12*", "t1*")}
    # the geo filters' bound: every segment's staged geo columns read once,
    # a mask and a float32 score a doc written
    dsegs = [seg.device(searcher.device) for seg in segs]
    geo_bytes = sum(d.column_bytes("geo") + 5 * d.n_pad for d in dsegs)
    geo_bound = {"bytes": geo_bytes,
                 "bound_ms": bound_ms(geo_bytes, 0.0)[0]}
    device = {kind: relevance_device(searcher, items[1])
              for kind, items in bodies.items()}
    t0 = time.monotonic()
    cpu = ShardSearcher(segs, mapper, index_name="scale", device="cpu")
    cpu_ms, checked, byte_equal, diffs = {}, 0, 0, []
    for kind, items in bodies.items():
        ulp_kind = kind in REL_ULP_KINDS
        lat = []
        for j, (b, got) in enumerate(zip(
                items[:REL_CHECK_ULP if ulp_kind else REL_CHECK],
                out[kind])):
            t = time.monotonic()
            want = cpu.search(b)
            lat.append((time.monotonic() - t) * 1e3)
            checked += 1
            if relevance_mismatch(got, want, 0.0) is None:
                byte_equal += 1
                continue
            bad = (relevance_mismatch(got, want, REL_ULP_RTOL) if ulp_kind
                   else "differs")
            if bad is not None:
                raise AssertionError(f"phase 16 {kind} vs cpu: {bad}: "
                                     f"{json.dumps(b)[:200]}")
            diffs += [(kind, j, *d) for d in score_diffs(got, want)]
        cpu_ms[kind] = float(np.median(lat))
    cpu_s = time.monotonic() - t0
    del cpu
    gpu = gpu_name_power()
    for kind, k in kinds.items():
        per = ", ".join(f"{n} {v:.2f}"
                        for n, v in k["launches_per_request"].items())
        d = device[kind]
        dev = ("device ms not measured" if d["device_ms"] is None else
               f"device {d['device_ms']:.3f} ms, idle share "
               f"{d['idle_share']:.3f}, kernels a request: hand "
               f"{d['hand_kernels']:.1f}, torch {d['torch_kernels']:.1f}")
        log(f"relevance {kind}: {k['n']} requests, p50 {k['p50_ms']:.3f} "
            f"ms, p99 {k['p99_ms']:.3f} ms, launches a request: {per}; "
            f"{dev}; CPU searcher {cpu_ms[kind]:.3f} ms, on {gpu}")
    for q, e in expand.items():
        log(f"relevance expansion {q}: {e['ms']:.3f} ms host over "
            f"{len(segs)} segments (each distinct term tested once), "
            f"{e['terms']} terms, up to {e['max_terms_per_segment']} a "
            "segment")
    log(f"relevance bound of a geo filter: {geo_bytes} bytes (the staged "
        f"geo columns, a mask and a score a doc written): "
        f"{geo_bound['bound_ms']:.5f} ms, on {gpu}")
    for kind, j, rank, hid, g, w, ulps in diffs:
        log(f"relevance card vs CPU: {kind} body {j} rank {rank} doc {hid}"
            f": {g!r} vs {w!r}, {ulps} float32 ulps")
    log(f"relevance checks: {checked} answers held to the CPU searcher "
        f"({cpu_s:.1f}s), {byte_equal} byte-equal, {len(diffs)} scores "
        f"apart within 2 float32 ulps and rtol {REL_ULP_RTOL} (kinds "
        f"{', '.join(REL_ULP_KINDS)} only); launches {launches}")
    if http is not None:
        log(f"relevance over HTTP: {json.dumps(http)}")
    return {"kinds": kinds, "expansion": expand, "device": device,
            "geo_bound": geo_bound,
            "cpu_ms": cpu_ms, "checked": checked, "byte_equal": byte_equal,
            "diffs": diffs, "launches": launches,
            "http": http, "wall_s": time.monotonic() - t_phase}


def phase_http_relevance(node, state, counters) -> dict:
    """Over HTTP on phase 9's node before it stops: five bodies to
    ``corpus`` (a ``wildcard``, a ``fuzzy``, a ``match`` with
    ``fuzziness``, a ``boosting`` and a ``function_score`` with a
    ``tag`` filter weight and ``random_score``) and ``GET
    /corpus/_search?q=body:t12*``, their counts zeroed just before them
    and read just after (the dense entry and the plan top-k ran), each
    answer's hits equal to the CPU searcher's."""
    from urllib.parse import quote

    from opensearch_tpu_torch.search.executor import ShardSearcher

    match = {"match": {"body": "t1 t7"}}
    requests = [
        ("POST", "/corpus/_search", {"wildcard": {"body": "t12*"}}),
        ("POST", "/corpus/_search", {"fuzzy": {"body": {
            "value": "t123", "fuzziness": 1}}}),
        ("POST", "/corpus/_search", {"match": {"body": {
            "query": "t12 t345", "fuzziness": "AUTO"}}}),
        ("POST", "/corpus/_search", {"boosting": {
            "positive": match, "negative": {"term": {"tag": "red"}},
            "negative_boost": 0.3}}),
        ("POST", "/corpus/_search", {"function_score": {
            "query": match, "functions": [
                {"filter": {"term": {"tag": "blue"}}, "weight": 2.0},
                {"random_score": {"seed": 5}}], "score_mode": "sum"}}),
        ("GET", f"/corpus/_search?q={quote('body:t12*')}", None),
    ]
    client = HttpClient(node.port)
    for fn in counters.values():                # this path starts here
        fn.launches = 0
    qps, p50, outs = timed_calls(
        lambda r: client.ok(r[0], r[1], None if r[2] is None
                            else {"query": r[2]}), requests)
    launches = {n: c.launches for n, c in counters.items()}
    if launches["term_bag_scores"] <= 0 or launches["plan_topk"] <= 0:
        raise AssertionError(f"phase 9 relevance over HTTP: launches "
                             f"{launches}")
    svc = node.indices.get("corpus")
    cpu = ShardSearcher(svc.searcher().segments, svc.mapper,
                        index_name="corpus", device="cpu")
    wants = [q if q is not None else {"query_string": {"query": "body:t12*"}}
             for _m, _p, q in requests]
    for (_m, path, _q), query, resp in zip(requests, wants, outs):
        want = json.loads(json.dumps(cpu.search({"query": query})))
        if resp["hits"] != want["hits"] or not resp["hits"]["hits"]:
            raise AssertionError(f"phase 9: {path} {json.dumps(query)} "
                                 "over HTTP differs from the CPU searcher")
    client.close()
    return {"qps": qps, "p50_ms": p50, "requests": len(requests),
            "launches": launches}


# -- phase 17: the relationship queries and the reader contexts ------------

QA_QUESTIONS = 1_000_000         # phase 17: questions of each corpus
QA_SEGMENTS = 16                 # ... in 16 segments of 62,500 questions
QA_PER_KIND = 10                 # requests of each kind
QA_CHECK = 1                     # of each kind, held to the CPU searcher
PERC_QUERIES = 2_000             # stored queries of the percolator index
PERC_PER_KIND = 5                # percolate requests with 1 and 5 docs
SUGGEST_PER_KIND = 5             # term and phrase suggest requests
COMPLETION_DOCS = 5_000          # docs of the completion index
SCROLL_PAGES = 25                # a match_all scroll of 25 pages ...
SCROLL_PAGE = 1_000              # ... of 1,000 (nyc_taxis' and pmc's)
SCROLL_TS_PAGES = 5              # pages of the scroll sorted on ts
SCROLL_SLICES = 4
PIT_PAGE = 100                   # three search_after pages of 100
QA_PROFILE = 3                   # requests of a kind under the profiler
KNN_BATCH = (64, 65_536, 128, 10)   # queries, rows, dims, k
HTTP_QA_QUESTIONS = 500          # questions of phase 9's qa indices
IGNORED_KEYS = ({"post_filter": {"term": {"tag": "tag001"}}},
                {"track_scores": True}, {"terminate_after": 5},
                {"version": True}, {"seq_no_primary_term": True},
                {"indices_boost": [{"scale": 2.0}]},
                {"script_fields": {"x": {"script": {"source": "1"}}}},
                {"slice": {"id": 0, "max": 2}}, {"profile": False})


def phase17_bodies(draws) -> dict:
    """The requests of phase 17, by kind: ``nested`` in the
    ``randomized-nested-queries`` shape (a ``term`` on ``answers.user``,
    zipf users, and a 90-day ``range`` on ``answers.date``), alone and
    inside a ``bool`` with a ``tag`` filter; ``has_child`` over a
    ``match`` pair on ``body`` in each ``score_mode`` (one with
    ``min_children: 2``); ``has_parent`` over a ``term`` on ``tag`` with
    ``score``; ``parent_id`` of questions with answers; ``percolate`` of
    one and of five documents; term and phrase ``suggest`` on ``body``
    with a misspelled token; ``completion`` prefixes; one body with each
    key the searcher ignores."""
    from opensearch_tpu_torch.testing import corpus

    rng = np.random.default_rng(171)
    day = 86_400_000

    def nested_q():
        user = int(min(rng.zipf(1.3) - 1, corpus.QA_USERS - 1))
        lo = corpus.TS_START_MS + int(rng.integers(0, 300)) * day
        return {"nested": {"path": "answers", "query": {"bool": {"must": [
            {"term": {"answers.user": corpus.user_name(user)}},
            {"range": {"answers.date": {"gte": lo, "lte": lo + 90 * day}}}
        ]}}}}

    pairs = corpus.zipf_query_log(QA_PER_KIND, seed=172)
    modes = ("none", "sum", "max", "avg")
    has_child = [{"has_child": {"type": "answer", "score_mode":
                                modes[i % 4], "query": {"match": {
                                    "body": f"t{a} t{b}"}}}}
                 for i, (a, b) in enumerate(pairs)]
    has_child[-2]["has_child"]["min_children"] = 2
    with_answers = np.nonzero(draws["n_answers"] > 0)[0]
    docs = corpus.percolator_documents(6 * PERC_PER_KIND, seed=24)
    wrong = [f"t{int(t)}x" for t in rng.integers(1, 300, size=10)]
    out = {
        "nested": [nested_q() for _ in range(QA_PER_KIND)],
        "nested_tag": [{"bool": {"must": [nested_q()], "filter": [
            {"term": {"tag": corpus.tag_name(int(min(rng.zipf(1.3) - 1,
                                                     30)))}}]}}
            for _ in range(QA_PER_KIND)],
        "has_child": has_child,
        "has_parent": [{"has_parent": {
            "parent_type": "question", "score": True, "query": {"term": {
                "tag": corpus.tag_name(int(min(rng.zipf(1.3) - 1,
                                               corpus.TAG_VALUES - 1)))}}}}
            for _ in range(QA_PER_KIND)],
        "parent_id": [{"parent_id": {"type": "answer", "id": str(int(q))}}
                      for q in rng.choice(with_answers, QA_PER_KIND)],
        "percolate_1": [{"percolate": {"field": "query", "document": d}}
                        for d in docs[:PERC_PER_KIND]],
        "percolate_5": [{"percolate": {"field": "query", "documents":
                                       docs[PERC_PER_KIND + 5 * i:
                                            PERC_PER_KIND + 5 * i + 5]}}
                        for i in range(PERC_PER_KIND)],
    }
    bodies = {kind: [{"query": q, "size": 10} for q in qs]
              for kind, qs in out.items()}
    bodies["suggest_term"] = [
        {"size": 0, "suggest": {"s": {"text": f"t1 {w}", "term": {
            "field": "body"}}}} for w in wrong[:SUGGEST_PER_KIND]]
    bodies["suggest_phrase"] = [
        {"size": 0, "suggest": {"p": {"text": f"t1 {w} t3", "phrase": {
            "field": "body", "highlight": {"pre_tag": "<em>",
                                           "post_tag": "</em>"}}}}}
        for w in wrong[SUGGEST_PER_KIND:]]
    bodies["suggest_completion"] = [
        {"size": 0, "suggest": {"c": {"prefix": f"u{p}", "completion": {
            "field": "sug", "size": 5}}}}
        for p in ("0", "00", "000", "001", "01", "1", "2", "05", "3",
                  "0000")][:QA_PER_KIND]
    bodies["ignored_keys"] = [{"query": {"match": {"body": "t1 t7"}},
                               "size": 10, **extra} for extra in IGNORED_KEYS]
    return bodies


def completion_index(mapper_cls, writer_cls, n_docs: int, seed: int = 25):
    """A small writer-built index with a ``sug`` completion field: user
    names with zipf weights."""
    from opensearch_tpu_torch.testing import corpus

    mapper = mapper_cls({"properties": {"sug": {"type": "completion"}}})
    rng = np.random.default_rng(seed)
    parsed = [mapper.parse(str(i), {"sug": {
        "input": [corpus.user_name(int(u))],
        "weight": int(rng.integers(1, 100))}})
        for i, u in enumerate(rng.integers(0, 20_000, size=n_docs))]
    return [writer_cls().build(parsed, "sug0")], mapper


def tensor_bytes(obj) -> int:
    """Bytes of the tensors inside ``obj`` (tensors, tuples, lists,
    dicts)."""
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(tensor_bytes(x) for x in obj)
    if isinstance(obj, dict):
        return sum(tensor_bytes(x) for x in obj.values())
    return 0


def build_relations():
    """Phase 17's corpora on the card: the nested and join corpora of
    ``qa_draws(QA_QUESTIONS)`` in QA_SEGMENTS segments each, and the
    percolator index of PERC_QUERIES stored queries."""
    import torch

    from opensearch_tpu_torch.index.segment import SegmentWriter
    from opensearch_tpu_torch.mapping.mapper import DocumentMapper
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing import corpus

    t0 = time.monotonic()
    draws = corpus.qa_draws(QA_QUESTIONS, seed=21)
    nsegs = corpus.nested_segments(draws, QA_SEGMENTS)
    jsegs = corpus.join_segments(draws, QA_SEGMENTS)
    nmapper = DocumentMapper({"properties": corpus.NESTED_MAPPING})
    jmapper = DocumentMapper({"properties": corpus.JOIN_MAPPING})
    pmapper = DocumentMapper({"properties": corpus.PERCOLATOR_MAPPING})
    psegs = [SegmentWriter().build(
        [pmapper.parse(str(i), {"query": q}) for i, q in
         enumerate(corpus.percolator_queries(PERC_QUERIES, seed=23))],
        "perc0")]
    build_s = time.monotonic() - t0
    t0 = time.monotonic()
    out = {"draws": draws,
           "nested": (nsegs, nmapper, ShardSearcher(
               nsegs, nmapper, index_name="qa_nested", device=DEVICE)),
           "join": (jsegs, jmapper, ShardSearcher(
               jsegs, jmapper, index_name="qa_join", device=DEVICE)),
           "perc": (psegs, pmapper, ShardSearcher(
               psegs, pmapper, index_name="qa_perc", device=DEVICE))}
    jdev = out["join"][2].device
    avgdl = out["join"][2].ctx.field_stats("body").avgdl
    for seg in jsegs:
        seg.device(jdev).impacts("body", avgdl)
    torch.cuda.synchronize()
    out["stage_s"] = time.monotonic() - t0
    out["build_s"] = build_s
    log(f"relations corpora: {QA_QUESTIONS} questions, "
        f"{int(draws['n_answers'].sum())} answers, {QA_SEGMENTS} segments "
        f"each (nested: {nsegs[0].n_docs} docs a segment; join: "
        f"{sum(s.n_docs for s in jsegs)} docs); {PERC_QUERIES} stored "
        f"queries; built in {build_s:.1f}s, staged in "
        f"{out['stage_s']:.1f}s")
    return out


def scroll_pages(searcher, body, pages: int, page_size: int,
                 slice_spec=None) -> tuple:
    """(pages of hits, first-page ms, later-page ms, the context) of a
    scroll over ``searcher``: ``scan_rows`` orders every matched row on
    the searcher's device, a ``ScrollContext`` pages the arrays, a page's
    hits are fetched by ``_hits_from_rows`` (the REST handler's steps);
    the context is released."""
    import torch

    from opensearch_tpu_torch.search.contexts import ScrollContext

    t = time.monotonic()
    ordered, total = searcher.scan_rows(body, slice_spec=slice_spec)
    ctx = ScrollContext(searcher, ordered, total, page_size=page_size,
                        source_spec=body.get("_source"),
                        index_name=searcher.index_name)
    out, later = [], []
    try:
        for p in range(pages):
            if p:
                t = time.monotonic()
            hits = searcher._hits_from_rows(ctx.next_page(),
                                            ctx.source_spec)
            if searcher.device.type == "cuda":
                torch.cuda.synchronize()
            ms = (time.monotonic() - t) * 1e3
            if p == 0:
                first = ms
            else:
                later.append(ms)
            out.append({"total": total, "hits": hits})
    finally:
        ctx.release()
    return out, first, later, ctx


def phase_relations(segs, mapper, searcher, counters, http=None) -> dict:
    """Phase 17: the relationship queries and the reader contexts at full
    scale.  ``build_relations``' nested and join corpora of 1,000,000
    questions (16 segments each) and its percolator index serve the
    ``phase17_bodies`` kinds, the counts zeroed just before the first and
    read after the last (p50 host ms and launches a request by route:
    the dense entry, the plan top-k; the joins' inner pre-pass timed
    apart, percolate's ms per stored query); then on phase 4's 16 scale
    segments a ``match_all`` scroll of 25 pages of 1,000 (first page
    apart), a sliced scroll (``max: 4``; the four slices' rows together
    are every row once), a scroll sorted on ``ts`` and a point in time
    with three ``search_after`` pages sorted on ``ts`` and a delete
    applied after it opens; ``knn_topk_batch`` against K1's top-k entry
    one query at a time.  The first QA_CHECK of each kind, every scroll
    and PIT page, and the ``nested`` / ``has_child`` cross-check (the
    same questions from the same draws) are held to the CPU searchers
    byte for byte; under ``torch.profiler`` the device ms and kernels a
    request of the cheap kinds."""
    import torch

    from opensearch_tpu_torch.index.segment import SegmentWriter
    from opensearch_tpu_torch.mapping.mapper import DocumentMapper
    from opensearch_tpu_torch.ops import cuda_knn
    from opensearch_tpu_torch.ops.knn import KnnSegment, knn_topk_batch
    from opensearch_tpu_torch.search import compiler
    from opensearch_tpu_torch.search.contexts import PitContext
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing import corpus
    from opensearch_tpu_torch.testing.parity import topk_mismatch

    t_phase = time.monotonic()
    parts, t_part = {}, [t_phase]

    def part(name):
        now = time.monotonic()
        parts[name] = now - t_part[0]
        t_part[0] = now

    rel = build_relations()
    draws = rel["draws"]
    nsegs, nmapper, nsearcher = rel["nested"]
    jsegs, jmapper, jsearcher = rel["join"]
    psegs, pmapper, psearcher = rel["perc"]
    csegs, cmapper = completion_index(DocumentMapper, SegmentWriter,
                                      COMPLETION_DOCS)
    csearcher = ShardSearcher(csegs, cmapper, index_name="qa_sug",
                              device=DEVICE)
    on = {"nested": nsearcher, "nested_tag": nsearcher,
          "has_child": jsearcher, "has_parent": jsearcher,
          "parent_id": jsearcher, "percolate_1": psearcher,
          "percolate_5": psearcher, "suggest_term": jsearcher,
          "suggest_phrase": jsearcher, "suggest_completion": csearcher,
          "ignored_keys": searcher}
    bodies = phase17_bodies(draws)
    # the join columns (each segment's parent table and ids) are built
    # once a searcher: timed apart, before the requests
    t0 = time.monotonic()
    compiler._join_columns(jsearcher.ctx, "qa")
    torch.cuda.synchronize()
    join_cols_s = time.monotonic() - t0
    prepass = []                   # host ms of each inner pre-pass
    real_prepass = compiler._host_run_scored

    def timed_prepass(*a, **k):
        t = time.monotonic()
        out = real_prepass(*a, **k)
        prepass.append((time.monotonic() - t) * 1e3)
        return out

    compiler._host_run_scored = timed_prepass
    part("build")
    routes = ("term_bag_scores", "term_bag_quantized_scores", "plan_topk")
    kinds, answers = {}, {}
    try:
        for kind, items in bodies.items():
            if kind not in ("percolate_1", "percolate_5"):
                on[kind].search({**items[0], "size": 3})    # warm
        for fn in counters.values():               # this path starts here
            fn.launches = 0
        for kind, items in bodies.items():
            before = {n: counters[n].launches for n in routes}
            n_pre = len(prepass)
            lat, resps = [], []
            for b in items:
                t = time.monotonic()
                resps.append(on[kind].search(b))
                lat.append((time.monotonic() - t) * 1e3)
            for r in resps:
                hits = r["hits"]["hits"]
                if len(hits) > 10 or not all(np.isfinite(h["_score"])
                                             for h in hits):
                    raise AssertionError(f"phase 17 {kind}: bad hits")
            found = sum(bool(r["hits"]["hits"] or r.get("suggest"))
                        for r in resps)
            if found < len(resps) - 2:
                raise AssertionError(f"phase 17 {kind}: {found} of "
                                     f"{len(resps)} requests answered")
            answers[kind] = resps
            k = {"n": len(items), "p50_ms": float(np.percentile(lat, 50)),
                 "p99_ms": float(np.percentile(lat, 99)),
                 "launches_per_request": {
                     n: (counters[n].launches - before[n]) / len(items)
                     for n in routes}}
            if len(prepass) > n_pre:
                k["prepass_p50_ms"] = float(np.median(prepass[n_pre:]))
            if kind.startswith("percolate"):
                k["ms_per_stored_query"] = k["p50_ms"] / PERC_QUERIES
            kinds[kind] = k
        launches = {n: c.launches for n, c in counters.items()}
    finally:
        compiler._host_run_scored = real_prepass
    for name in ("term_bag_scores", "plan_topk"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 17: {name} never launched: "
                                 f"{launches}")
    for kind in ("nested", "nested_tag", "has_child", "has_parent",
                 "parent_id"):
        if kinds[kind]["launches_per_request"]["plan_topk"] != 1.0:
            raise AssertionError(f"phase 17 {kind}: launches "
                                 f"{kinds[kind]['launches_per_request']}")
    part("requests")
    # the reader contexts on phase 4's scale segments
    cpu = ShardSearcher(segs, mapper, index_name="scale", device="cpu")
    scroll_body = {"query": {"match_all": {}}, "size": SCROLL_PAGE}
    pages, first_ms, later_ms, _c = scroll_pages(
        searcher, scroll_body, SCROLL_PAGES, SCROLL_PAGE)
    want, _f, _l, _c = scroll_pages(cpu, scroll_body, SCROLL_PAGES,
                                    SCROLL_PAGE)
    if json.dumps(pages) != json.dumps(want):
        raise AssertionError("phase 17: a match_all scroll page differs "
                             "from the CPU searcher's")
    if pages[0]["total"] != sum(s.live_count() for s in segs) or \
            any(len(p["hits"]) != SCROLL_PAGE for p in pages):
        raise AssertionError("phase 17: scroll pages short")
    ts_body = {"query": {"match": {"body": "t1 t7"}}, "size": SCROLL_PAGE,
               "sort": [{"ts": "desc"}]}
    ts_pages, ts_first, ts_later, _c = scroll_pages(
        searcher, ts_body, SCROLL_TS_PAGES, SCROLL_PAGE)
    if json.dumps(ts_pages) != json.dumps(scroll_pages(
            cpu, ts_body, SCROLL_TS_PAGES, SCROLL_PAGE)[0]):
        raise AssertionError("phase 17: a scroll page sorted on ts "
                             "differs from the CPU searcher's")
    slices, slice_rows = [], []
    for sid in range(SCROLL_SLICES):
        spec = {"id": sid, "max": SCROLL_SLICES}
        got, s_first, _l, ctx = scroll_pages(searcher, scroll_body, 2,
                                              SCROLL_PAGE, slice_spec=spec)
        if json.dumps(got) != json.dumps(scroll_pages(
                cpu, scroll_body, 2, SCROLL_PAGE, slice_spec=spec)[0]):
            raise AssertionError(f"phase 17: slice {sid}'s pages differ "
                                 "from the CPU searcher's")
        slice_rows.append(ctx.ordered.flat)
        slices.append({"rows": got[0]["total"], "first_page_ms": s_first})
    every = torch.sort(torch.cat(slice_rows)).values
    matched = torch.sort(searcher.scan_rows(scroll_body)[0].flat).values
    if not torch.equal(every, matched):
        raise AssertionError("phase 17: the slices do not give every row "
                             "exactly once")
    # a point in time: pinned searchers on both devices, then a delete
    pit_body = {"query": {"match": {"body": "t1 t7"}}, "size": PIT_PAGE,
                "sort": [{"ts": "asc"}]}
    pit = PitContext(ShardSearcher(segs, mapper, index_name="scale",
                                   device=DEVICE), "scale")
    cpu_pit = ShardSearcher(segs, mapper, index_name="scale", device="cpu")
    pit_ms, after, saved = [], None, [(s, s.live) for s in segs]
    try:
        for p in range(3):
            body = dict(pit_body) if after is None else {
                **pit_body, "search_after": after}
            t = time.monotonic()
            got = pit.searcher.search(body)
            pit_ms.append((time.monotonic() - t) * 1e3)
            if strip_took(got) != strip_took(cpu_pit.search(body)):
                raise AssertionError(f"phase 17: PIT page {p} differs from "
                                     "the CPU searcher's")
            if p == 0:
                first_ids = [h["_id"] for h in got["hits"]["hits"][:5]]
                for hid in first_ids:
                    seg = next(s for s in segs if hid in s.id_to_local)
                    seg.apply_deletes([seg.id_to_local[hid]])
            after = got["hits"]["hits"][-1]["sort"]
        again = pit.searcher.search(pit_body)
        fresh = ShardSearcher(segs, mapper, index_name="scale",
                              device=DEVICE).search({**pit_body,
                                                     "size": 0})
        if fresh["hits"]["total"]["value"] != \
                again["hits"]["total"]["value"] - len(first_ids) or \
                [h["_id"] for h in again["hits"]["hits"][:5]] != first_ids:
            raise AssertionError("phase 17: the PIT saw the delete, or a "
                                 "new searcher did not")
        pit_bytes = tensor_bytes(pit.searcher._sort_cache.values())
    finally:
        for seg, live in saved:
            seg.live = live
    part("contexts")
    # answers held to the CPU searchers, and the cross-check
    cpus = {"nested": ShardSearcher(nsegs, nmapper, index_name="qa_nested",
                                    device="cpu"),
            "join": ShardSearcher(jsegs, jmapper, index_name="qa_join",
                                  device="cpu"),
            "perc": ShardSearcher(psegs, pmapper, index_name="qa_perc",
                                  device="cpu"),
            "sug": ShardSearcher(csegs, cmapper, index_name="qa_sug",
                                 device="cpu"),
            "scale": cpu}
    cpu_of = {nsearcher: cpus["nested"], jsearcher: cpus["join"],
              psearcher: cpus["perc"], csearcher: cpus["sug"],
              searcher: cpus["scale"]}
    checked, cpu_ms = 0, {}
    for kind, items in bodies.items():
        n = len(items) if kind == "ignored_keys" else QA_CHECK
        lat = []
        for b, got in zip(items[:n], answers[kind]):
            t = time.monotonic()
            want = cpu_of[on[kind]].search(b)
            lat.append((time.monotonic() - t) * 1e3)
            checked += 1
            if strip_took(got) != strip_took(want):
                raise AssertionError(f"phase 17 {kind} vs cpu: differs: "
                                     f"{json.dumps(b)[:200]}")
        cpu_ms[kind] = float(np.median(lat))
    cross = bodies["nested"][0]["query"]["nested"]["query"]
    nq = {"query": {"nested": {"path": "answers", "query": cross}},
          "size": 10_000}
    cq = {"query": {"has_child": {"type": "answer", "query": {"bool": {
        "must": [{"term": {"user": cross["bool"]["must"][0]["term"][
            "answers.user"]}},
                 {"range": {"date": cross["bool"]["must"][1]["range"][
                     "answers.date"]}}]}}}}, "size": 10_000}
    n_ids = {h["_id"] for h in nsearcher.search(nq)["hits"]["hits"]}
    c_ids = {h["_id"] for h in jsearcher.search(cq)["hits"]["hits"]}
    if n_ids != c_ids or not n_ids:
        raise AssertionError(f"phase 17: nested and has_child question "
                             f"sets differ ({len(n_ids)} vs {len(c_ids)})")
    part("checks")
    device = {kind: relevance_device(on[kind], bodies[kind][1],
                                     fresh_plans=True)
              for kind in ("nested", "nested_tag", "has_child",
                           "has_parent", "parent_id")}
    nested_bytes = sum(s.device(nsearcher.device).nested_bytes()
                       for s in nsegs)
    part("profiler")
    # knn_topk_batch against K1's top-k entry, one query at a time
    n_q, n_rows, dim, k = KNN_BATCH
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(17)
    vecs = torch.randn(n_rows, dim, generator=gen, device=dev)
    queries = torch.randn(n_q, dim, generator=gen, device=dev)
    valid = torch.ones(n_rows, dtype=torch.bool, device=dev)
    seg = [KnnSegment(vecs, valid)]
    bv, bi = knn_topk_batch(vecs, valid, queries, space="l2", k=k)
    one = [cuda_knn.knn_topk_segments_cuda(seg, queries[j], space="l2",
                                           k=k) for j in range(n_q)]
    kv = torch.cat([v for v, _i in one]).cpu().numpy()
    ki = torch.cat([i for _v, i in one]).cpu().numpy()
    if not np.array_equal(bi.cpu().numpy(), ki):
        raise AssertionError("phase 17: knn_topk_batch ids differ from "
                             "K1's")
    bad, knn_err = topk_mismatch(bv.cpu().numpy(), bi.cpu().numpy(), kv, ki)
    if bad is not None:
        raise AssertionError(f"phase 17: knn_topk_batch vs K1: {bad}")
    batch_ms = cuda_ms(lambda: knn_topk_batch(vecs, valid, queries,
                                              space="l2", k=k), 10)
    k1_ms = cuda_ms(lambda: [cuda_knn.knn_topk_segments_cuda(
        seg, queries[j], space="l2", k=k) for j in range(n_q)], 3) / n_q
    knn_batch = {"batch_ms": batch_ms, "k1_ms_per_query": k1_ms,
                 "bound_ms": bound_ms(n_rows * dim * 4 + n_q * dim * 4,
                                      2.0 * n_rows * dim * n_q)[0],
                 "max_abs_err": knn_err}
    part("knn_batch")
    gpu = gpu_name_power()
    for kind, kk in kinds.items():
        per = ", ".join(f"{n} {v:.2f}"
                        for n, v in kk["launches_per_request"].items())
        d = device.get(kind)
        dev_txt = ("device ms not measured" if d is None
                   or d["device_ms"] is None else
                   f"device {d['device_ms']:.3f} ms, idle share "
                   f"{d['idle_share']:.3f}, kernels a request: hand "
                   f"{d['hand_kernels']:.1f}, torch "
                   f"{d['torch_kernels']:.1f}")
        extra = ""
        if "prepass_p50_ms" in kk:
            extra += f", inner pre-pass p50 {kk['prepass_p50_ms']:.3f} ms"
        if "ms_per_stored_query" in kk:
            extra += (f", {kk['ms_per_stored_query']:.4f} ms a stored "
                      "query")
        log(f"relations {kind}: {kk['n']} requests, p50 "
            f"{kk['p50_ms']:.3f} ms, p99 {kk['p99_ms']:.3f} ms{extra}, "
            f"launches a request: {per}; {dev_txt}; CPU searcher "
            f"{cpu_ms[kind]:.3f} ms, on {gpu}")
    log(f"relations scroll: match_all {SCROLL_PAGES} pages of "
        f"{SCROLL_PAGE} over {pages[0]['total']} rows: first page "
        f"{first_ms:.3f} ms, later pages p50 {np.median(later_ms):.3f} ms; "
        f"sorted on ts: first {ts_first:.3f} ms, later p50 "
        f"{np.median(ts_later):.3f} ms; {SCROLL_SLICES} slices "
        f"{[s['rows'] for s in slices]} rows, first pages "
        f"{[round(s['first_page_ms'], 3) for s in slices]} ms; PIT pages "
        f"{[round(x, 3) for x in pit_ms]} ms, {pit_bytes} bytes of key "
        f"columns the PIT's searcher holds on the card; on {gpu}")
    log(f"relations staged bytes of the nested blocks: {nested_bytes} "
        f"({QA_SEGMENTS} segments); join columns built in "
        f"{join_cols_s:.3f}s; {checked} answers and every scroll and PIT "
        f"page held to the CPU searchers byte for byte; nested and "
        f"has_child cross-check: {len(n_ids)} questions; launches "
        f"{launches}")
    log(f"relations knn_topk_batch: {n_q} queries over {n_rows} x {dim} "
        f"at k = {k}: {batch_ms:.3f} ms a batch, K1's top-k "
        f"{k1_ms:.4f} ms a query ({k1_ms * n_q:.3f} ms for {n_q}), bound "
        f"{knn_batch['bound_ms']:.4f} ms, max abs err {knn_err:.3g}, on "
        f"{gpu}")
    log(f"relations cuts: {PERC_QUERIES} stored queries (the percolator "
        f"workload's log holds more; each percolate request counts every "
        f"stored query once), {PERC_PER_KIND} percolate and "
        f"{SUGGEST_PER_KIND} term / phrase suggest requests a kind (each "
        f"costs host seconds), scroll sorted on ts {SCROLL_TS_PAGES} "
        f"pages, slices read 2 pages each (all their rows checked on the "
        f"card)")
    log("relations parts (s): " + ", ".join(f"{n} {v:.1f}"
                                           for n, v in parts.items()))
    if http is not None:
        log(f"relations over HTTP: {json.dumps(http)}")
    return {"kinds": kinds, "device": device, "cpu_ms": cpu_ms,
            "parts": parts,
            "checked": checked, "launches": launches,
            "scroll": {"first_ms": first_ms,
                       "later_p50_ms": float(np.median(later_ms)),
                       "ts_first_ms": ts_first,
                       "ts_later_p50_ms": float(np.median(ts_later)),
                       "slices": slices, "pit_ms": pit_ms,
                       "pit_bytes": pit_bytes},
            "nested_bytes": nested_bytes, "join_cols_s": join_cols_s,
            "cross_check_questions": len(n_ids), "knn_batch": knn_batch,
            "build_s": rel["build_s"], "stage_s": rel["stage_s"],
            "http": http, "wall_s": time.monotonic() - t_phase}


def phase_http_relations(node, state, counters) -> dict:
    """Over HTTP on phase 9's node before it stops, and on a CPU node fed
    the same requests: indices ``qa_nested``, ``qa_join`` and ``qa_perc``
    of HTTP_QA_QUESTIONS questions (``qa_documents``, through ``_bulk``)
    and 200 stored queries; then, the counts zeroed just before, a
    ``match_all`` scroll of ``qa_join`` (two pages of 1,000, then cleared),
    a point in time on ``qa_nested`` (opened, searched with a sort,
    closed), and one ``nested``, one ``has_child``, one ``percolate`` and
    one ``suggest`` body.  Every answer equals the CPU node's with the
    scroll and PIT ids masked."""
    import shutil
    import tempfile

    from opensearch_tpu_torch.node import Node
    from opensearch_tpu_torch.testing import corpus

    draws = corpus.qa_draws(HTTP_QA_QUESTIONS, seed=26)
    questions, answers = corpus.qa_documents(draws)
    starts = np.concatenate([[0], np.cumsum(draws["n_answers"])])
    setup = [("PUT", "/qa_nested", {"mappings": {
                  "properties": corpus.NESTED_MAPPING}}),
             ("PUT", "/qa_join", {"mappings": {
                 "properties": corpus.JOIN_MAPPING}}),
             ("PUT", "/qa_perc", {"mappings": {
                 "properties": corpus.PERCOLATOR_MAPPING}})]
    nested_lines, join_lines = [], []
    for i, (qid, ndoc, jdoc) in enumerate(questions):
        nested_lines += [{"index": {"_index": "qa_nested", "_id": qid}},
                         ndoc]
        join_lines += [{"index": {"_index": "qa_join", "_id": qid}}, jdoc]
        for aid, adoc in answers[starts[i]: starts[i + 1]]:
            join_lines += [{"index": {"_index": "qa_join", "_id": aid}},
                           adoc]
    perc_lines = []
    for i, q in enumerate(corpus.percolator_queries(200, seed=27)):
        perc_lines += [{"index": {"_index": "qa_perc", "_id": str(i)}},
                       {"query": q}]
    user = corpus.user_name(int(draws["user"][0]))
    requests = [
        ("POST", "/qa_nested/_search", {"query": {"nested": {
            "path": "answers", "query": {"bool": {"must": [
                {"term": {"answers.user": user}},
                {"range": {"answers.date": {"gte": corpus.TS_START_MS}}}]}}
        }}}),
        ("POST", "/qa_join/_search", {"query": {"has_child": {
            "type": "answer", "score_mode": "sum",
            "query": {"match": {"body": "t1 t3"}}}}}),
        ("POST", "/qa_perc/_search", {"query": {"percolate": {
            "field": "query",
            "document": corpus.percolator_documents(1, seed=28)[0]}}}),
        ("POST", "/qa_join/_search", {"size": 0, "suggest": {"s": {
            "text": "t1 t12x", "term": {"field": "body"}}}}),
    ]

    def script(client) -> list:
        out = []
        page = client.ok("POST", "/qa_join/_search?scroll=1m",
                         {"query": {"match_all": {}}, "size": 1000})
        out.append(page)
        out.append(client.ok("POST", "/_search/scroll", {
            "scroll": "1m", "scroll_id": page["_scroll_id"]}))
        out.append(client.ok("DELETE", "/_search/scroll",
                             {"scroll_id": [page["_scroll_id"]]}))
        pit = client.ok("POST", "/qa_nested/_search/point_in_time"
                        "?keep_alive=1m")
        out.append(client.ok("POST", "/_search", {
            "pit": {"id": pit["pit_id"]}, "size": 20,
            "query": {"range": {"created": {"gte": corpus.TS_START_MS}}},
            "sort": [{"created": "desc"}]}))
        out.append(client.ok("DELETE", "/_search/point_in_time",
                             {"pit_id": [pit["pit_id"]]}))
        for method, path, body in requests:
            out.append(client.ok(method, path, body))
        return out

    def load(client):
        for method, path, body in setup:
            client.ok(method, path, body)
        for lines in (nested_lines, join_lines, perc_lines):
            for lo in range(0, len(lines), 2_000):
                client.ok("POST", "/_bulk", ndjson=lines[lo: lo + 2_000])
        client.ok("POST", "/_refresh")

    def masked(resp):
        return json.dumps({k: ("<id>" if k in ("_scroll_id", "pit_id")
                               else v) for k, v in resp.items()
                           if k != "took"})

    client = HttpClient(node.port)
    load(client)
    for fn in counters.values():                # this path starts here
        fn.launches = 0
    t0 = time.monotonic()
    got = script(client)
    ms = (time.monotonic() - t0) * 1e3
    launches = {n: c.launches for n, c in counters.items()}
    client.close()
    if launches["term_bag_scores"] <= 0 or launches["plan_topk"] <= 0:
        raise AssertionError(f"phase 9 relations over HTTP: launches "
                             f"{launches}")
    path = tempfile.mkdtemp(prefix="chip_smoke_cpu_node_")
    cpu_node = Node(path, port=0, device="cpu").start()
    try:
        cpu_client = HttpClient(cpu_node.port)
        load(cpu_client)
        want = script(cpu_client)
        cpu_client.close()
    finally:
        cpu_node.stop()
        shutil.rmtree(path, ignore_errors=True)
    for i, (g, w) in enumerate(zip(got, want)):
        if masked(g) != masked(w):
            raise AssertionError(f"phase 9: relations request {i} over "
                                 "HTTP differs from the CPU node's")
    first = got[0]["hits"]
    if len(first["hits"]) != min(1000, first["total"]["value"]) or \
            not got[5]["hits"]["hits"]:
        raise AssertionError("phase 9: relations over HTTP: empty answers")
    return {"requests": len(got), "ms": ms, "launches": launches}


# -- phase 18: profile and residency ------------------------------------------

PROFILE_REQUESTS = 50            # phase 18: of match, bool and knn, each
PROFILE_BATCHES = 4              # msearch batches of 64, profiled and not
PROFILE_CLIENTS = 16             # profiled clients through the batcher
PAGER_SHARE = 4                  # the pager run's budget: 1/4 of the tables


def device_ms_per_call(fn, reps: int, attempts: int = 3):
    """Mean device milliseconds of every kernel ``fn()`` launches, per
    call, over ``reps`` calls under ``torch.profiler``; the first of
    ``attempts`` windows with device events counts; None when none
    has any."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from opensearch_tpu_torch.testing.profile_scale import (_device_self_us,
                                                            _is_device)
    fn()
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(_device_self_us(e) for e in prof.key_averages()
                 if _is_device(e))
        if us:
            return us / 1e3 / reps
    return None


def check_profile(resp: dict, plain: dict, total: int, what: str) -> None:
    """Phase 18's checks of one profiled response: hits byte-equal to the
    unprofiled twin, the phase sum at most ``took`` + 1 ms, the segment
    counts summing to ``total``, one record a decided segment, and no
    kernel library built (the run is warm)."""
    from opensearch_tpu_torch.search.profile import PHASES

    if json.dumps(resp["hits"], sort_keys=True) != \
            json.dumps(plain["hits"], sort_keys=True):
        raise AssertionError(f"phase 18 {what}: profiled hits differ")
    sec = resp["profile"]["shards"][0]
    bd = sec["searches"][0]["query"][0]["breakdown"]
    phase_ns = sum(bd[p] for p in PHASES)
    if phase_ns > (resp["took"] + 1) * 1_000_000:
        raise AssertionError(f"phase 18 {what}: phases {phase_ns} ns over "
                             f"took {resp['took']} ms")
    segsum = sec["engine"]["segments"]
    decided = sum(v for k, v in segsum.items()
                  if k not in ("total", "not_reached"))
    if segsum["total"] != total or \
            decided + segsum["not_reached"] != total or \
            len(sec.get("segments", ())) != decided:
        raise AssertionError(f"phase 18 {what}: segments {segsum}")
    if sec["engine"]["xla_compiles"] != 0:
        raise AssertionError(f"phase 18 {what}: "
                             f"{sec['engine']['xla_compiles']} kernel "
                             "libraries built by a warm request")


def profile_turns(run, bodies, total: int, what: str) -> dict:
    """Each body run unprofiled and profiled, in turns (plain first on
    even bodies, profiled first on odd ones) after a warm pass of both:
    the checks of ``check_profile``, and the p50 host ms of each."""
    for body in bodies:
        run(body)
        run(dict(body, profile=True))
    plain_ms, prof_ms = [], []
    for i, body in enumerate(bodies):
        order = (False, True) if i % 2 == 0 else (True, False)
        out = {}
        for profiled in order:
            t0 = time.monotonic()
            out[profiled] = run(dict(body, profile=True) if profiled
                                else body)
            (prof_ms if profiled else plain_ms).append(
                (time.monotonic() - t0) * 1e3)
        check_profile(out[True], out[False], total, what)
    p50, p50_prof = float(np.median(plain_ms)), float(np.median(prof_ms))
    return {"p50_ms": p50, "p50_profiled_ms": p50_prof,
            "extra_ms": p50_prof - p50, "requests": len(bodies)}


def phase_profile_residency(segs, searcher, qsegs, qsearcher,
                            counters) -> dict:
    """Phase 18: the Profile API and device residency at full scale.
    50 each of ``match``, phase 10's ``bool`` and ``knn`` (k = 10) on the
    16 f32 scale segments and 4 ``msearch`` batches of 64, each profiled
    and unprofiled in turns (``check_profile`` on every pair; p50 of
    both), then 16 profiled clients through the continuous batcher; the
    ledger's ``stats()`` by kind; ``resident_bytes()`` held to the change
    in ``torch.cuda.memory_allocated()`` over restaging the 16 segments,
    and the memory freed when they are evicted again after requests;
    50 ``match`` under a budget that holds half the f32 segments, then
    the 8 int8 segments under a budget that leaves their pages 1/4 of
    their quantized tables, each byte-equal to the unbudgeted answers
    (evictions, restages, pager hits / misses, ms a restage; no host
    fallback); the device ms of ``train_kmeans`` and ``knn_topk_batch``
    (kernel table rows 10 and 14)."""
    import gc
    import threading

    import torch

    from opensearch_tpu_torch.common.device_ledger import (device_ledger,
                                                           device_pager)
    from opensearch_tpu_torch.ops.ivf import train_kmeans
    from opensearch_tpu_torch.ops.knn import knn_topk_batch
    from opensearch_tpu_torch.search import engine as engine_mod
    from opensearch_tpu_torch.testing import corpus

    t_phase = time.monotonic()
    dev = torch.device(DEVICE)
    led, pager = device_ledger(), device_pager()
    gpu = gpu_name_power()
    rng = np.random.default_rng(181)
    pairs = corpus.zipf_query_log(PROFILE_REQUESTS, seed=181)
    match = [match_body(a, b) for a, b in pairs]
    bools = phase10_bodies()["bool"][:PROFILE_REQUESTS]
    knns = [{"query": {"knn": {"vec": {
        "vector": rng.standard_normal(DIM).astype(np.float32).tolist(),
        "k": 10}}}, "size": 10, "_source": False}
        for _ in range(PROFILE_REQUESTS)]
    n_segs = len(segs)
    for fn in counters.values():               # this path starts here
        fn.launches = 0
    kinds = {name: profile_turns(searcher.search, bodies, n_segs, name)
             for name, bodies in (("match", match), ("bool", bools),
                                  ("knn", knns))}
    plain_match = [searcher.search(b) for b in match]
    # msearch: each batch of 64 plain and profiled, in turns
    log_bodies = [match_body(a, b) for a, b in
                  corpus.zipf_query_log(64 * PROFILE_BATCHES, seed=7)]
    batches = [log_bodies[64 * i: 64 * (i + 1)]
               for i in range(PROFILE_BATCHES)]

    def msearch(batch):
        return searcher.msearch([dict(b) for b in batch])

    def msearch_profiled(batch):
        return searcher.msearch([dict(b, profile=True) for b in batch])

    for batch in batches:                      # warm both
        msearch(batch)
        msearch_profiled(batch)
    ms_plain, ms_prof = [], []
    for i, batch in enumerate(batches):
        order = (False, True) if i % 2 == 0 else (True, False)
        out = {}
        for profiled in order:
            t0 = time.monotonic()
            out[profiled] = (msearch_profiled if profiled
                             else msearch)(batch)
            (ms_prof if profiled else ms_plain).append(
                (time.monotonic() - t0) * 1e3 / len(batch))
        for got, want in zip(out[True], out[False]):
            check_profile(got, want, n_segs, "msearch")
            if got["profile"]["shards"][0]["engine"]["batch"][
                    "queries"] != len(batch):
                raise AssertionError("phase 18 msearch: a batch of 64 "
                                     "did not coalesce")
    kinds["msearch"] = {"p50_ms": float(np.median(ms_plain)),
                        "p50_profiled_ms": float(np.median(ms_prof)),
                        "extra_ms": float(np.median(ms_prof))
                        - float(np.median(ms_plain)),
                        "requests": 64 * PROFILE_BATCHES}
    # 16 profiled clients through the continuous batcher
    seq = [searcher.search(b) for b in log_bodies[:128]]

    class Shim:
        @staticmethod
        def _use_mesh(body):
            return False

    eng = engine_mod.query_engine()
    prev = (engine_mod.BATCHER_ENABLED, engine_mod.BATCHER_WINDOW_MS)
    engine_mod.BATCHER_ENABLED, engine_mod.BATCHER_WINDOW_MS = True, 4.0
    results = [None] * len(seq)
    errors = []

    def client(t):
        try:
            for i in range(t, len(seq), PROFILE_CLIENTS):
                results[i] = eng.execute(
                    searcher, dict(log_bodies[i], profile=True),
                    service=Shim())
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    s0 = eng.batcher.stats()
    threads = [threading.Thread(target=client, args=(t,), daemon=True)
               for t in range(PROFILE_CLIENTS)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
    finally:
        engine_mod.BATCHER_ENABLED, engine_mod.BATCHER_WINDOW_MS = prev
        eng.shutdown()
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"phase 18 continuous: {errors[:1]}")
    members = queue_ms = 0
    for got, want in zip(results, seq):
        check_profile(got, want, n_segs, "continuous")
        engine = got["profile"]["shards"][0]["engine"]
        if engine.get("batch", {}).get("continuous"):
            members += 1
            queue_ms += got["profile"]["shards"][0]["searches"][0][
                "query"][0]["breakdown"]["queue"] / 1e6
    s1 = eng.batcher.stats()
    if members != s1["batched"] - s0["batched"] or members == 0:
        raise AssertionError(f"phase 18 continuous: {members} profiled "
                             f"members, batcher {s0} -> {s1}")
    continuous = {"requests": len(seq), "members": members,
                  "groups": s1["dispatches"] - s0["dispatches"],
                  "mean_queue_ms": queue_ms / members}
    stats = led.stats()
    log(f"profile: p50 host ms unprofiled / profiled (extra): " + ", ".join(
        f"{k} {v['p50_ms']:.3f} / {v['p50_profiled_ms']:.3f} "
        f"({v['extra_ms']:+.3f})" for k, v in kinds.items())
        + f"; continuous {members} of {len(seq)} profiled members in "
        f"{continuous['groups']} groups, mean queue "
        f"{continuous['mean_queue_ms']:.3f} ms; every profiled answer "
        f"byte-equal, phases within took, segments summing to {n_segs}, "
        f"0 libraries built, on {gpu}")
    log(f"residency: {stats['resident_bytes']} bytes in "
        f"{stats['resident_segments']} groups, by kind {stats['by_kind']}; "
        f"pager {stats['pager']}; transfers {stats['transfers']}")
    # the ledger against the allocator: every evictable group out, then
    # the 16 views staged again, the collector held off in between (the
    # ledger grows as the allocator does); then requests over them
    # (prepared and batch inputs, live snapshots) and every group out
    # again: the allocator frees at least what the ledger says it
    # evicted and comes back to where it stood, so nothing the port keeps
    # holds an evicted tensor
    led.set_budget(1)
    gc.collect()
    torch.cuda.synchronize()
    r0, a0 = led.resident_bytes(), torch.cuda.memory_allocated()
    restages0 = led.stats()["budget"]["restages"]
    gc.disable()
    try:
        led.set_budget(0)
        t0 = time.monotonic()
        for seg in segs:
            seg.device(dev)
        torch.cuda.synchronize()
        stage_s = time.monotonic() - t0
        r1, a1 = led.resident_bytes(), torch.cuda.memory_allocated()
    finally:
        gc.enable()
    ids = {seg.seg_id for seg in segs}
    entries = sum(row["entries"] for row in led.segments()
                  if row["index"] == "scale" and row["segment"] in ids)
    slack = (a1 - a0) - (r1 - r0)
    if not 0 <= slack <= 512 * entries:
        raise AssertionError(f"phase 18: the ledger grew {r1 - r0} bytes, "
                             f"the allocator {a1 - a0} ({entries} tensors)")
    if led.stats()["budget"]["restages"] - restages0 != n_segs:
        raise AssertionError("phase 18: the 16 views were not restaged")
    for body in match[:10] + knns[:10]:
        searcher.search(body)
    msearch(batches[0])
    gc.collect()
    torch.cuda.synchronize()
    r2, a2 = led.resident_bytes(), torch.cuda.memory_allocated()
    ev0 = led.stats()["budget"]["evicted_bytes"]
    led.set_budget(1)
    gc.collect()
    torch.cuda.synchronize()
    r3, a3 = led.resident_bytes(), torch.cuda.memory_allocated()
    evicted = led.stats()["budget"]["evicted_bytes"] - ev0
    led.set_budget(0)
    if evicted < r1 - r0 or a2 - a3 < evicted or a3 - a0 > 512 * entries:
        raise AssertionError(
            f"phase 18 eviction: the ledger evicted {evicted} bytes, the "
            f"allocator freed {a2 - a3}; {a3 - a0} bytes more allocated "
            f"than after the first eviction (ledger {r0} -> {r3})")
    for seg in segs:                           # resident again
        seg.device(dev)
    memory = {"ledger_bytes": r1 - r0, "allocated_bytes": a1 - a0,
              "tensors": entries, "rounding_bytes": slack,
              "restage_all_s": stage_s, "evicted_bytes": evicted,
              "freed_bytes": a2 - a3, "left_bytes": a3 - a0}
    log(f"residency check: 16 f32 views restaged in {stage_s:.3f} s: the "
        f"ledger grew {r1 - r0} bytes, torch.cuda.memory_allocated() "
        f"{a1 - a0} ({slack} bytes of allocator rounding over {entries} "
        f"tensors); after 20 searches and a batch of 64 over them, "
        f"evicting everything: the "
        f"ledger evicted {evicted} bytes, the allocator freed {a2 - a3} "
        f"(the requests' inputs included) and stands {a3 - a0} bytes from "
        f"where the first eviction left it")
    # a budget that holds half the f32 segments: 50 match, byte-equal
    views = sorted(led.device_footprint(seg) for seg in segs)
    half = led.resident_bytes() - sum(views[: n_segs // 2])
    b0 = led.stats()["budget"]
    led.set_budget(half)
    t0 = time.monotonic()
    got = [searcher.search(b) for b in match]
    budget_s = time.monotonic() - t0
    b1 = led.stats()["budget"]
    led.set_budget(0)
    bad = [i for i, (g, w) in enumerate(zip(got, plain_match))
           if strip_took(g) != strip_took(w)]
    restages = b1["restages"] - b0["restages"]
    if bad or restages <= 0 or b1["host_fallbacks"]:
        raise AssertionError(f"phase 18 budget: answers {bad[:5]} differ, "
                             f"{restages} restages, {b1}")
    half_run = {"budget_bytes": half, "requests": len(match),
                "evictions": b1["evictions"] - b0["evictions"],
                "restages": restages,
                "ms_per_restage": (b1["restage_time_ms"]
                                   - b0["restage_time_ms"]) / restages,
                "ms_per_request": budget_s * 1e3 / len(match),
                "host_fallbacks": b1["host_fallbacks"]}
    log(f"budget (half the f32 segments, {half} bytes): {len(match)} match "
        f"byte-equal; {half_run['evictions']} evictions, {restages} "
        f"restages, {half_run['ms_per_restage']:.3f} ms a restage, "
        f"{half_run['ms_per_request']:.3f} ms a request; host fallbacks "
        f"{b1['host_fallbacks']}")
    # the int8 segments' pages under 1/4 of their quantized tables
    qbodies = [match_body(a, b) for a, b in pairs]
    led.set_budget(1)
    led.set_budget(0)
    qplain = [qsearcher.search(b) for b in qbodies]
    tables = pager.stats()["resident_bytes"]
    other = led.resident_bytes() - tables
    p0, b0 = pager.stats(), led.stats()["budget"]
    led.set_budget(other + tables // PAGER_SHARE)
    t0 = time.monotonic()
    qgot = [qsearcher.search(b) for b in qbodies]
    pager_s = time.monotonic() - t0
    p1, b1 = pager.stats(), led.stats()["budget"]
    led.set_budget(0)
    bad = [i for i, (g, w) in enumerate(zip(qgot, qplain))
           if strip_took(g) != strip_took(w)]
    if bad or b1["host_fallbacks"] or p1["evictions"] <= p0["evictions"]:
        raise AssertionError(f"phase 18 pager: answers {bad[:5]} differ; "
                             f"{p0} -> {p1}; {b1}")
    pager_run = {key: p1[key] - p0[key]
                 for key in ("hits", "misses", "prefetches", "evictions",
                             "evicted_pages")}
    pager_run.update({"tables_bytes": tables, "budget_bytes":
                      other + tables // PAGER_SHARE,
                      "page_bytes": p1["page_bytes"],
                      "restages": b1["restages"] - b0["restages"],
                      "ms_per_request": pager_s * 1e3 / len(qbodies),
                      "host_fallbacks": b1["host_fallbacks"]})
    log(f"pager (int8, pages under 1/4 of {tables} table bytes): "
        f"{len(qbodies)} match byte-equal; {pager_run}")
    launches = {name: fn.launches for name, fn in counters.items()}
    path = ("term_bag_topk", "plan_topk", "knn_topk", "batch_topk",
            "term_bag_quantized_topk")
    if min(launches[name] for name in path) <= 0:
        raise AssertionError(f"phase 18: a kernel of the path never "
                             f"launched: {launches}")
    log(f"phase 18 launches: {launches}")
    # the device ms of kernel-table rows 10 and 14
    gen = torch.Generator(device=dev).manual_seed(182)
    n_ann = 73_970                   # a phase 13 segment's rows (100-d)
    ann_vecs = torch.randn(n_ann, 100, generator=gen, device=dev)
    ann_valid = torch.ones(n_ann, dtype=torch.bool, device=dev)
    nlist = int(np.sqrt(n_ann))
    kmeans_ms = device_ms_per_call(
        lambda: train_kmeans(ann_vecs, ann_valid, nlist, device=dev), 3)
    kmeans_wall = cuda_ms(
        lambda: train_kmeans(ann_vecs, ann_valid, nlist, device=dev), 3)
    n_q, n_rows, dim, k = KNN_BATCH
    vecs = torch.randn(n_rows, dim, generator=gen, device=dev)
    queries = torch.randn(n_q, dim, generator=gen, device=dev)
    valid = torch.ones(n_rows, dtype=torch.bool, device=dev)
    batch_ms = device_ms_per_call(
        lambda: knn_topk_batch(vecs, valid, queries, space="l2", k=k), 10)
    kernel_rows = {"train_kmeans_device_ms": kmeans_ms,
                   "train_kmeans_ms": kmeans_wall,
                   "knn_topk_batch_device_ms": batch_ms}
    log(f"device ms: train_kmeans ({n_ann} x 100, nlist {nlist}, 10 "
        f"iterations) {kmeans_ms} a call ({kmeans_wall:.3f} ms by CUDA "
        f"events); knn_topk_batch ({n_q} queries over {n_rows} x {dim}, "
        f"k = {k}) {batch_ms} on {gpu}")
    wall = time.monotonic() - t_phase
    log(f"phase 18: {wall:.1f} s")
    return {"kinds": kinds, "continuous": continuous, "memory": memory,
            "half_budget": half_run, "pager": pager_run,
            "kernel_rows": kernel_rows, "stats_by_kind": stats["by_kind"],
            "launches": launches, "wall_s": wall}


# -- phase 2 (K10) and phase 19: the mesh ------------------------------------

MESH_SHARDS = 4                  # phase 19: the 16 scale segments as 4 x 4
MESH_PER_KIND = 20               # requests of each kind, each route
MESH_CPU_S = 40                  # phase 19's seconds for the CPU mesh
MESH_DEMOTE_DOCS = 2_000         # docs of the 4-shard ``search.mesh`` index


def mesh_rows(rng, n_rows: int, k: int) -> np.ndarray:
    """``n_rows`` top-k lists as the mesh merges them: sorted descending,
    drawn from few values (ties within and across rows), each padded with
    a random run of -inf (one row all -inf)."""
    vals = rng.choice(np.float32([7.5, 3.25, 3.0, 2.0, 1.5, 1.0, 0.5, 0.0]),
                      size=(n_rows, k)) + rng.integers(
        0, 3, size=(n_rows, k)).astype(np.float32) * 0.25
    vals = -np.sort(-vals.astype(np.float32), axis=1)
    for r in range(n_rows):
        pad = k if r == n_rows - 1 else int(rng.integers(0, k + 1))
        if pad:
            vals[r, k - pad:] = -np.inf
    return vals


def phase_mesh_merge() -> dict:
    """K10 (``csrc/mesh_merge.cu``, ``ops/cuda_mesh.py``) against its plain
    version ``mesh_merge_plain`` (a stable descending sort of the flat
    values) on the card, byte for byte (values and flat indices), on
    random rows with ties and -inf padding at S = 4 and 8 rows and k =
    10 and 1,000, and at phase 19's shape (16 rows: 4 shards x 4
    segments, k = 10); one launch a call.  Then timed at phase 19's shape
    in turns with the plain version, beside ``torch.topk`` over the flat
    values."""
    import torch

    from opensearch_tpu_torch.ops import cuda_mesh
    from opensearch_tpu_torch.ops.mesh import mesh_merge, mesh_merge_plain

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(191)
    kernel = cuda_mesh.mesh_merge_cuda
    shapes = [(4, 10), (8, 10), (4, 1000), (8, 1000), (16, 10)]
    n_checks = 0
    for rows, k in shapes:
        for _ in range(3):
            vals = torch.from_numpy(mesh_rows(rng, rows, k)).to(dev)
            for kk in (k, 1, min(rows * k, 3 * k // 2)):
                before = kernel.launches
                got_v, got_i = mesh_merge(vals, kk)
                if kernel.launches - before != 1:
                    raise AssertionError("a K10 call made "
                                         f"{kernel.launches - before} "
                                         "launches")
                want_v, want_i = mesh_merge_plain(vals, kk)
                torch.cuda.synchronize()
                if got_v.cpu().numpy().tobytes() != \
                        want_v.cpu().numpy().tobytes() or \
                        not torch.equal(got_i.cpu(), want_i.cpu()):
                    raise AssertionError(f"K10 differs from its plain "
                                         f"version at {rows} x {k}, "
                                         f"k = {kk}")
                n_checks += 1
    log(f"K10: {n_checks} calls byte-equal to mesh_merge_plain (rows x k "
        f"{shapes}, each at k, 1 and 1.5 k), one launch each")
    rows, k = MESH_SHARDS * 4, 10
    vals = torch.from_numpy(mesh_rows(rng, rows, k)).to(dev)
    ms, plain_ms = in_turns(lambda: mesh_merge(vals, k),
                            lambda: mesh_merge_plain(vals, k), 50)
    lib_ms = cuda_ms(lambda: torch.topk(vals.reshape(-1), k), 50)
    dev_ms = kernel_device_ms(lambda: mesh_merge(vals, k), 50,
                              "mesh_merge_kernel")
    if dev_ms is None:
        raise AssertionError("the profiler shows no K10 kernel")
    nbytes = rows * k * 4.0 + k * 12.0
    bms, by = bound_ms(nbytes, 0.0)
    log(f"K10 at {rows} x {k} (phase 19's shape), k = {k}: ms {ms:.4f} "
        f"device_ms {dev_ms:.5f} plain_ms (stable sort) {plain_ms:.4f} "
        f"library_ms (torch.topk over the flat values) {lib_ms:.4f} "
        f"bound_ms {bms:.7f} ({by}: {nbytes:.0f} bytes; launch-bound) on "
        f"{gpu_name_power()}")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
            "bound_bytes": nbytes, "max_abs_err": 0.0, "rows": rows,
            "k": k, "checks": n_checks}


def mesh_mismatch(got: dict, want: dict, shard_key: bool = True):
    """None when two responses agree byte for byte (``took`` and, with
    ``shard_key`` False, the mesh-only ``_shard`` left out; a double
    sum or average within rtol 1e-12), else what differs."""
    def norm(resp):
        out = {k: v for k, v in resp.items() if k not in ("took",
                                                           "_shards")}
        out["hits"] = dict(resp["hits"], hits=[
            {k: v for k, v in h.items() if shard_key or k != "_shard"}
            for h in resp["hits"]["hits"]])
        return out

    a, b = norm(got), norm(want)
    aggs_a, aggs_b = a.pop("aggregations", None), b.pop("aggregations",
                                                        None)
    if json.dumps(a, sort_keys=True) != json.dumps(b, sort_keys=True):
        return f"hits differ: {json.dumps(a)[:300]} vs {json.dumps(b)[:300]}"
    for name, want_agg in (aggs_b or {}).items():
        for key, w in want_agg.items():
            g = aggs_a[name][key]
            if key in ("sum", "avg", "value") and isinstance(w, float):
                if abs(g - w) > 1e-12 * abs(w):
                    return f"{name}.{key}: {g} vs {w}"
            elif g != w:
                return f"{name}.{key}: {g} vs {w}"
    return None


def phase_mesh(segs, mapper, searcher, counters) -> dict:
    """Phase 19: the mesh.  The 16 scale segments regrouped into
    ``MESH_SHARDS`` shards of 4 (their views already staged) on a mesh of
    ``[cuda:0] * 4`` (one card stands in for four: the shards' top-k
    lists meet on the first mesh device, a view on one card): per kind
    ``MESH_PER_KIND`` requests (``match`` from the median bag on,
    phase 10's ``bool``, ``knn`` k = 10, a ``price`` ``range`` and a
    ``size: 0`` ``stats`` on the double ``fare``) through
    ``MeshSearcher``, through the host scatter on the card and through
    the node-local searcher (p50 host ms of each; the node-local one
    scores with index-wide statistics); every mesh answer byte-equal to
    the host scatter's (double sums within rtol 1e-12) and to the same
    ``MeshSearcher`` on the CPU (in turns over the kinds; should the CPU
    take more than ``MESH_CPU_S`` seconds, the checks stop there, each
    kind held at least twice, and the count is printed); launches a mesh
    request (K2 top-k or plan top-k a shard, 1 K10; 1 K5 call a shard
    for ``stats``), the counts zeroed just before the mesh requests and
    read just after; K10's device ms on a ``match``'s own lists.  Then a
    ``search.mesh`` index of 4 shards on this one-card node: its
    ``_mesh_search`` demotes to the host scatter, counted in
    ``search.mesh.fallback`` and in the ``mesh`` breaker."""
    import shutil
    import tempfile

    import torch

    from opensearch_tpu_torch.common.device_health import device_health
    from opensearch_tpu_torch.common.telemetry import metrics
    from opensearch_tpu_torch.indices.service import IndicesService
    from opensearch_tpu_torch.ops import cuda_mesh
    from opensearch_tpu_torch.ops.mesh import mesh_merge
    from opensearch_tpu_torch.parallel.dist_search import (MeshSearcher,
                                                           host_scatter)
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing import corpus

    t_phase = time.monotonic()
    gpu = gpu_name_power()
    dev = torch.device(DEVICE)
    per = len(segs) // MESH_SHARDS

    def shard_searchers(device):
        return [ShardSearcher(segs[i * per: (i + 1) * per], mapper,
                              index_name="mesh", shard_id=i, device=device)
                for i in range(MESH_SHARDS)]

    shards = shard_searchers(DEVICE)
    mesh = MeshSearcher(shards, [dev] * MESH_SHARDS)
    rng = np.random.default_rng(192)
    pf0 = segs[0].postings["body"]
    pairs = corpus.zipf_query_log(200, seed=7)
    median = sorted(pairs, key=lambda p: df_sum(
        pf0, [f"t{p[0]}", f"t{p[1]}"]))[len(pairs) // 2]
    width = int(corpus.PRICE_MAX * 0.1)

    def knn_bodies(n):
        # fresh vectors for each route: a repeated knn body takes its
        # winners from the plan cache and launches no K1
        return [{"query": {"knn": {"vec": {
            "vector": rng.standard_normal(DIM).astype(np.float32).tolist(),
            "k": 10}}}, "size": 10, "_source": False} for _ in range(n)]

    bodies = {
        "match": [match_body(*median)] + [
            match_body(a, b) for a, b in corpus.zipf_query_log(
                MESH_PER_KIND - 1, seed=193)],
        "bool": phase10_bodies()["bool"][:MESH_PER_KIND],
        "knn": knn_bodies(MESH_PER_KIND),
        "range": [{"query": {"range": {"price": {"gte": lo,
                                                 "lt": lo + width}}},
                   "size": 10, "_source": False}
                  for lo in rng.integers(0, corpus.PRICE_MAX - width,
                                         size=MESH_PER_KIND).tolist()],
        "stats": [{"size": 0, "query": {"range": {"price": {
            "gte": lo, "lt": lo + 4 * width}}},
            "aggs": {"s": {"stats": {"field": "fare"}}}}
            for lo in rng.integers(0, corpus.PRICE_MAX - 4 * width,
                                   size=MESH_PER_KIND).tolist()]}

    def run_mesh(body):
        aggs = body.get("aggs")
        return mesh.mesh_metric_aggs(body, aggs) if aggs else \
            mesh.search(body)

    def run_scatter(body):
        return host_scatter(shards, body)

    for kind, items in bodies.items():          # warm every route
        for body in (knn_bodies(2) if kind == "knn" else items[:2]):
            run_mesh(body), run_scatter(body), searcher.search(body)
    torch.cuda.synchronize()
    for fn in counters.values():                # the mesh path starts here
        fn.launches = 0
    p50, launches, answers = {}, {}, {}
    for kind, items in bodies.items():
        before = {n: fn.launches for n, fn in counters.items()}
        lat, out = [], []
        for body in items:
            t = time.monotonic()
            out.append(run_mesh(body))
            lat.append((time.monotonic() - t) * 1e3)
        launches[kind] = {n: (fn.launches - before[n]) / len(items)
                          for n, fn in counters.items()
                          if fn.launches > before[n]}
        p50[kind] = {"mesh": float(np.median(lat))}
        answers[kind] = out
    mesh_launches = {n: fn.launches for n, fn in counters.items()}
    for kind, items in bodies.items():
        for route, fn in (("host_scatter", run_scatter),
                          ("node_local", searcher.search)):
            lat = []
            for body in (knn_bodies(len(items)) if kind == "knn"
                         else items):
                t = time.monotonic()
                fn(body)
                lat.append((time.monotonic() - t) * 1e3)
            p50[kind][route] = float(np.median(lat))
    # launches a mesh request: a shard's top-k (K2 for a match, the plan
    # top-k otherwise, K5 for the stats) and one K10
    for kind, per_req in launches.items():
        merge = per_req.get("mesh_merge", 0)
        top = per_req.get("term_bag_topk" if kind == "match" else
                          "bucket_collect" if kind == "stats" else
                          "plan_topk", 0)
        if top != MESH_SHARDS or merge != (0 if kind == "stats" else 1) \
                or (kind == "knn" and per_req.get("knn_topk") != top):
            raise AssertionError(f"mesh {kind}: {per_req} launches a "
                                 f"request, expected {MESH_SHARDS} top-k "
                                 "(or K5; and K1 for a knn) and 1 K10")
    # every answer equal to the host scatter on the card and to the same
    # mesh on the CPU
    for kind, items in bodies.items():
        for body, got in zip(items, answers[kind]):
            bad = mesh_mismatch(got, run_scatter(body), shard_key=False)
            if bad:
                raise AssertionError(f"mesh {kind} vs the host scatter: "
                                     f"{bad}")
        if not any(r["hits"]["total"]["value"] for r in answers[kind]):
            raise AssertionError(f"mesh {kind}: nothing matched")
    cpu_mesh = MeshSearcher(shard_searchers("cpu"),
                            [torch.device("cpu")] * MESH_SHARDS)
    t_cpu = time.monotonic()
    cpu_checked = dict.fromkeys(bodies, 0)
    for j in range(MESH_PER_KIND):
        if j >= 2 and time.monotonic() - t_cpu > MESH_CPU_S:
            break
        for kind, items in bodies.items():
            body, got = items[j], answers[kind][j]
            want = (cpu_mesh.mesh_metric_aggs(body, body["aggs"])
                    if body.get("aggs") else cpu_mesh.search(body))
            bad = mesh_mismatch(got, want)
            if bad:
                raise AssertionError(f"mesh {kind} vs the CPU mesh: {bad}")
            cpu_checked[kind] += 1
    cpu_s = time.monotonic() - t_cpu
    # K10 on a match's own lists: the 16 (shard, segment) rows of k = 10
    blocks = []
    for s in shards:
        (plan, bind), ckey = s.compiled(bodies["match"][0]["query"],
                                        with_key=True)
        blocks.append(s.topk_launch(plan, bind, plan.arrays(), 10, None,
                                    ckey=ckey)[0].vals)
    vals = torch.cat(blocks)
    k10_dev = kernel_device_ms(lambda: mesh_merge(vals, 10), 50,
                               "mesh_merge_kernel")
    k10_bytes = vals.numel() * 4.0 + 10 * 12.0
    k10_bound, _by = bound_ms(k10_bytes, 0.0)
    # the one-card node: a 4-shard search.mesh index demotes, counted
    path = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        reg = IndicesService(path, device=DEVICE)
        idx = reg.create("meshed", {"settings": {
            "number_of_shards": MESH_SHARDS, "search.mesh": True},
            "mappings": WRITE_MAPPING})
        texts = corpus.render_texts(MESH_DEMOTE_DOCS, seed=194)
        idx.bulk([("index", str(i), {"body": t,
                                     "tag": WRITE_TAGS[i % 5]}, {})
                  for i, t in enumerate(texts)])
        idx.refresh()
        body = {"query": {"match": {"body": "t0 t7"}}, "size": 10}
        if idx._use_mesh(body):
            raise AssertionError("one card: _use_mesh must be false for "
                                 f"{MESH_SHARDS} shards")
        health = device_health()
        fb = metrics().counter("search.mesh.fallback").value
        failures = health.stats()["breakers"]["mesh"]["failures"]
        demoted = idx._mesh_search(dict(body))
        if metrics().counter("search.mesh.fallback").value != fb + 1 or \
                health.stats()["breakers"]["mesh"]["failures"] \
                != failures + 1:
            raise AssertionError("the one-card demotion was not counted")
        bad = mesh_mismatch(demoted, idx._host_scatter_search(dict(body)))
        if bad or not demoted["hits"]["hits"]:
            raise AssertionError(f"the demoted answer: {bad}")
        health.reset()
        reg.close()
    finally:
        shutil.rmtree(path, ignore_errors=True)
    seconds = time.monotonic() - t_phase
    for kind in bodies:
        log(f"mesh {kind}: p50 host ms mesh {p50[kind]['mesh']:.3f} / host "
            f"scatter {p50[kind]['host_scatter']:.3f} / node-local "
            f"{p50[kind]['node_local']:.3f}; launches a request "
            f"{launches[kind]} on {gpu}")
    log(f"mesh checks: {sum(len(v) for v in bodies.values())} answers equal "
        f"to the host scatter, {cpu_checked} to the CPU mesh (in "
        f"{cpu_s:.1f} s of the CPU's); "
        f"K10 on a match's {vals.shape[0]} x 10 lists: device_ms "
        f"{k10_dev} bound_ms {k10_bound:.7f} ({k10_bytes:.0f} bytes); the "
        f"one-card {MESH_SHARDS}-shard index demoted to the host scatter "
        f"(counted); phase 19 {seconds:.1f}s")
    return {"p50_ms": p50, "launches_per_request": launches,
            "launches": {n: v for n, v in mesh_launches.items()},
            "k10_device_ms": k10_dev, "k10_bound_ms": k10_bound,
            "cpu_mesh_checked": cpu_checked, "cpu_mesh_s": cpu_s,
            "seconds": seconds}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from opensearch_tpu_torch.ops import (cuda_aggs, cuda_bm25, cuda_knn,
                                          cuda_mesh, cuda_plan,
                                          cuda_positions)
    from opensearch_tpu_torch.testing.corpus import zipf_query_log

    t_start = time.monotonic()
    phase_toolkit()
    segs, mapper, searcher, raw = build_scale()
    quant = {dtype: build_quantized(raw, mapper, dtype)
             for dtype in ("int8", "int16")}
    del raw
    kern = phase_kernels(segs, searcher, zipf_query_log(200, seed=7))
    kern["term_bag_quantized"] = phase_quantized_kernels(
        quant, segs, searcher, zipf_query_log(200, seed=7))
    from opensearch_tpu_torch.testing.k4_sweep import pick_bags
    code_heavy = pick_bags(quant["int8"][1], zipf_query_log(200, seed=7))[
        "code-heavy"][0]
    kern.update(phase_fold(segs, searcher, quant,
                           {**kern.pop("bags"), "code-heavy": code_heavy}))
    kern["plan_topk"] = phase_plan_topk(
        segs, searcher, torch.Generator().manual_seed(15))
    kern.update(phase_k5(segs, searcher))
    kern.update(phase_positions(segs))
    kern["mesh_merge"] = phase_mesh_merge()
    dev = torch.device(DEVICE)
    ivf_check = phase_ivf_kernels(dev, torch.Generator(device=dev)
                                  .manual_seed(16))
    phase_ivf_searcher(dev)

    counters = {"knn_topk": cuda_knn.knn_topk_segments_cuda,
                "knn_scores": cuda_knn.knn_scores_segments_cuda,
                "term_bag_scores": cuda_bm25.dense_f32,
                "term_bag_topk": cuda_bm25.term_bag_topk_segments_cuda,
                "batch_topk": cuda_bm25.batch_term_bag_topk_cuda,
                "plan_topk": cuda_plan.plan_topk_segments_cuda}
    for fn in counters.values():              # the main path starts here
        fn.launches = 0
    phase_ingest()
    after_ingest = {n: fn.launches for n, fn in counters.items()}
    scale = phase_scale(segs, mapper, searcher)
    launches = {n: fn.launches for n, fn in counters.items()}
    log(f"launches over phases 3-4: {launches} (ingest {after_ingest})")
    sequential_path = [n for n in counters if n != "batch_topk"]
    if min(launches[n] for n in sequential_path) <= 0 or \
            min(after_ingest[n] for n in sequential_path) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches} (ingest {after_ingest})")
    # the batched path: msearch, then the continuous batcher, each with
    # the counts zeroed just before it and read just after
    bodies = [match_body(a, b) for a, b in zipf_query_log(256, seed=7)]
    msearch = phase_msearch(searcher, bodies, counters)
    continuous = phase_continuous(searcher, bodies, msearch.pop("seq"),
                                  counters)
    launches["batch_topk"] = (msearch["launches"]["batch_topk"]
                              + continuous["launches"]["batch_topk"])
    # the quantized path, its counts zeroed just before it
    qsegs, qsearcher, qbuild = quant["int8"]
    qscale = phase_quantized_scale(qsegs, mapper, qsearcher, qbuild,
                                   {**counters, **quantized_counters()})
    launches["term_bag_quantized"] = \
        qscale["k4_launches"]["term_bag_quantized_topk"]
    launches["term_bag_quantized_scores"] = \
        qscale["k4_launches"]["term_bag_quantized_scores"]
    # the write path, then the serving node, each with its counts zeroed
    # just before it and read just after
    write = phase_write_path({**counters, **quantized_counters()})
    every = {**counters, **quantized_counters()}
    serving = phase_serving(every, then=lambda node, state: {
        "hybrid": phase_http_hybrid(node, state, every),
        "aggs": phase_http_aggs(node, state, every),
        "script": phase_http_script(node, state, every),
        "ann": phase_http_ann(node, state, every),
        "phrase": phase_http_phrase(node, state, every),
        "sort": phase_http_sort(node, state, every),
        "relevance": phase_http_relevance(node, state, every),
        "relations": phase_http_relations(node, state, every)})
    then = serving.pop("then")
    filters = phase_filters_hybrid(segs, mapper, searcher, qsegs, qsearcher,
                                   every, http=then["hybrid"])
    aggs = phase_aggs(segs, mapper, searcher, qsegs, qsearcher, every,
                      http=then["aggs"])
    launches["bucket_collect"] = aggs["k5_launches"] + round(
        then["aggs"]["k5_launches_per_request"] * HTTP_AGGS)
    if launches["bucket_collect"] <= 0:
        raise AssertionError("K5 never launched on the aggregations path")
    script = phase_script_score(segs, mapper, searcher, every,
                                http=then["script"])
    ann = phase_ann(every)
    launches["ivf_search"] = launches["ivfpq_search"] = 0
    for phase in (write, serving, filters, aggs, script, then["ann"], ann):
        for name, n in phase["launches"].items():
            name = "term_bag_quantized" \
                if name == "term_bag_quantized_topk" else name
            launches[name] += n
    if min(launches["ivf_search"], launches["ivfpq_search"]) <= 0:
        raise AssertionError(f"K6 or K7 never launched on the ANN path: "
                             f"{launches}")
    # phrase and proximity, K8 / K9's counts zeroed just before it
    phrase = phase_phrase(segs, mapper, searcher, qsearcher)
    for name, n in phrase["launches"].items():
        launches[name] = n + then["phrase"]["launches"].get(name, 0)
    # the result features, their counts zeroed just before them
    sort = phase_sort(segs, mapper, searcher,
                      {**every, "phrase_freqs":
                       cuda_positions.phrase_scores_cuda})
    # the relevance-shaping, multi-term and geo queries, their counts
    # zeroed just before them
    relevance = phase_relevance(segs, mapper, searcher, every,
                                http=then["relevance"])
    # the relationship queries and the reader contexts, their counts
    # zeroed just before them
    relations = phase_relations(segs, mapper, searcher, every,
                                http=then["relations"])
    # the Profile API and device residency, their counts zeroed just
    # before them
    profile = phase_profile_residency(segs, searcher, qsegs, qsearcher,
                                      every)
    # the mesh, its counts zeroed just before its requests
    mesh = phase_mesh(segs, mapper, searcher, {
        **every, "bucket_collect": cuda_aggs.bucket_collect_cuda,
        "mesh_merge": cuda_mesh.mesh_merge_cuda})
    if min(mesh["launches"].get(n, 0) for n in (
            "term_bag_topk", "plan_topk", "knn_topk", "bucket_collect",
            "mesh_merge")) <= 0:
        raise AssertionError(f"a kernel of the mesh path never launched: "
                             f"{mesh['launches']}")
    for phase in (sort, then["sort"], relevance, then["relevance"],
                  relations, then["relations"], profile, mesh):
        for name, n in phase["launches"].items():
            name = "term_bag_quantized" \
                if name == "term_bag_quantized_topk" else name
            launches[name] = launches.get(name, 0) + n
    for name in ("ivf_search", "ivfpq_search"):
        kern[name] = dict(ann["kernels"][name])
        kern[name]["max_abs_err"] = max(kern[name]["max_abs_err"],
                                        ivf_check["max_abs_err"])
    sources = {"knn_topk": ("knn.cu", "opensearch_tpu/ops/pallas_knn.py:62"),
               "knn_scores": ("knn.cu",
                              "opensearch_tpu/ops/pallas_knn.py:62"),
               "term_bag_scores": ("bm25.cu",
                                   "opensearch_tpu/ops/bm25.py:191"),
               "term_bag_topk": ("bm25.cu",
                                 "opensearch_tpu/search/plan.py:1760"),
               "batch_topk": ("union_topk.cu",
                              "opensearch_tpu/search/batch.py:69"),
               # and gather_postings_packed, opensearch_tpu/ops/bm25.py:114
               "term_bag_quantized": ("quant_topk.cu",
                                      "opensearch_tpu/ops/quantized.py:46"),
               "term_bag_quantized_scores": (
                   "bm25.cu", "opensearch_tpu/ops/quantized.py:64"),
               # and :67, :80, :92, :107 (bucketed_counts, masked_metrics,
               # per_doc_partials, scatter_partials_to_buckets)
               "bucket_collect": ("aggs.cu",
                                  "opensearch_tpu/ops/aggs.py:58"),
               # and topk_from_scores, opensearch_tpu/search/plan.py:1773
               "plan_topk": ("plan_topk.cu",
                             "opensearch_tpu/search/plan.py:1760"),
               # and ivf_search_batch, opensearch_tpu/ops/ivf.py:170
               "ivf_search": ("ivf.cu", "opensearch_tpu/ops/ivf.py:140"),
               "ivfpq_search": ("ivf.cu", "opensearch_tpu/ops/ivf.py:236"),
               # and gather_term_positions, opensearch_tpu/ops/phrase.py:27
               "phrase_freqs": ("positions.cu",
                                "opensearch_tpu/ops/phrase.py:49"),
               "span_near": ("positions.cu",
                             "opensearch_tpu/ops/span.py:32"),
               # and :489 sharded_metric_reduce (torch ops), :513
               # sharded_impact_topk
               "mesh_merge": ("mesh_merge.cu",
                              "opensearch_tpu/parallel/dist_search.py:170")}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    ivf_keys = ("device_ms", "span_ms", "probe_device_ms",
                "table_device_ms", "scan_device_ms")
    kernels = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"opensearch_tpu_torch/csrc/{src}", "replaces": rep,
         "launches": launches[name],
         **{key: kern[name][key] for key in keys},
         **{key: kern[name][key] for key in ivf_keys
            if name in ("ivf_search", "ivfpq_search")}}
        for name, (src, rep) in sources.items()]}
    log(json.dumps({"scale": scale, "msearch": msearch,
                    "continuous": continuous, "quantized_scale": qscale,
                    "write_path": write, "serving": serving,
                    "filters_hybrid": filters, "aggregations": aggs,
                    "script_score": script,
                    "ann": {k: v for k, v in ann.items() if k != "kernels"},
                    "ann_over_http": then["ann"],
                    "ivf_kernels": ann["kernels"],
                    "phrase": phrase, "phrase_over_http": then["phrase"],
                    "sort": sort, "sort_over_http": then["sort"],
                    "relevance": {k: v for k, v in relevance.items()
                                  if k != "http"},
                    "relevance_over_http": then["relevance"],
                    "relations": {k: v for k, v in relations.items()
                                  if k != "http"},
                    "relations_over_http": then["relations"],
                    "profile_residency": profile, "mesh": mesh,
                    "k10": kern["mesh_merge"],
                    "k8_k9": {n: kern[n] for n in ("phrase_freqs",
                                                   "span_near")},
                    "k1_scores_16": kern["knn_scores_16"],
                    "k5": kern["bucket_collect"], "masks": kern["masks"],
                    "dense": {n: kern[n] for n in (
                        "term_bag_scores", "term_bag_quantized_scores")},
                    "plan_topk": kern["plan_topk"],
                    "k1_1m": kern["k1_1m"],
                    "k2_topk_heaviest": kern["term_bag_topk"]["heaviest"],
                    "k4_topk_heaviest":
                        kern["term_bag_quantized"]["heaviest"],
                    "k3_k100": kern["batch_topk"]["k100"],
                    "device_ms": {n: kern[n].get("device_ms")
                                  for n in sources},
                    "wall_s": time.monotonic() - t_start}))
    log(f"chip_smoke total: {time.monotonic() - t_start:.1f}s")
    log(json.dumps(kernels))
    log(gpu_name_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
