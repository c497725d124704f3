"""Suggesters: term (did-you-mean per token), phrase (whole-input
correction) and completion (the port of the JAX package's
``search/suggest.py``; host only).

Analog of ``search/suggest/`` (term, phrase suggesters; the completion
suggester's FST is replaced by the same vocabulary scan).  Candidate
generation walks the shard vocabulary with a banded edit-distance
check — a host-side operation over the term dictionary, exactly where
the reference runs its DirectSpellChecker.  ``run_suggest`` answers a
search body's ``suggest`` section on one searcher; ``merge_suggest`` is
the coordinator's reduce over several indices.
"""

from __future__ import annotations

from typing import Optional

from opensearch_tpu_torch.common.errors import (IllegalArgumentError,
                                          ParsingError)


def _edit_distance(a: str, b: str, cap: int) -> int:
    """Banded Levenshtein, capped at ``cap`` + 1."""
    if abs(len(a) - len(b)) > cap:
        return cap + 1
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        lo, hi = max(1, i - cap), min(len(b), i + cap)
        if lo > 1:
            cur[lo - 1] = cap + 1
        for j in range(lo, hi + 1):
            cost = 0 if ca == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        for j in range(hi + 1, len(b) + 1):
            cur[j] = cap + 1
        prev = cur
        if min(prev) > cap:
            return cap + 1
    return prev[-1]


class Suggester:
    def __init__(self, ctx):
        self.ctx = ctx               # compiler.ShardContext

    # -- vocabulary access -------------------------------------------------

    def _vocab(self, field: str) -> dict[str, int]:
        """term -> df across the context's segments (cached on the
        searcher context: segments are immutable, so one scan serves
        every suggester until the searcher is reopened)."""
        from opensearch_tpu_torch.common.cache import attached_cache
        cache = attached_cache(self.ctx, "_suggest_vocab",
                               name="suggest.vocab",
                               max_weight=32 << 20, breaker="fielddata")
        vocab = cache.get(field)
        if vocab is not None:
            return vocab
        out: dict[str, int] = {}
        for seg in self.ctx.segments:
            pf = seg.postings.get(field)
            if pf is None:
                continue
            for term, tid in pf.terms.items():
                df = int(pf.df[tid])
                if df > 0:
                    out[term] = out.get(term, 0) + df
        cache.put(field, out)
        return out

    def _candidates(self, term: str, vocab: dict, max_edits: int,
                    prefix_length: int, min_len: int = 1) -> list:
        """[(candidate, df, distance)] sorted by (distance, -df)."""
        prefix = term[:prefix_length]
        out = []
        for cand, df in vocab.items():
            if len(cand) < min_len:
                continue
            if prefix_length and not cand.startswith(prefix):
                continue
            d = _edit_distance(term, cand, max_edits)
            if d <= max_edits:
                out.append((cand, df, d))
        out.sort(key=lambda t: (t[2], -t[1], t[0]))
        return out

    # -- term suggester ----------------------------------------------------

    def term_suggest(self, text: str, spec: dict) -> list[dict]:
        field = spec.get("field")
        if not field:
            raise ParsingError("[term] suggester requires a [field]")
        ft = self.ctx.field_type(field)
        if ft is None or not hasattr(ft, "search_terms"):
            raise IllegalArgumentError(
                f"[term] suggester field [{field}] must be a text field")
        max_edits = int(spec.get("max_edits", 2))
        if not (1 <= max_edits <= 2):
            raise IllegalArgumentError("[max_edits] must be 1 or 2")
        size = int(spec.get("size", 5))
        prefix_length = int(spec.get("prefix_length", 1))
        suggest_mode = spec.get("suggest_mode", "missing")
        vocab = self._vocab(field)
        out = []
        import re as _re
        for m in _re.finditer(r"\S+", str(text)):
            token = m.group()
            terms = ft.search_terms(token, self.ctx.mapper.analyzers)
            analyzed = terms[0] if terms else token.lower()
            entry = {"text": token, "offset": m.start(),
                     "length": len(token), "options": []}
            in_vocab = analyzed in vocab
            if not (suggest_mode == "missing" and in_vocab):
                for cand, df, dist in self._candidates(
                        analyzed, vocab, max_edits, prefix_length):
                    if cand == analyzed:
                        continue
                    if suggest_mode == "popular" and in_vocab and \
                            df <= vocab[analyzed]:
                        continue
                    entry["options"].append({
                        "text": cand, "freq": df,
                        "score": round(
                            1.0 - dist / max(len(analyzed), 1), 5)})
                    if len(entry["options"]) >= size:
                        break
            out.append(entry)
        return out

    # -- phrase suggester --------------------------------------------------

    def phrase_suggest(self, text: str, spec: dict) -> list[dict]:
        """Whole-input correction: per-token best candidate joined back
        (the reference's phrase suggester scores candidate lattices with
        a language model; the unigram-df greedy walk is its degenerate
        laplace-smoothed case)."""
        field = spec.get("field")
        if not field:
            raise ParsingError("[phrase] suggester requires a [field]")
        ft = self.ctx.field_type(field)
        if ft is None or not hasattr(ft, "search_terms"):
            raise IllegalArgumentError(
                f"[phrase] suggester field [{field}] must be text")
        max_errors = float(spec.get("max_errors", 1.0))
        size = int(spec.get("size", 1))
        vocab = self._vocab(field)
        tokens = str(text).split()
        budget = (int(max_errors) if max_errors >= 1
                  else max(1, int(max_errors * len(tokens))))
        corrected = []
        changed = 0
        for token in tokens:
            terms = ft.search_terms(token, self.ctx.mapper.analyzers)
            analyzed = terms[0] if terms else token.lower()
            if analyzed in vocab or changed >= budget:
                corrected.append((token, False))
                continue
            cands = self._candidates(analyzed, vocab, 2, 1)
            if cands:
                corrected.append((cands[0][0], True))
                changed += 1
            else:
                corrected.append((token, False))
        options = []
        if changed:
            phrase = " ".join(t for t, _c in corrected)
            highlighted = None
            if spec.get("highlight"):
                pre = spec["highlight"].get("pre_tag", "<em>")
                post = spec["highlight"].get("post_tag", "</em>")
                highlighted = " ".join(
                    f"{pre}{t}{post}" if c else t for t, c in corrected)
            opt = {"text": phrase,
                   "score": round(1.0 / (1.0 + changed), 5)}
            if highlighted is not None:
                opt["highlighted"] = highlighted
            options.append(opt)
        return [{"text": text, "offset": 0, "length": len(text),
                 "options": options[:size]}]


def completion_suggest(ctx, prefix: str, spec: dict) -> list[dict]:
    """Prefix completion over the sorted ordinal column — a
    binary-searched range per segment instead of an FST walk
    (suggest/completion/CompletionSuggester.java), merged by best
    weight across segments."""
    import bisect

    field = spec.get("field")
    if not field:
        raise ParsingError("[completion] requires a [field]")
    size = int(spec.get("size", 5))
    skip_dup = bool(spec.get("skip_duplicates", False))
    best: dict[str, tuple] = {}      # input -> (weight, doc_id, seg, d)
    for seg in ctx.segments:
        dv = seg.ordinal_dv.get(field)
        if dv is None or not dv.ord_terms:
            continue
        # ord -> docs, built once per (immutable) segment+field
        from opensearch_tpu_torch.common.cache import attached_cache
        cache = attached_cache(seg, "_completion_cache",
                               name="suggest.completion",
                               max_weight=16 << 20, breaker="fielddata")
        docs_of = cache.get(field)
        if docs_of is None:
            docs_of = {}
            for d, o in zip(dv.value_docs, dv.ords):
                if o >= 0:
                    docs_of.setdefault(int(o), []).append(int(d))
            cache.put(field, docs_of)
        weights = seg.completion_weights.get(field, {})
        lo = bisect.bisect_left(dv.ord_terms, prefix)
        for o in range(lo, len(dv.ord_terms)):
            text = dv.ord_terms[o]
            if not text.startswith(prefix):
                break
            for d in docs_of.get(o, ()):
                if not seg.live[d]:
                    continue
                w = weights.get((d, text), 1)
                cur = best.get(text)
                if cur is None or w > cur[0]:
                    best[text] = (w, seg.doc_ids[d], seg, d)
    ranked = sorted(best.items(), key=lambda kv: (-kv[1][0], kv[0]))
    seen_docs: set = set()
    options = []
    for text, (w, doc_id, seg, d) in ranked:
        if skip_dup and doc_id in seen_docs:
            continue
        seen_docs.add(doc_id)
        opt = {"text": text, "_id": doc_id, "_score": float(w)}
        src_doc = seg.source(d)
        if src_doc is not None:
            opt["_source"] = src_doc
        options.append(opt)
        if len(options) >= size:
            break
    return [{"text": prefix, "offset": 0, "length": len(prefix),
             "options": options}]


def run_suggest(suggest_json: dict, ctx) -> dict:
    """The search body's ``suggest`` section -> response ``suggest``
    object (SearchService's suggest phase)."""
    s = Suggester(ctx)
    out = {}
    global_text = suggest_json.get("text")
    for name, body in suggest_json.items():
        if name == "text":
            continue
        if not isinstance(body, dict):
            raise ParsingError(f"suggester [{name}] must be an object")
        if "completion" in body:
            prefix = body.get("prefix", body.get("text", global_text))
            if prefix is None:
                raise ParsingError(
                    f"suggester [{name}] requires [prefix]")
            out[name] = completion_suggest(ctx, str(prefix),
                                           body["completion"])
            continue
        text = body.get("text", global_text)
        if text is None:
            raise ParsingError(f"suggester [{name}] requires [text]")
        if "term" in body:
            out[name] = s.term_suggest(text, body["term"])
        elif "phrase" in body:
            out[name] = s.phrase_suggest(text, body["phrase"])
        else:
            raise ParsingError(
                f"suggester [{name}] must be [term], [phrase] or "
                "[completion]")
    return out


def merge_suggest(per_source: list[dict]) -> dict:
    """Coordinator reduce of per-source suggest sections: options merge
    by text (freqs sum, best score wins), re-sorted (the reference's
    Suggest.reduce)."""
    out: dict = {}
    for section in per_source:
        if not section:
            continue
        for name, entries in section.items():
            if name not in out:
                out[name] = [dict(e, options=list(e["options"]))
                             for e in entries]
                continue
            for mine, theirs in zip(out[name], entries):
                by_text = {o["text"]: dict(o) for o in mine["options"]}
                for o in theirs["options"]:
                    cur = by_text.get(o["text"])
                    if cur is None:
                        by_text[o["text"]] = dict(o)
                    else:
                        cur["freq"] = cur.get("freq", 0) + o.get("freq", 0)
                        for sk in ("score", "_score"):
                            if sk in cur or sk in o:
                                cur[sk] = max(cur.get(sk, 0),
                                              o.get(sk, 0))
                # completion options carry "_score" (weights), term/
                # phrase carry "score" — both sort weight/score desc
                merged = sorted(
                    by_text.values(),
                    key=lambda o: (-o.get("score",
                                          o.get("_score", 0)),
                                   -o.get("freq", 0), o["text"]))
                mine["options"] = merged
    return out
