"""Analysis chain: char filters -> tokenizer -> token filters -> tokens.

Analog of the reference's AnalysisRegistry / AnalysisModule
(index/analysis/AnalysisRegistry.java, indices/analysis/AnalysisModule.java)
with the built-in analyzers from core + modules/analysis-common that matter
for the BASELINE workloads: standard, simple, whitespace, keyword, stop,
english.  Custom analyzers compose named tokenizers/filters from mapping
settings, the same way ``analysis.analyzer.my.type: custom`` does.

Tokens carry positions (for phrase queries) and offsets (for highlighting).
Analysis is pure host-side string work — it never touches the device.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

from opensearch_tpu_torch.analysis import porter
from opensearch_tpu_torch.common.errors import IllegalArgumentError


@dataclass
class Token:
    term: str
    position: int
    start_offset: int
    end_offset: int


# Unicode-ish word tokenization: runs of word chars incl. digits; keeps
# interior apostrophes out (standard tokenizer splits possessives anyway via
# english filters; close enough to UAX#29 for the conformance bar we target).
_STANDARD_RE = re.compile(r"[\w][\w]*", re.UNICODE)
_LETTER_RE = re.compile(r"[^\W\d_]+", re.UNICODE)
_WHITESPACE_RE = re.compile(r"\S+")

# Lucene EnglishAnalyzer.ENGLISH_STOP_WORDS_SET
ENGLISH_STOP_WORDS = frozenset(
    "a an and are as at be but by for if in into is it no not of on or such"
    " that the their then there these they this to was will with".split()
)


def _regex_tokenizer(pattern: re.Pattern) -> Callable[[str], list[Token]]:
    def tokenize(text: str) -> list[Token]:
        return [
            Token(m.group(), pos, m.start(), m.end())
            for pos, m in enumerate(pattern.finditer(text))
        ]

    return tokenize


def _keyword_tokenizer(text: str) -> list[Token]:
    return [Token(text, 0, 0, len(text))] if text else []


def _ngram_tokenizer(min_gram: int, max_gram: int, edge: bool = False) -> Callable[[str], list[Token]]:
    def tokenize(text: str) -> list[Token]:
        out = []
        pos = 0
        for n in range(min_gram, max_gram + 1):
            if n > len(text):
                break
            upper = 1 if edge else len(text) - n + 1
            for i in range(0, max(0, upper)):
                out.append(Token(text[i : i + n], pos, i, i + n))
                pos += 1
        return out

    return tokenize


def _pattern_split_tokenizer(pattern: str) -> Callable[[str], list[Token]]:
    """OpenSearch ``pattern`` tokenizer: the pattern is the *separator*."""
    sep = re.compile(pattern)

    def tokenize(text: str) -> list[Token]:
        out = []
        pos = 0
        last = 0
        for m in sep.finditer(text):
            if m.start() > last:
                out.append(Token(text[last : m.start()], pos, last, m.start()))
                pos += 1
            last = m.end()
        if last < len(text):
            out.append(Token(text[last:], pos, last, len(text)))
        return out

    return tokenize


def _build_tokenizer(name: str, tcfg: dict) -> Callable[[str], list[Token]]:
    ttype = tcfg.get("type", name)
    if ttype in ("ngram", "nGram", "edge_ngram", "edgeNGram"):
        return _ngram_tokenizer(
            int(tcfg.get("min_gram", 1)),
            int(tcfg.get("max_gram", 2)),
            edge=ttype in ("edge_ngram", "edgeNGram"),
        )
    if ttype == "pattern":
        return _pattern_split_tokenizer(tcfg.get("pattern", r"\W+"))
    if ttype in TOKENIZERS:
        return TOKENIZERS[ttype]
    raise IllegalArgumentError(f"unknown tokenizer type [{ttype}]")


TOKENIZERS: dict[str, Callable] = {
    "standard": _regex_tokenizer(_STANDARD_RE),
    "letter": _regex_tokenizer(_LETTER_RE),
    "whitespace": _regex_tokenizer(_WHITESPACE_RE),
    "keyword": _keyword_tokenizer,
}


# --- token filters ---------------------------------------------------------


def lowercase_filter(tokens: Iterable[Token]) -> list[Token]:
    return [Token(t.term.lower(), t.position, t.start_offset, t.end_offset) for t in tokens]


def stop_filter(stopwords=ENGLISH_STOP_WORDS):
    def apply(tokens: Iterable[Token]) -> list[Token]:
        # Positions are preserved (gaps where stopwords were), matching
        # Lucene's StopFilter with enablePositionIncrements.
        return [t for t in tokens if t.term not in stopwords]

    return apply


def porter_stem_filter(tokens: Iterable[Token]) -> list[Token]:
    return [Token(porter.stem(t.term), t.position, t.start_offset, t.end_offset) for t in tokens]


def possessive_english_filter(tokens: Iterable[Token]) -> list[Token]:
    out = []
    for t in tokens:
        term = t.term
        if term.endswith("'s") or term.endswith("’s"):
            term = term[:-2]
        out.append(Token(term, t.position, t.start_offset, t.end_offset))
    return out


def asciifolding_filter(tokens: Iterable[Token]) -> list[Token]:
    import unicodedata

    out = []
    for t in tokens:
        folded = unicodedata.normalize("NFKD", t.term).encode("ascii", "ignore").decode()
        out.append(Token(folded or t.term, t.position, t.start_offset, t.end_offset))
    return out


def _length_filter(min_len: int, max_len: int):
    def apply(tokens):
        return [t for t in tokens if min_len <= len(t.term) <= max_len]

    return apply


def _shingle_filter(min_size: int = 2, max_size: int = 2, sep: str = " "):
    def apply(tokens: list[Token]) -> list[Token]:
        out = list(tokens)
        for size in range(min_size, max_size + 1):
            for i in range(0, len(tokens) - size + 1):
                window = tokens[i : i + size]
                out.append(
                    Token(
                        sep.join(t.term for t in window),
                        window[0].position,
                        window[0].start_offset,
                        window[-1].end_offset,
                    )
                )
        return out

    return apply


TOKEN_FILTERS: dict[str, Callable] = {
    "lowercase": lambda cfg: lowercase_filter,
    "stop": lambda cfg: stop_filter(frozenset(cfg.get("stopwords", ENGLISH_STOP_WORDS))),
    "porter_stem": lambda cfg: porter_stem_filter,
    "stemmer": lambda cfg: porter_stem_filter,
    "asciifolding": lambda cfg: asciifolding_filter,
    "possessive_english": lambda cfg: possessive_english_filter,
    "length": lambda cfg: _length_filter(int(cfg.get("min", 0)), int(cfg.get("max", 1 << 30))),
    "shingle": lambda cfg: _shingle_filter(
        int(cfg.get("min_shingle_size", 2)), int(cfg.get("max_shingle_size", 2))
    ),
}

# --- char filters ----------------------------------------------------------

CHAR_FILTERS: dict[str, Callable] = {
    "html_strip": lambda cfg: (lambda text: re.sub(r"<[^>]*>", " ", text)),
}


class Analyzer:
    def __init__(self, name: str, tokenizer: Callable, filters: list[Callable], char_filters=()):
        self.name = name
        self.tokenizer = tokenizer
        self.filters = list(filters)
        self.char_filters = list(char_filters)

    def analyze(self, text: str) -> list[Token]:
        for cf in self.char_filters:
            text = cf(text)
        tokens = self.tokenizer(text)
        for f in self.filters:
            tokens = f(tokens)
        return tokens

    def terms(self, text: str) -> list[str]:
        return [t.term for t in self.analyze(text)]


def _builtin_analyzers() -> dict[str, Analyzer]:
    std = TOKENIZERS["standard"]
    return {
        "standard": Analyzer("standard", std, [lowercase_filter]),
        "simple": Analyzer("simple", TOKENIZERS["letter"], [lowercase_filter]),
        "whitespace": Analyzer("whitespace", TOKENIZERS["whitespace"], []),
        "keyword": Analyzer("keyword", _keyword_tokenizer, []),
        "stop": Analyzer("stop", TOKENIZERS["letter"], [lowercase_filter, stop_filter()]),
        "english": Analyzer(
            "english",
            std,
            [possessive_english_filter, lowercase_filter, stop_filter(), porter_stem_filter],
        ),
    }


class AnalysisRegistry:
    """Per-index registry resolving analyzer names, incl. custom analyzers
    declared under ``settings.analysis`` (AnalysisRegistry.java analog)."""

    def __init__(self, analysis_settings: Optional[dict] = None):
        self._analyzers = _builtin_analyzers()
        cfg = analysis_settings or {}
        custom_tokenizers: dict[str, Callable] = {}
        for name, tcfg in (cfg.get("tokenizer") or {}).items():
            custom_tokenizers[name] = _build_tokenizer(name, tcfg)
        custom_filters: dict[str, Callable] = {}
        for name, fcfg in (cfg.get("filter") or {}).items():
            ftype = fcfg.get("type", name)
            factory = TOKEN_FILTERS.get(ftype)
            if factory is None:
                raise IllegalArgumentError(f"unknown token filter type [{ftype}]")
            custom_filters[name] = factory(fcfg)
        for name, acfg in (cfg.get("analyzer") or {}).items():
            atype = acfg.get("type", "custom")
            if atype != "custom":
                if atype in self._analyzers:
                    self._analyzers[name] = self._analyzers[atype]
                    continue
                raise IllegalArgumentError(f"unknown analyzer type [{atype}]")
            tok_name = acfg.get("tokenizer", "standard")
            tokenizer = custom_tokenizers.get(tok_name) or TOKENIZERS.get(tok_name)
            if tokenizer is None:
                # built-in parameterized tokenizer named directly on the
                # analyzer (ngram/edge_ngram/pattern), params inline
                tokenizer = _build_tokenizer(tok_name, {**acfg, "type": tok_name})
            filters = []
            for fname in acfg.get("filter", []):
                if fname in custom_filters:
                    filters.append(custom_filters[fname])
                elif fname in TOKEN_FILTERS:
                    filters.append(TOKEN_FILTERS[fname]({}))
                else:
                    raise IllegalArgumentError(f"unknown token filter [{fname}]")
            char_filters = []
            for cname in acfg.get("char_filter", []):
                if cname in CHAR_FILTERS:
                    char_filters.append(CHAR_FILTERS[cname]({}))
                else:
                    raise IllegalArgumentError(f"unknown char filter [{cname}]")
            self._analyzers[name] = Analyzer(name, tokenizer, filters, char_filters)

    def get(self, name: str) -> Analyzer:
        analyzer = self._analyzers.get(name)
        if analyzer is None:
            raise IllegalArgumentError(f"analyzer [{name}] not found")
        return analyzer

    def names(self):
        return sorted(self._analyzers)
