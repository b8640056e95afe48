"""Analysis: tokenizers, token filters, analyzers, per-index registry.

Mirrors the reference's analysis module (core/index/analysis/AnalysisModule.java:39,
~150 providers bridging Lucene analyzers): named tokenizers + filter chains are
registered globally, and each index can define custom analyzers in its settings
(``analysis.analyzer.<name>.{type,tokenizer,filter}``), resolved by
:class:`AnalysisRegistry`.

This runs host-side at both index time (SegmentBuilder) and query time
(match-query analysis); the produced term streams are what get packed into
the device-resident columnar segments.
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass
from typing import Callable, Iterable, Sequence

from elasticsearch_tpu_torch.common.errors import IllegalArgumentError
from elasticsearch_tpu_torch.common.settings import Settings


@dataclass
class Token:
    term: str
    position: int      # token position (phrase queries use this)
    start_offset: int  # char offsets (highlighting uses these)
    end_offset: int


# ---------------------------------------------------------------------------
# Tokenizers
# ---------------------------------------------------------------------------

# Word characters: letters and digits of any script (approximates Lucene's
# StandardTokenizer UAX#29 word-break rules closely enough for parity tests).
# \w includes '_': UAX#29 (Lucene StandardTokenizer) classes underscore as
# ExtendNumLet, which JOINS words — "value1_foo" is ONE token. All-
# underscore matches are dropped below (no word chars → no token).
_STANDARD_RE = re.compile(r"\w+(?:['’]\w+)*", re.UNICODE)
_WHITESPACE_RE = re.compile(r"\S+")
_LETTER_RE = re.compile(r"[^\W\d_]+", re.UNICODE)


def _regex_tokenize(text: str, pattern: re.Pattern) -> list[Token]:
    out = []
    for pos, m in enumerate(pattern.finditer(text)):
        out.append(Token(m.group(0), pos, m.start(), m.end()))
    return out


def standard_tokenizer(text: str) -> list[Token]:
    toks = _regex_tokenize(text, _STANDARD_RE)
    kept = [t for t in toks if t.term.strip("_")]
    # re-number positions after dropping underscore-only matches
    return [Token(t.term, pos, t.start_offset, t.end_offset)
            for pos, t in enumerate(kept)]


def whitespace_tokenizer(text: str) -> list[Token]:
    return _regex_tokenize(text, _WHITESPACE_RE)


def letter_tokenizer(text: str) -> list[Token]:
    return _regex_tokenize(text, _LETTER_RE)


# The JAX package swaps in a native C tokenizer here; this port keeps the
# pure-Python tokenizers above (the C one is still to be ported).


def keyword_tokenizer(text: str) -> list[Token]:
    return [Token(text, 0, 0, len(text))] if text else []


def ngram_tokenizer_factory(min_gram: int = 1, max_gram: int = 2) -> "Tokenizer":
    def tok(text: str) -> list[Token]:
        out = []
        pos = 0
        for n in range(min_gram, max_gram + 1):
            for i in range(0, len(text) - n + 1):
                out.append(Token(text[i:i + n], pos, i, i + n))
                pos += 1
        return out
    return tok


Tokenizer = Callable[[str], list[Token]]

TOKENIZERS: dict[str, Tokenizer] = {
    "standard": standard_tokenizer,
    "whitespace": whitespace_tokenizer,
    "letter": letter_tokenizer,
    "keyword": keyword_tokenizer,
    "classic": standard_tokenizer,
}


# ---------------------------------------------------------------------------
# Token filters
# ---------------------------------------------------------------------------

# Lucene's default English stopword set (StandardAnalyzer.STOP_WORDS_SET).
ENGLISH_STOPWORDS = frozenset(
    "a an and are as at be but by for if in into is it no not of on or such "
    "that the their then there these they this to was will with".split()
)


def lowercase_filter(tokens: Iterable[Token]) -> list[Token]:
    return [Token(t.term.lower(), t.position, t.start_offset, t.end_offset) for t in tokens]


def uppercase_filter(tokens: Iterable[Token]) -> list[Token]:
    return [Token(t.term.upper(), t.position, t.start_offset, t.end_offset) for t in tokens]


def asciifolding_filter(tokens: Iterable[Token]) -> list[Token]:
    def fold(s: str) -> str:
        return "".join(
            c for c in unicodedata.normalize("NFKD", s) if not unicodedata.combining(c)
        )
    return [Token(fold(t.term), t.position, t.start_offset, t.end_offset) for t in tokens]


def stop_filter_factory(stopwords: frozenset[str] = ENGLISH_STOPWORDS) -> "TokenFilter":
    """Removes stopwords; positions are preserved (position gaps matter for
    phrase queries, matching Lucene StopFilter's enablePositionIncrements)."""
    def f(tokens: Iterable[Token]) -> list[Token]:
        return [t for t in tokens if t.term not in stopwords]
    return f


def length_filter_factory(min_len: int = 0, max_len: int = 255) -> "TokenFilter":
    def f(tokens: Iterable[Token]) -> list[Token]:
        return [t for t in tokens if min_len <= len(t.term) <= max_len]
    return f


def unique_filter(tokens: Iterable[Token]) -> list[Token]:
    seen: set[str] = set()
    out = []
    for t in tokens:
        if t.term not in seen:
            seen.add(t.term)
            out.append(t)
    return out


def shingle_filter_factory(min_size: int = 2, max_size: int = 2,
                           separator: str = " ") -> "TokenFilter":
    def f(tokens: Iterable[Token]) -> list[Token]:
        toks = list(tokens)
        out = list(toks)
        for n in range(min_size, max_size + 1):
            for i in range(len(toks) - n + 1):
                grp = toks[i:i + n]
                out.append(Token(separator.join(t.term for t in grp),
                                 grp[0].position, grp[0].start_offset, grp[-1].end_offset))
        out.sort(key=lambda t: (t.position, t.end_offset))
        return out
    return f


# --- Porter stemmer (Porter 1980; equivalent of Lucene PorterStemFilter) ----

_VOWELS = "aeiou"


def _is_cons(word: str, i: int) -> bool:
    c = word[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """Number of VC sequences."""
    m, prev_cons = 0, True
    for i in range(len(stem)):
        cons = _is_cons(stem, i)
        if prev_cons and not cons:
            pass
        elif not prev_cons and cons:
            m += 1
        prev_cons = cons
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(word: str) -> bool:
    return (len(word) >= 2 and word[-1] == word[-2] and _is_cons(word, len(word) - 1))


def _cvc(word: str) -> bool:
    if len(word) < 3:
        return False
    return (_is_cons(word, len(word) - 3) and not _is_cons(word, len(word) - 2)
            and _is_cons(word, len(word) - 1) and word[-1] not in "wxy")


def porter_stem(word: str) -> str:  # noqa: C901 — the algorithm is one long rule table
    if len(word) <= 2:
        return word
    w = word
    # Step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]
    # Step 1b
    flag = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed"):
        if _has_vowel(w[:-2]):
            w, flag = w[:-2], True
    elif w.endswith("ing"):
        if _has_vowel(w[:-3]):
            w, flag = w[:-3], True
    if flag:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _ends_double_cons(w) and not w.endswith(("l", "s", "z")):
            w = w[:-1]
        elif _measure(w) == 1 and _cvc(w):
            w += "e"
    # Step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # Step 2
    step2 = [("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
             ("izer", "ize"), ("bli", "ble"), ("alli", "al"), ("entli", "ent"),
             ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
             ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
             ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
             ("logi", "log")]
    for suf, rep in step2:
        if w.endswith(suf):
            if _measure(w[:-len(suf)]) > 0:
                w = w[:-len(suf)] + rep
            break
    # Step 3
    step3 = [("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
             ("ical", "ic"), ("ful", ""), ("ness", "")]
    for suf, rep in step3:
        if w.endswith(suf):
            if _measure(w[:-len(suf)]) > 0:
                w = w[:-len(suf)] + rep
            break
    # Step 4
    step4 = ["al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
             "ment", "ent", "ion", "ou", "ism", "ate", "iti", "ous", "ive", "ize"]
    for suf in step4:
        if w.endswith(suf):
            stem = w[:-len(suf)]
            if _measure(stem) > 1:
                if suf == "ion" and not stem.endswith(("s", "t")):
                    break
                w = stem
            break
    # Step 5a
    if w.endswith("e"):
        stem = w[:-1]
        if _measure(stem) > 1 or (_measure(stem) == 1 and not _cvc(stem)):
            w = stem
    # Step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


def porter_stem_filter(tokens: Iterable[Token]) -> list[Token]:
    return [Token(porter_stem(t.term), t.position, t.start_offset, t.end_offset)
            for t in tokens]


TokenFilter = Callable[[Iterable[Token]], list[Token]]

def trim_filter(tokens: Iterable[Token]) -> list[Token]:
    return [Token(t.term.strip(), t.position, t.start_offset,
                  t.end_offset) for t in tokens]


def reverse_filter(tokens: Iterable[Token]) -> list[Token]:
    return [Token(t.term[::-1], t.position, t.start_offset, t.end_offset)
            for t in tokens]


def truncate_filter_factory(length: int = 10) -> "TokenFilter":
    def f(tokens: Iterable[Token]) -> list[Token]:
        return [Token(t.term[:length], t.position, t.start_offset,
                      t.end_offset) for t in tokens]
    return f


def limit_filter_factory(max_token_count: int = 1) -> "TokenFilter":
    def f(tokens: Iterable[Token]) -> list[Token]:
        return list(tokens)[:max_token_count]
    return f


def decimal_digit_filter(tokens: Iterable[Token]) -> list[Token]:
    """Unicode decimal digits → ASCII 0-9 (DecimalDigitFilter)."""
    import unicodedata

    def fold(s: str) -> str:
        return "".join(str(unicodedata.decimal(c)) if
                       unicodedata.category(c) == "Nd" else c for c in s)
    return [Token(fold(t.term), t.position, t.start_offset, t.end_offset)
            for t in tokens]


def cjk_width_filter(tokens: Iterable[Token]) -> list[Token]:
    """Full-width ASCII / half-width katakana normalization
    (CJKWidthFilter ≈ NFKC on those ranges)."""
    import unicodedata
    return [Token(unicodedata.normalize("NFKC", t.term), t.position,
                  t.start_offset, t.end_offset) for t in tokens]


_ELISION_ARTICLES = frozenset(
    "l m t qu n s j d c jusqu quoiqu lorsqu puisqu".split())


def elision_filter_factory(articles=None) -> "TokenFilter":
    arts = frozenset(a.lower() for a in articles) if articles \
        else _ELISION_ARTICLES

    def f(tokens: Iterable[Token]) -> list[Token]:
        out = []
        for t in tokens:
            term = t.term
            for sep in ("'", "’"):
                head, s, tail = term.partition(sep)
                if s and head.lower() in arts:
                    term = tail
                    break
            out.append(Token(term, t.position, t.start_offset,
                             t.end_offset))
        return out
    return f


def apostrophe_filter(tokens: Iterable[Token]) -> list[Token]:
    """Strip everything after an apostrophe (ApostropheFilter)."""
    return [Token(t.term.partition("'")[0] or t.term, t.position,
                  t.start_offset, t.end_offset) for t in tokens]


def keep_filter_factory(keep_words) -> "TokenFilter":
    kept = frozenset(keep_words)

    def f(tokens: Iterable[Token]) -> list[Token]:
        return [t for t in tokens if t.term in kept]
    return f


def edge_ngram_filter_factory(min_gram: int = 1,
                              max_gram: int = 2) -> "TokenFilter":
    def f(tokens: Iterable[Token]) -> list[Token]:
        out = []
        for t in tokens:
            for n in range(min_gram, min(max_gram, len(t.term)) + 1):
                out.append(Token(t.term[:n], t.position, t.start_offset,
                                 t.end_offset))
        return out
    return f


def ngram_filter_factory(min_gram: int = 1,
                         max_gram: int = 2) -> "TokenFilter":
    def f(tokens: Iterable[Token]) -> list[Token]:
        out = []
        for t in tokens:
            for n in range(min_gram, max_gram + 1):
                for i in range(0, len(t.term) - n + 1):
                    out.append(Token(t.term[i:i + n], t.position,
                                     t.start_offset, t.end_offset))
        return out
    return f


def pattern_replace_filter_factory(pattern: str,
                                   replacement: str = "") -> "TokenFilter":
    rx = re.compile(pattern)

    def f(tokens: Iterable[Token]) -> list[Token]:
        return [Token(rx.sub(replacement, t.term), t.position,
                      t.start_offset, t.end_offset) for t in tokens]
    return f


def synonym_filter_factory(synonyms: list) -> "TokenFilter":
    """Inline synonym list (SynonymTokenFilterFactory), Solr format:
    'a, b => c' maps a and b to c; 'a, b, c' makes the group equivalent
    (every member expands to all members, same position)."""
    expand: dict[str, list[str]] = {}
    for rule in synonyms or []:
        if "=>" in rule:
            lhs, rhs = rule.split("=>", 1)
            targets = [w.strip() for w in rhs.split(",") if w.strip()]
            for src in (w.strip() for w in lhs.split(",")):
                if src:
                    expand[src] = targets
        else:
            group = [w.strip() for w in rule.split(",") if w.strip()]
            for src in group:
                expand[src] = group

    def f(tokens: Iterable[Token]) -> list[Token]:
        # multi-word targets expand to consecutive positions and shift
        # everything after them (a flattened SynonymGraph: "ny => new
        # york" keeps "new york" phrase-matchable)
        out = []
        shift = 0
        for t in tokens:
            base = t.position + shift
            terms = expand.get(t.term)
            if terms is None:
                out.append(Token(t.term, base, t.start_offset,
                                 t.end_offset))
                continue
            width = 1
            seen = set()
            for term in terms:
                if term in seen:
                    continue
                seen.add(term)
                words = term.split()
                for wi, w in enumerate(words):
                    out.append(Token(w, base + wi, t.start_offset,
                                     t.end_offset))
                width = max(width, len(words))
            shift += width - 1
        return out
    return f


_WORD_DELIM_SPLIT = re.compile(
    r"[A-Z]?[a-z]+|[A-Z]+(?![a-z])|\d+")


def word_delimiter_filter_factory(params: dict) -> "TokenFilter":
    """WordDelimiterTokenFilterFactory core behavior: split on case
    transitions / letter-digit boundaries / intra-word punctuation;
    optionally keep the original token."""
    preserve = str(params.get("preserve_original",
                              "false")).lower() in ("true", "1")

    def f(tokens: Iterable[Token]) -> list[Token]:
        out = []
        for t in tokens:
            parts = _WORD_DELIM_SPLIT.findall(t.term)
            if len(parts) <= 1:
                # no split: one token, whether or not preserving (Lucene
                # emits the original exactly once here)
                out.append(Token(parts[0] if parts else t.term,
                                 t.position, t.start_offset,
                                 t.end_offset))
                continue
            if preserve:
                out.append(t)
            for p in parts:
                out.append(Token(p, t.position, t.start_offset,
                                 t.end_offset))
        return out
    return f


def edge_ngram_tokenizer_factory(min_gram: int = 1,
                                 max_gram: int = 2) -> "Tokenizer":
    def tok(text: str) -> list[Token]:
        out = []
        for n in range(min_gram, min(max_gram, len(text)) + 1):
            out.append(Token(text[:n], 0, 0, n))
        return out
    return tok


def pattern_tokenizer_factory(pattern: str = r"\W+",
                              group: int = -1) -> "Tokenizer":
    rx = re.compile(pattern)

    def tok(text: str) -> list[Token]:
        out = []
        if group >= 0:
            for pos, m in enumerate(rx.finditer(text)):
                out.append(Token(m.group(group), pos, m.start(), m.end()))
            return out
        pos = 0
        idx = 0
        for part in rx.split(text):
            if part:
                start = text.index(part, idx)
                out.append(Token(part, pos, start, start + len(part)))
                pos += 1
                idx = start + len(part)
        return out
    return tok


def path_hierarchy_tokenizer_factory(delimiter: str = "/") -> "Tokenizer":
    def tok(text: str) -> list[Token]:
        out = []
        parts = text.split(delimiter)
        acc = ""
        for i, part in enumerate(parts):
            acc = part if i == 0 else acc + delimiter + part
            if acc:
                out.append(Token(acc, 0, 0, len(acc)))
        return out
    return tok


_URL_EMAIL = re.compile(
    r"https?://[^\s]+|[\w.+-]+@[\w-]+\.[\w.-]+|\w+")


def uax_url_email_tokenizer(text: str) -> list[Token]:
    # no case folding here — that is the lowercase filter's job, like
    # Lucene's UAX29URLEmailTokenizer
    return [Token(m.group(0), pos, m.start(), m.end())
            for pos, m in enumerate(_URL_EMAIL.finditer(text))]


TOKEN_FILTERS: dict[str, TokenFilter] = {
    "lowercase": lowercase_filter,
    "uppercase": uppercase_filter,
    "asciifolding": asciifolding_filter,
    "stop": stop_filter_factory(),
    "porter_stem": porter_stem_filter,
    "stemmer": porter_stem_filter,
    "kstem": porter_stem_filter,
    "snowball": porter_stem_filter,
    "unique": unique_filter,
    "shingle": shingle_filter_factory(),
    "length": length_filter_factory(),
    "trim": trim_filter,
    "reverse": reverse_filter,
    "truncate": truncate_filter_factory(),
    "decimal_digit": decimal_digit_filter,
    "cjk_width": cjk_width_filter,
    "elision": elision_filter_factory(),
    "apostrophe": apostrophe_filter,
    "edge_ngram": edge_ngram_filter_factory(),
    "edgeNGram": edge_ngram_filter_factory(),
    "ngram": ngram_filter_factory(),
    "nGram": ngram_filter_factory(),
    "word_delimiter": word_delimiter_filter_factory({}),
}

# tokenizers defined below the static table register here
TOKENIZERS["uax_url_email"] = uax_url_email_tokenizer
TOKENIZERS["edge_ngram"] = edge_ngram_tokenizer_factory()
TOKENIZERS["path_hierarchy"] = path_hierarchy_tokenizer_factory()
TOKENIZERS["pattern"] = pattern_tokenizer_factory()

# Parameterized component factories, used for custom definitions in index
# settings (``analysis.tokenizer.<name>.type`` / ``analysis.filter.<name>.type``).
TOKENIZER_FACTORIES: dict[str, Callable[..., Tokenizer]] = {
    "ngram": lambda params: ngram_tokenizer_factory(
        int(params.get("min_gram", 1)), int(params.get("max_gram", 2))),
    "edge_ngram": lambda params: edge_ngram_tokenizer_factory(
        int(params.get("min_gram", 1)), int(params.get("max_gram", 2))),
    "pattern": lambda params: pattern_tokenizer_factory(
        str(params.get("pattern", r"\W+")), int(params.get("group", -1))),
    "path_hierarchy": lambda params: path_hierarchy_tokenizer_factory(
        str(params.get("delimiter", "/"))),
}

TOKEN_FILTER_FACTORIES: dict[str, Callable[..., TokenFilter]] = {
    "stop": lambda params: stop_filter_factory(
        frozenset(params["stopwords"]) if isinstance(params.get("stopwords"), list)
        else ENGLISH_STOPWORDS),
    "length": lambda params: length_filter_factory(
        int(params.get("min", 0)), int(params.get("max", 255))),
    "shingle": lambda params: shingle_filter_factory(
        int(params.get("min_shingle_size", 2)),
        int(params.get("max_shingle_size", 2)),
        params.get("token_separator", " ")),
    "truncate": lambda params: truncate_filter_factory(
        int(params.get("length", 10))),
    "limit": lambda params: limit_filter_factory(
        int(params.get("max_token_count", 1))),
    "elision": lambda params: elision_filter_factory(
        params.get("articles")),
    "keep": lambda params: keep_filter_factory(
        params.get("keep_words", [])),
    "edge_ngram": lambda params: edge_ngram_filter_factory(
        int(params.get("min_gram", 1)), int(params.get("max_gram", 2))),
    "ngram": lambda params: ngram_filter_factory(
        int(params.get("min_gram", 1)), int(params.get("max_gram", 2))),
    "pattern_replace": lambda params: pattern_replace_filter_factory(
        str(params.get("pattern", "")),
        str(params.get("replacement", ""))),
    "synonym": lambda params: synonym_filter_factory(
        params.get("synonyms", [])),
    "word_delimiter": word_delimiter_filter_factory,
}


# ---------------------------------------------------------------------------
# Analyzers
# ---------------------------------------------------------------------------

class Analyzer:
    def __init__(self, name: str, tokenizer: Tokenizer,
                 filters: Sequence[TokenFilter] = ()):
        self.name = name
        self.tokenizer = tokenizer
        self.filters = list(filters)

    def analyze(self, text: str) -> list[Token]:
        tokens: list[Token] = self.tokenizer(text)
        for f in self.filters:
            tokens = f(tokens)
        return tokens

    def terms(self, text: str) -> list[str]:
        return [t.term for t in self.analyze(text)]


BUILTIN_ANALYZERS: dict[str, Analyzer] = {
    # StandardAnalyzer in ES 2.x default has NO stopwords (stopwords=_none_).
    "standard": Analyzer("standard", standard_tokenizer, [lowercase_filter]),
    "simple": Analyzer("simple", letter_tokenizer, [lowercase_filter]),
    "whitespace": Analyzer("whitespace", whitespace_tokenizer),
    "keyword": Analyzer("keyword", keyword_tokenizer),
    "stop": Analyzer("stop", letter_tokenizer,
                     [lowercase_filter, stop_filter_factory()]),
    "english": Analyzer("english", standard_tokenizer,
                        [lowercase_filter, stop_filter_factory(), porter_stem_filter]),
    # SnowballAnalyzer (deprecated in Lucene 5 but still registered in ES
    # 2.x): standard tokenizer, lowercase, stop, snowball stemmer — the
    # Porter stemmer is the English snowball variant here
    "snowball": Analyzer("snowball", standard_tokenizer,
                         [lowercase_filter, stop_filter_factory(),
                          porter_stem_filter]),
}
# "default" names the index's default analyzer — standard unless the index
# overrides it (AnalysisRegistry resolves overrides; this is the fallback)
BUILTIN_ANALYZERS["default"] = BUILTIN_ANALYZERS["standard"]


class AnalysisRegistry:
    """Per-index analyzer resolution: builtins + custom chains from index
    settings (``analysis.analyzer.<name>...``), mirroring AnalysisModule."""

    def __init__(self, index_settings: Settings = Settings.EMPTY):
        self.analyzers: dict[str, Analyzer] = dict(BUILTIN_ANALYZERS)
        self.tokenizers: dict[str, Tokenizer] = dict(TOKENIZERS)
        self.tokenizers["ngram"] = ngram_tokenizer_factory()
        self.filters: dict[str, TokenFilter] = dict(TOKEN_FILTERS)
        # stored index settings carry the "index." prefix (IndexMetaData
        # normalization); analysis components must resolve either form
        index_settings = Settings(
            {(k[len("index."):] if k.startswith("index.") else k): v
             for k, v in dict(index_settings).items()})
        self._build_components(index_settings)
        self._build_custom(index_settings)

    def _component_names(self, settings: Settings, prefix: str) -> set[str]:
        return {key.split(".")[2] for key in settings if key.startswith(prefix)}

    def _build_components(self, settings: Settings) -> None:
        """Custom tokenizer/filter definitions with parameters."""
        for name in sorted(self._component_names(settings, "analysis.tokenizer.")):
            sub = settings.get_by_prefix(f"analysis.tokenizer.{name}.")
            ttype = sub.get("type")
            if ttype in TOKENIZER_FACTORIES:
                self.tokenizers[name] = TOKENIZER_FACTORIES[ttype](sub.as_dict())
            elif ttype in TOKENIZERS:
                self.tokenizers[name] = TOKENIZERS[ttype]
            else:
                raise IllegalArgumentError(f"unknown tokenizer type [{ttype}]")
        for name in sorted(self._component_names(settings, "analysis.filter.")):
            sub = settings.get_by_prefix(f"analysis.filter.{name}.")
            ftype = sub.get("type")
            if ftype in TOKEN_FILTER_FACTORIES:
                self.filters[name] = TOKEN_FILTER_FACTORIES[ftype](sub.as_dict())
            elif ftype in TOKEN_FILTERS:
                self.filters[name] = TOKEN_FILTERS[ftype]
            else:
                raise IllegalArgumentError(f"unknown filter type [{ftype}]")

    def _build_custom(self, settings: Settings) -> None:
        names = self._component_names(settings, "analysis.analyzer.")
        for name in sorted(names):
            sub = settings.get_by_prefix(f"analysis.analyzer.{name}.")
            atype = sub.get("type", "custom")
            if atype != "custom" and atype in BUILTIN_ANALYZERS:
                self.analyzers[name] = BUILTIN_ANALYZERS[atype]
                continue
            tok_name = sub.get("tokenizer", "standard")
            if tok_name not in self.tokenizers:
                raise IllegalArgumentError(f"unknown tokenizer [{tok_name}] for analyzer [{name}]")
            filters = []
            raw_filters = sub.get("filter", [])
            if isinstance(raw_filters, str):
                raw_filters = [f.strip() for f in raw_filters.split(",") if f.strip()]
            for fname in raw_filters:
                if fname not in self.filters:
                    # bare factory names act as pre-configured filters
                    # with default params (how the reference exposes
                    # plugin filters like kuromoji_baseform directly)
                    if fname in TOKEN_FILTER_FACTORIES:
                        self.filters[fname] = \
                            TOKEN_FILTER_FACTORIES[fname]({})
                    else:
                        raise IllegalArgumentError(
                            f"unknown filter [{fname}] for analyzer "
                            f"[{name}]")
                filters.append(self.filters[fname])
            self.analyzers[name] = Analyzer(name, self.tokenizers[tok_name], filters)

    def get(self, name: str) -> Analyzer:
        try:
            return self.analyzers[name]
        except KeyError:
            raise IllegalArgumentError(f"unknown analyzer [{name}]") from None
