"""Fulltext match evaluation for `matches(column, query)` (a copy of the
JAX package's query/fulltext.py).

Query grammar per upstream GreptimeDB's matches function (src/common/function/
src/scalars/matches.rs, backed by tantivy query syntax): terms are ANDed
with AND / OR / NOT (also +term / -term), "quoted phrases" match as
substrings, parentheses group. Matching is case-insensitive on
word-tokenized text.

`eval_matches` evaluates the parsed query once over the whole column
where the JAX package evaluates it once a row: the lowered values are
joined by a separator that no phrase of the query holds, each term and
phrase is found by one regex pass over the joined text, and its hits map
back to rows by their offsets (`_Corpus`). A term is a whole word (a
maximal run of [a-z0-9_]) and a phrase a substring, so the answer is the
per-row evaluation's: no hit can span two rows, since it would hold the
separator.
"""

from __future__ import annotations

import re

import numpy as np

from greptimedb_tpu_torch.errors import InvalidArgumentError

# parens tokenize on their own even when glued to a word: "net)" must
# yield ["net", ")"], not one token
_TOKEN_RE = re.compile(r'"[^"]*"|\(|\)|[^\s()"]+')
_WORD_RE = re.compile(r"[a-z0-9_]+")


class _Corpus:
    """A column's lowered values joined by `sep`, with each row's start:
    a pattern is searched once over the whole text and its hits mapped
    back to their rows. A value may hold `sep`: rows are told apart by
    their offsets, not by splitting."""

    def __init__(self, texts: list[str], sep: str):
        self.n = len(texts)
        self.text = sep.join(texts)
        lens = np.fromiter(map(len, texts), np.int64, self.n)
        self.starts = np.zeros(self.n, np.int64)
        np.cumsum(lens[:-1] + 1, out=self.starts[1:])

    def rows(self, pattern: str) -> np.ndarray:
        """Rows holding a match of `pattern`, which must not match the
        separator."""
        hit = np.zeros(self.n, dtype=bool)
        pos = np.fromiter((m.start() for m in re.finditer(pattern,
                                                          self.text)),
                          np.int64)
        hit[np.searchsorted(self.starts, pos, side="right") - 1] = True
        return hit


class _Node:
    def mask(self, corpus: _Corpus) -> np.ndarray:
        """The rows of `corpus` that match."""
        raise NotImplementedError


class _Term(_Node):
    def __init__(self, term: str):
        self.term = term.lower()

    def mask(self, corpus):
        # a word is a maximal run of [a-z0-9_] of the lowered text (which
        # lowering again leaves as it is): the term between non-word
        # characters, the one before it asserted after the term so that
        # the search starts from the term's letters; a term that is no
        # word is in no row's words
        t = self.term
        if not _WORD_RE.fullmatch(t):
            return np.zeros(corpus.n, dtype=bool)
        return corpus.rows(rf"{t}(?![a-z0-9_])(?<![a-z0-9_]{t})")


class _Phrase(_Node):
    def __init__(self, phrase: str):
        self.phrase = phrase.lower()

    def mask(self, corpus):
        if not self.phrase:
            return np.ones(corpus.n, dtype=bool)
        return corpus.rows(re.escape(self.phrase))


class _Not(_Node):
    def __init__(self, inner: _Node):
        self.inner = inner

    def mask(self, corpus):
        return ~self.inner.mask(corpus)


class _Bin(_Node):
    def __init__(self, op: str, nodes: list[_Node]):
        self.op = op
        self.nodes = nodes

    def mask(self, corpus):
        masks = [n.mask(corpus) for n in self.nodes]
        if self.op == "and":
            return np.logical_and.reduce(masks)
        return np.logical_or.reduce(masks)


def _parse_query(query: str) -> _Node:
    tokens = _TOKEN_RE.findall(query)
    pos = 0

    def parse_or():
        nonlocal pos
        nodes = [parse_and()]
        while pos < len(tokens) and tokens[pos].upper() == "OR":
            pos += 1
            nodes.append(parse_and())
        return nodes[0] if len(nodes) == 1 else _Bin("or", nodes)

    def parse_and():
        nonlocal pos
        nodes = [parse_unary()]
        while pos < len(tokens):
            t = tokens[pos]
            if t.upper() == "AND":
                pos += 1
                nodes.append(parse_unary())
            elif t.upper() == "OR" or t == ")":
                break
            else:
                nodes.append(parse_unary())  # implicit AND
        return nodes[0] if len(nodes) == 1 else _Bin("and", nodes)

    def parse_unary():
        nonlocal pos
        if pos >= len(tokens):
            raise InvalidArgumentError(f"bad matches() query: {query!r}")
        t = tokens[pos]
        if t.upper() == "NOT" or t == "-" or t.startswith("-"):
            if t.upper() == "NOT" or t == "-":
                pos += 1
                return _Not(parse_unary())
            pos += 1
            return _Not(_make_leaf(t[1:]))
        if t == "(":
            pos += 1
            node = parse_or()
            if pos >= len(tokens) or tokens[pos] != ")":
                raise InvalidArgumentError(f"unbalanced parens: {query!r}")
            pos += 1
            return node
        pos += 1
        if t.startswith("+"):
            t = t[1:]
        return _make_leaf(t)

    def _make_leaf(t: str) -> _Node:
        if t.startswith('"') and t.endswith('"'):
            return _Phrase(t[1:-1])
        return _Term(t)

    node = parse_or()
    if pos != len(tokens):
        raise InvalidArgumentError(f"trailing tokens in query: {query!r}")
    return node


def eval_matches_term(values: np.ndarray, term: str) -> np.ndarray:
    """Literal term match with non-alphanumeric boundaries (upstream's
    matches_term): the term itself is never parsed as a query."""
    rx = re.compile(
        r"(?<![a-zA-Z0-9_])" + re.escape(term) + r"(?![a-zA-Z0-9_])"
    )
    return np.asarray(
        [bool(rx.search(str(v))) for v in values], dtype=bool
    )


def eval_matches(values: np.ndarray, query: str) -> np.ndarray:
    node = _parse_query(query)
    # the separator: the first non-word character that no phrase holds
    phrases = "".join(_phrases(node))
    sep = next(c for c in map(chr, range(0x110000))
               if not _WORD_RE.fullmatch(c) and c not in phrases)
    return node.mask(_Corpus([str(v).lower() for v in values], sep))


def _phrases(node: _Node) -> list[str]:
    if isinstance(node, _Phrase):
        return [node.phrase]
    if isinstance(node, _Not):
        return _phrases(node.inner)
    if isinstance(node, _Bin):
        return [p for n in node.nodes for p in _phrases(n)]
    return []


def required_terms(query: str) -> frozenset[str]:
    """Terms that MUST appear for the query to match — the index-pruning
    contract: a row group whose term index lacks any of these cannot
    contain a matching row. AND unions children; OR intersects (only a
    term needed on every branch is required); NOT requires nothing."""
    try:
        node = _parse_query(query)
    except InvalidArgumentError:
        return frozenset()
    return frozenset(_required(node))


def _required(node: _Node) -> set[str]:
    if isinstance(node, _Term):
        return {node.term} if _WORD_RE.fullmatch(node.term) else set()
    if isinstance(node, _Phrase):
        # phrase matching is a raw SUBSTRING test, so the phrase's edge
        # words may match mid-token ('"network err"' matches
        # "network error"); only INTERIOR words — bounded by non-word
        # chars inside the phrase itself — are guaranteed whole tokens
        p = node.phrase
        return {
            m.group(0) for m in _WORD_RE.finditer(p)
            if m.start() > 0 and m.end() < len(p)
        }
    if isinstance(node, _Bin):
        parts = [_required(n) for n in node.nodes]
        if node.op == "and":
            return set().union(*parts)
        out = parts[0]
        for p in parts[1:]:
            out &= p
        return out
    return set()
