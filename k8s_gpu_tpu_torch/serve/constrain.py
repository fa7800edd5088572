"""Regex-constrained decoding: structured generation for the LM server.

The port of ``k8s_gpu_tpu/serve/constrain.py``: the parser, the
Thompson NFA, the subset construction and the token walk are the
reference's numpy code, unchanged; ``ConstraintBank``'s tables are
tensors on a device (``ConstraintBank.to``), where the batcher's rounds
gather from them.

The modern serving stacks the reference delegates to (Ollama etc.) grow
grammar-constrained output; here it is first-party and TPU-shaped.  The
pipeline:

    regex ──parse──► AST ──Thompson──► NFA ──subset──► DFA over the
    tokenizer's character alphabet ──token walk──► two arrays:

        next_state [S, V] int32   (-1 = dead)
        allowed    [S, V] bool    (token keeps the string in-language
                                   AND completable by this vocabulary)

Everything data-dependent at decode time is a GATHER on those arrays:
each row carries its DFA state; the state's `allowed` row masks the
logits (additive -inf) before argmax/sampling; the chosen token indexes
`next_state`.  No Python in the loop and no host sync: the automaton
advances on the device inside the same decode round as unconstrained
rows.

Supported syntax: literals, escapes (\\d \\w \\s \\. ...), ``.``,
character classes ``[a-z0-9]`` / ``[^...]``, groups, ``|``, ``*``,
``+``, ``?``.  The DFA alphabet is the *concrete* set of characters
appearing in the tokenizer's vocabulary — transitions for characters no
token can produce are never materialized.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# -- regex parsing (AST: tuples) --------------------------------------------
# node := ("lit", predicate_frozenset | None-for-dot)
#       | ("cat", [nodes]) | ("alt", [nodes]) | ("rep", node, min, max|-1)

_ESCAPES = {
    "d": set("0123456789"),
    "w": set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"),
    "s": set(" \t\n\r\f\v"),
}

# Control-character escapes resolve to the actual character; any OTHER
# alphanumeric escape is an error rather than silently matching the
# literal letter (standard regex engines reserve those).
_CTRL_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "f": "\f", "v": "\v", "0": "\0"}


class RegexError(ValueError):
    pass


def _escape_char(e: str) -> str:
    """Resolve a single-character escape that is not a class shorthand."""
    if e in _CTRL_ESCAPES:
        return _CTRL_ESCAPES[e]
    if e.isalnum():
        raise RegexError(f"unknown escape \\{e}")
    return e


def _parse(pattern: str):
    pos = 0

    def peek():
        return pattern[pos] if pos < len(pattern) else None

    def take():
        nonlocal pos
        c = pattern[pos]
        pos += 1
        return c

    def parse_alt():
        branches = [parse_cat()]
        while peek() == "|":
            take()
            branches.append(parse_cat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def parse_cat():
        items = []
        while peek() is not None and peek() not in "|)":
            items.append(parse_rep())
        if not items:
            return ("cat", [])
        return items[0] if len(items) == 1 else ("cat", items)

    def parse_rep():
        node = parse_atom()
        while peek() in ("*", "+", "?"):
            op = take()
            if op == "*":
                node = ("rep", node, 0, -1)
            elif op == "+":
                node = ("rep", node, 1, -1)
            else:
                node = ("rep", node, 0, 1)
        return node

    def parse_class():
        negate = False
        if peek() == "^":
            take()
            negate = True
        chars: set = set()
        prev = None
        while True:
            c = peek()
            if c is None:
                raise RegexError("unterminated character class")
            take()
            if c == "]":
                break
            if c == "\\":
                e = take()
                if e in _ESCAPES:
                    chars |= _ESCAPES[e]
                    prev = None
                else:
                    resolved = _escape_char(e)
                    chars.add(resolved)
                    prev = resolved
            elif c == "-" and prev is not None and peek() not in (None, "]"):
                hi = take()
                chars |= {chr(x) for x in range(ord(prev), ord(hi) + 1)}
                prev = None
            else:
                chars.add(c)
                prev = c
        return ("lit", frozenset(chars), negate)

    def parse_atom():
        c = peek()
        if c is None:
            raise RegexError("unexpected end of pattern")
        if c == "(":
            take()
            node = parse_alt()
            if peek() != ")":
                raise RegexError("unbalanced parenthesis")
            take()
            return node
        if c == "[":
            take()
            return parse_class()
        if c == ".":
            take()
            return ("lit", None, False)  # any char
        if c == "\\":
            take()
            e = take()
            if e in _ESCAPES:
                return ("lit", frozenset(_ESCAPES[e]), False)
            return ("lit", frozenset({_escape_char(e)}), False)
        if c in ")|*+?]":
            raise RegexError(f"unexpected {c!r} at {pos}")
        take()
        return ("lit", frozenset({c}), False)

    node = parse_alt()
    if pos != len(pattern):
        raise RegexError(f"trailing input at {pos}")
    return node


# -- Thompson NFA ------------------------------------------------------------

class _Nfa:
    def __init__(self):
        self.eps: list[list[int]] = []
        # char edges: (state, predicate, negate, target); predicate None = any
        self.edges: list[tuple[int, frozenset | None, bool, int]] = []

    def state(self) -> int:
        self.eps.append([])
        return len(self.eps) - 1


def _build(nfa: _Nfa, node) -> tuple[int, int]:
    kind = node[0]
    if kind == "lit":
        _, pred, neg = node
        a, b = nfa.state(), nfa.state()
        nfa.edges.append((a, pred, neg, b))
        return a, b
    if kind == "cat":
        if not node[1]:
            a = nfa.state()
            return a, a
        first = last = None
        for child in node[1]:
            s, e = _build(nfa, child)
            if first is None:
                first = s
            else:
                nfa.eps[last].append(s)
            last = e
        return first, last
    if kind == "alt":
        a, b = nfa.state(), nfa.state()
        for child in node[1]:
            s, e = _build(nfa, child)
            nfa.eps[a].append(s)
            nfa.eps[e].append(b)
        return a, b
    if kind == "rep":
        _, child, lo, hi = node
        if (lo, hi) == (0, 1):        # ?
            s, e = _build(nfa, child)
            nfa.eps[s].append(e)
            return s, e
        if (lo, hi) == (0, -1):       # *
            a = nfa.state()
            s, e = _build(nfa, child)
            nfa.eps[a].append(s)
            nfa.eps[e].append(a)
            return a, a
        if (lo, hi) == (1, -1):       # +
            s, e = _build(nfa, child)
            nfa.eps[e].append(s)
            return s, e
    raise RegexError(f"unsupported node {node!r}")


def _closure(nfa: _Nfa, states: frozenset) -> frozenset:
    out = set(states)
    stack = list(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in out:
                out.add(t)
                stack.append(t)
    return frozenset(out)


def _step(nfa: _Nfa, states: frozenset, ch: str) -> frozenset:
    out = set()
    for s, pred, neg, t in nfa.edges:
        if s in states:
            hit = True if pred is None else (ch in pred) != neg
            if hit:
                out.add(t)
    return _closure(nfa, out) if out else frozenset()


# -- DFA + token tables ------------------------------------------------------

@dataclass
class RegexConstraint:
    """Token-level automaton for one pattern + one vocabulary, as host
    arrays (``generate_constrained`` moves them to its device)."""
    next_state: np.ndarray    # [S, V] int32, -1 = dead
    allowed: np.ndarray       # [S, V] bool
    accepting: np.ndarray     # [S] bool
    start: int
    pattern: str

    @property
    def n_states(self) -> int:
        return int(self.next_state.shape[0])


class ConstraintBank:
    """A fixed set of named patterns, banked for continuous batching.

    Per-request constraints in one decode program need uniform table
    shapes, so — exactly like the LoRA AdapterBank — patterns are
    compiled up-front and padded to the bank maximum:

        next  [C, S_max, V] int32   allowed [C, S_max, V] bool

    Index 0 is "unconstrained": a single all-permissive self-loop
    state, so unconstrained rows run the same gathers with a mask
    that never masks.  Each decode row carries (cidx, cstate); both
    are data, never shapes.

    The tables are built as tensors on the CPU: a server compiles its
    bank before its batcher exists, and the batcher moves it to its
    device with ``to``.
    """

    def __init__(self, patterns: dict[str, str], token_strings: list[str]):
        self.names = ["__free__"] + sorted(patterns)
        self.compiled = {
            name: compile_constraint(pat, token_strings)
            for name, pat in patterns.items()
        }
        V = len(token_strings)
        S = max(
            [1] + [c.n_states for c in self.compiled.values()]
        )
        C = len(self.names)
        nxt = np.full((C, S, V), -1, np.int32)
        allow = np.zeros((C, S, V), bool)
        # index 0: one state, everything allowed, self-loop
        nxt[0, 0, :] = 0
        allow[0, 0, :] = True
        accepting = np.zeros((C, S), bool)
        accepting[0, 0] = True
        for i, name in enumerate(self.names[1:], start=1):
            c = self.compiled[name]
            s = c.n_states
            nxt[i, :s] = np.asarray(c.next_state)
            allow[i, :s] = np.asarray(c.allowed)
            accepting[i, :s] = np.asarray(c.accepting)
        self.next_state = torch.from_numpy(nxt)
        self.allowed = torch.from_numpy(allow)
        self.accepting = torch.from_numpy(accepting)

    def to(self, device) -> "ConstraintBank":
        """Move the tables to ``device`` in place; returns the bank."""
        self.next_state = self.next_state.to(device)
        self.allowed = self.allowed.to(device)
        self.accepting = self.accepting.to(device)
        return self

    @property
    def table_bytes(self) -> int:
        """Bytes of the three tables."""
        return sum(t.numel() * t.element_size()
                   for t in (self.next_state, self.allowed, self.accepting))

    @property
    def banked(self):
        """None when no real patterns — callers skip the gathers."""
        if len(self.names) == 1:
            return None
        return {"next": self.next_state, "allowed": self.allowed}

    def index(self, name: str | None) -> int:
        if name is None:
            return 0
        try:
            return self.names.index(name)
        except ValueError:
            raise KeyError(
                f"unknown constraint {name!r}; serving {self.names[1:]}"
            ) from None


def compile_constraint(pattern: str, token_strings: list[str]) -> RegexConstraint:
    """Build the [S, V] token tables for *pattern* over a vocabulary.

    ``token_strings[v]`` is the text token v decodes to.  A token is
    allowed in state s iff walking its characters stays in-language AND
    the landing state can still reach acceptance via tokens of this
    vocabulary; empty tokens are never allowed (they would stall the
    automaton)."""
    ast = _parse(pattern)
    nfa = _Nfa()
    s0, s_end = _build(nfa, ast)

    alphabet = sorted({c for t in token_strings for c in t})
    start = _closure(nfa, frozenset({s0}))
    # Subset construction over the concrete alphabet.
    states: dict[frozenset, int] = {start: 0}
    order = [start]
    char_next: list[dict[str, int]] = []
    i = 0
    while i < len(order):
        cur = order[i]
        row: dict[str, int] = {}
        for ch in alphabet:
            nxt = _step(nfa, cur, ch)
            if not nxt:
                continue
            if nxt not in states:
                states[nxt] = len(order)
                order.append(nxt)
                if len(order) > 4096:
                    raise RegexError(
                        "constraint DFA exceeds 4096 states; simplify the "
                        "pattern"
                    )
            row[ch] = states[nxt]
        char_next.append(row)
        i += 1

    S, V = len(order), len(token_strings)
    accepting = np.array([s_end in sub for sub in order], bool)
    # Vectorize the token walk over states: T[ch] maps [S]→[S] (with a
    # dead sentinel at index S), so a token's table column is
    # len(token) chained gathers on an [S] vector instead of an
    # S×V×len Python triple loop (minutes-scale for real BPE vocabs).
    DEAD = S
    trans = {}
    for ch in alphabet:
        col = np.full(S + 1, DEAD, np.int32)
        for s in range(S):
            col[s] = char_next[s].get(ch, DEAD)
        trans[ch] = col
    next_state = np.full((S, V), -1, np.int32)
    identity = np.arange(S, dtype=np.int32)
    for v, tok in enumerate(token_strings):
        if not tok:
            # Empty tokens are never allowed — they would stall the
            # automaton (and the decode loop) without consuming input.
            continue
        cur = identity
        for ch in tok:
            cur = trans[ch][cur]
        next_state[:, v] = np.where(cur == DEAD, -1, cur)
    # Prefix-validity is not completability: a token can keep the string
    # in-language while landing in a state no token in THIS vocabulary
    # can ever extend to acceptance (a bare '"' walking into the middle
    # of a property name the tokenizer only carries whole).  The decode
    # loop then dead-ends and retires the row on EOS with an unparseable
    # prefix.  Prune to token-live states — accepting, or with some
    # transition into a live state — as a fixpoint over the TOKEN tables
    # (character-level liveness is not enough: the stranded state above
    # is char-live but token-dead).
    valid = next_state >= 0
    tgt = np.where(valid, next_state, 0)
    live = accepting.copy()
    while True:
        grown = live | (valid & live[tgt]).any(axis=1)
        if (grown == live).all():
            break
        live = grown
    next_state = np.where(valid & live[tgt], next_state, -1)
    return RegexConstraint(
        next_state=next_state,
        allowed=next_state >= 0,
        accepting=accepting,
        start=0,
        pattern=pattern,
    )
