"""JSON-schema constrained decoding: schema → regex → token DFA.

The port's own copy of ``k8s_gpu_tpu/serve/jsonschema.py`` (pure Python,
no change of behaviour), so the port imports nothing of the reference.

The reference's serving story delegates structure to prompt engineering
(智能风控解决方案.md:250-266 asks the LLM nicely); modern serving stacks
offer schema-constrained output (OpenAI ``response_format``, vLLM
guided decoding).  Here the schema compiles to a regex over the
CANONICAL JSON serialization, and the existing regex→DFA pipeline
(serve/constrain.py) does the rest — one code path enforces both plain
regex and JSON-schema constraints, banked per request in shared decode
rounds.

Canonical form (what the DFA admits — also what ``json.dumps(...,
separators=(",", ":"))`` emits):

- no whitespace outside strings;
- object properties in DECLARATION order, all present (constrained
  generation must decide the next token greedily — optional/reordered
  keys would make the automaton ambiguous about which key comes next;
  callers mark truly-optional fields as nullable instead);
- strings admit any character except ``"``, ``\\`` and control chars,
  plus ``\\"`` ``\\\\`` ``\\/`` ``\\b`` ``\\f`` ``\\n`` ``\\r`` ``\\t``
  and ``\\uXXXX`` escapes.

Supported schema subset: ``type`` ∈ {string, integer, number, boolean,
null, array, object}, ``enum`` (JSON scalars), ``properties`` (fixed
order), ``items``, ``minItems`` ∈ {0, 1}, string ``pattern`` (the
author's regex replaces the default string body, INTERSECTED with the
legal JSON-string alphabet so it can never emit a raw quote/backslash/
control character).  Keyword support is an allowlist: anything else
(``maxItems``, ``required``, ``minimum``, ``$ref``, ...) is rejected
loudly — a constraint that silently under-constrains is worse than none.
"""

from __future__ import annotations

import json

__all__ = ["schema_to_regex", "SchemaError"]


class SchemaError(ValueError):
    pass


def _lit(text: str) -> str:
    """Regex matching *text* literally (escape every non-alphanumeric —
    constrain.py's parser treats ``\\X`` as literal X for non-alnum)."""
    return "".join(c if c.isalnum() else "\\" + c for c in text)


# One JSON string character: anything but quote/backslash/the full
# control range 0x00-0x1F (json.loads rejects raw controls), or a
# sanctioned escape.  The control characters are embedded RAW in the
# class — constrain.py's class parser takes any character literally.
_CTRL = "".join(chr(i) for i in range(0x20))
_STRING_CHAR = (
    '([^"\\\\' + _CTRL + ']'
    '|\\\\(["\\\\/bfnrt]|u[0-9a-fA-F][0-9a-fA-F][0-9a-fA-F][0-9a-fA-F]))'
)
_STRING = '"' + _STRING_CHAR + '*"'
_INTEGER = "\\-?(0|[1-9][0-9]*)"
_NUMBER = _INTEGER + "(\\.[0-9]+)?([eE][\\-\\+]?[0-9]+)?"


# The full supported keyword surface.  An ALLOWLIST, not a denylist: any
# keyword outside it (minimum, maxLength, required, $ref, ...) would be
# silently ignored by this compiler, i.e. the DFA would under-constrain
# relative to the declared schema — the exact failure mode the module
# docstring calls worse than none.  Annotation-only keys that constrain
# nothing (title, description, ...) are tolerated.
_SUPPORTED_KEYS = frozenset(
    {"type", "enum", "properties", "items", "minItems", "pattern", "nullable"}
)
_ANNOTATION_KEYS = frozenset({"title", "description", "default", "examples", "$schema"})


# Characters no JSON string body may contain raw: the framing quote, the
# escape introducer, and the full control range.  A pattern atom that can
# match one of them would let the DFA emit output that is not valid JSON
# (a raw quote inside the string body), so every atom is INTERSECTED with
# the legal body alphabet rather than embedded verbatim:
#
#   .          → [^"\<ctrl>]        dot, narrowed to the legal alphabet
#   [^...]     → [^..."\<ctrl>]     widening the negation = intersection
#   [a-z"]     → SchemaError        a member outside the legal alphabet
#   \s \n \t…  → SchemaError        would emit raw control characters
#
# The { } $ rejections (no bounded reps/anchors in the DFA dialect) and
# the top-level ^ rejection stay; ^ right after an unescaped [ is class
# negation and is supported by constrain.py, so it passes through.
_ILLEGAL_ORDS = frozenset({0x22, 0x5C} | set(range(0x20)))
_NEG_EXTRA = '"\\\\' + _CTRL  # regex text: quote, escaped backslash, raw ctrls
_LEGAL_DOT = "[^" + _NEG_EXTRA + "]"


def _pattern_to_string_body(pat: str) -> str:
    """Rewrite an author regex so it can only emit legal JSON string bodies."""

    def fail(msg: str):
        raise SchemaError(f"string pattern {pat!r}: {msg}")

    out: list[str] = []
    i, n = 0, len(pat)
    in_class = False          # inside [...]
    class_negated = False
    at_class_start = False    # immediately after [ (where ^ negates)
    prev_ord: int | None = None  # last concrete class member (range lo)
    range_open = False        # saw 'lo-' and await the range hi

    def member(o: int, text: str):
        """Append one concrete class member, enforcing legality/ranges."""
        nonlocal prev_ord, range_open
        if text == "-":
            # Always escape a literal dash member: raw, it could abut the
            # _NEG_EXTRA flush in a negated class and form a `-"` range —
            # `[^a-]*` compiled to `[^a-"\\…]*`, whose dash-range ate the
            # exclusion and let a raw quote leak into constrained JSON
            # output (ADVICE medium).
            text = "\\-"
        if range_open:
            lo = prev_ord
            if lo is None or lo > o:
                fail(f"bad class range ending at {text!r}")
            if not class_negated and any(lo <= x <= o for x in _ILLEGAL_ORDS):
                fail(f"class range {chr(lo)!r}-{text!r} covers characters "
                     "illegal in a JSON string body")
            range_open = False
            prev_ord = None
        else:
            if not class_negated and o in _ILLEGAL_ORDS:
                fail(f"class member {text!r} is illegal in a JSON string body")
            prev_ord = o
        out.append(text)

    while i < n:
        c = pat[i]
        if c == "\\":
            if i + 1 >= n:
                fail("trailing backslash")
            e = pat[i + 1]
            if e in "sntrfv0":
                fail(f"'\\{e}' can emit a raw control character, which is "
                     "illegal inside a JSON string body")
            if e in '"\\':
                fail(f"a literal {e!r} cannot appear raw inside a JSON "
                     "string body (it would break the framing)")
            if in_class:
                if e in "dw":  # shorthand sets; both fully body-legal
                    if range_open:
                        fail(f"class range cannot end in '\\{e}'")
                    prev_ord = None
                    out.append("\\" + e)
                else:
                    member(ord(e), "\\" + e)
            else:
                out.append("\\" + e)
            i += 2
            at_class_start = False
            continue
        if in_class:
            if c == "]":
                if range_open:
                    member(ord("-"), "-")  # trailing '-' is a literal member
                if class_negated:
                    out.append(_NEG_EXTRA)
                out.append("]")
                in_class = False
            elif c == '"':
                fail("'\"' in a character class would break the JSON framing")
            elif c == "^" and at_class_start:
                class_negated = True
                out.append("^")
            elif c == "-" and prev_ord is not None and i + 1 < n and pat[i + 1] != "]":
                range_open = True
                out.append("-")
            elif ord(c) < 0x20:
                if class_negated:
                    out.append(c)  # excluding a control char is fine
                else:
                    fail("raw control character in class")
            else:
                member(ord(c), c)
        else:
            if c == "[":
                in_class, class_negated = True, False
                at_class_start = True
                prev_ord, range_open = None, False
                out.append("[")
                i += 1
                continue
            if c == ".":
                out.append(_LEGAL_DOT)
            elif c == '"':
                fail("a literal '\"' cannot appear raw inside a JSON "
                     "string body (it would break the framing)")
            elif c in "{}$" or c == "^":
                fail(f"uses {c!r}: the DFA regex dialect has no bounded "
                     "repetition or anchors (it would match the character "
                     "literally)")
            elif ord(c) < 0x20:
                fail("raw control character")
            else:
                out.append(c)
        i += 1
        at_class_start = False
    if in_class:
        fail("unterminated character class")
    return "".join(out)


def schema_to_regex(schema: dict) -> str:
    """Compile a JSON-schema subset to a regex over canonical JSON."""
    if not isinstance(schema, dict):
        raise SchemaError(f"schema must be an object, got {type(schema).__name__}")
    unsupported = set(schema) - _SUPPORTED_KEYS - _ANNOTATION_KEYS
    if unsupported:
        raise SchemaError(
            f"unsupported schema keyword(s) {sorted(unsupported)!r} — the "
            "DFA would silently under-constrain (supported: "
            f"{sorted(_SUPPORTED_KEYS)})"
        )
    if schema.get("nullable"):
        # Honored at EVERY level (top-level, array items, object
        # properties): an allowlisted keyword that only worked in one
        # position would silently under-constrain elsewhere.
        inner = schema_to_regex(
            {k: v for k, v in schema.items() if k != "nullable"}
        )
        return f"({inner}|null)"
    if "enum" in schema:
        opts = []
        for v in schema["enum"]:
            if isinstance(v, (dict, list)):
                raise SchemaError("enum values must be JSON scalars")
            opts.append(_lit(json.dumps(v, separators=(",", ":"))))
        if not opts:
            raise SchemaError("empty enum")
        return "(" + "|".join(opts) + ")"
    t = schema.get("type")
    if t == "string":
        if "pattern" in schema:
            # Wrapping group: a top-level alternation must not escape
            # the surrounding quotes ('"yes|no"' parses as '"yes'|'no"').
            return '"(' + _pattern_to_string_body(schema["pattern"]) + ')"'
        return _STRING
    if t == "integer":
        return _INTEGER
    if t == "number":
        return _NUMBER
    if t == "boolean":
        return "(true|false)"
    if t == "null":
        return "null"
    if t == "array":
        items = schema.get("items")
        if items is None:
            raise SchemaError("array schema needs 'items'")
        item = schema_to_regex(items)
        min_items = int(schema.get("minItems", 0))
        if min_items not in (0, 1):
            raise SchemaError(
                "minItems > 1 needs bounded repetition the DFA regex "
                "dialect does not have; nest required items explicitly"
            )
        non_empty = f"\\[{item}(,{item})*\\]"
        if min_items == 1:
            return non_empty
        return f"(\\[\\]|{non_empty})"
    if t == "object":
        props = schema.get("properties")
        if not props:
            raise SchemaError("object schema needs non-empty 'properties'")
        parts = []
        for name, sub in props.items():
            # nullable is handled by the recursive call (every level).
            parts.append(_lit(json.dumps(name)) + ":" + schema_to_regex(sub))
        return "\\{" + ",".join(parts) + "\\}"
    raise SchemaError(f"unsupported schema type {t!r}")
