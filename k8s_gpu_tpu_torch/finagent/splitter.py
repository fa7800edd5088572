"""Document loading + recursive character splitting: the port's own copy
of ``k8s_gpu_tpu/finagent/splitter.py``.

The reference loads `**/*.md` under the knowledge-base dir and splits with
LangChain's RecursiveCharacterTextSplitter(chunk_size=500, chunk_overlap=50)
(智能风控解决方案.md:64-73).  Same behavior, stdlib-only: split on the
coarsest separator that yields pieces, merge pieces greedily up to
``chunk_size`` keeping ``chunk_overlap`` of trailing context between
consecutive chunks.
"""

from __future__ import annotations

from pathlib import Path

SEPARATORS = ["\n\n", "\n", " ", ""]


def _split_on(text: str, sep: str) -> list[str]:
    if sep == "":
        return list(text)
    parts = text.split(sep)
    # Re-attach the separator so merging preserves the original text.
    return [p + sep for p in parts[:-1]] + [parts[-1]]


def _recurse(text: str, chunk_size: int, seps: list[str]) -> list[str]:
    if len(text) <= chunk_size:
        return [text]
    sep, rest = seps[0], seps[1:]
    pieces = _split_on(text, sep)
    out: list[str] = []
    for p in pieces:
        if len(p) > chunk_size and rest:
            out.extend(_recurse(p, chunk_size, rest))
        else:
            out.append(p)
    return out


def recursive_split(text: str, chunk_size: int = 500,
                    chunk_overlap: int = 50) -> list[str]:
    """Greedy merge of recursively split pieces; consecutive chunks share
    ~chunk_overlap chars of context (chunk 500 / overlap 50 parity,
    reference :72)."""
    pieces = _recurse(text, chunk_size, SEPARATORS)
    chunks: list[str] = []
    cur = ""
    for p in pieces:
        if cur and len(cur) + len(p) > chunk_size:
            chunks.append(cur.strip())
            cur = cur[max(0, len(cur) - chunk_overlap):]
        cur += p
    if cur.strip():
        chunks.append(cur.strip())
    return [c for c in chunks if c]


def load_markdown_dir(root: str | Path) -> list[tuple[str, str]]:
    """(path, text) for every **/*.md under root (reference :64-66)."""
    root = Path(root)
    return [
        (str(p.relative_to(root)), p.read_text(encoding="utf-8"))
        for p in sorted(root.rglob("*.md"))
    ]
