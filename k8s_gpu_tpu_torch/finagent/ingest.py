"""Idempotent data initialization — the reference's `ingest_data.py` role:
the port's own copy of ``k8s_gpu_tpu/finagent/ingest.py``.

智能风控解决方案.md:11-169: drop-if-exists the Milvus collection (:47-52),
recreate with the id/text/1024-d schema (:55-59), load `**/*.md`, split
500/50 (:64-72), embed on CPU (:75), insert + flush (:79-83), build the
index (:88-96); then drop-and-recreate the two PostgreSQL tables with the
seed row (:99-161).  Re-running must always converge to the same state —
the ingest doubles as the test fixture (SURVEY §4).
"""

from __future__ import annotations

from pathlib import Path

from .embed import EMBEDDING_DIM, TextEmbedder
from .splitter import load_markdown_dir, recursive_split
from .sqlstore import SqlStore
from .vectorstore import VectorStore

COLLECTION_NAME = "financial_knowledge"


def ingest(knowledge_dir: str | Path, vectors: VectorStore,
           sql: SqlStore | None = None,
           embedder: TextEmbedder | None = None,
           collection_name: str = COLLECTION_NAME) -> dict:
    embedder = embedder or TextEmbedder(device=vectors.device)

    # Vector side: drop-if-exists → create → chunk → embed → insert → index.
    if vectors.has_collection(collection_name):
        vectors.drop_collection(collection_name)
    coll = vectors.create_collection(
        collection_name, dim=embedder.dim, description="金融知识库"
    )
    chunks: list[str] = []
    for _, text in load_markdown_dir(knowledge_dir):
        chunks.extend(recursive_split(text, chunk_size=500, chunk_overlap=50))
    if chunks:
        coll.insert(chunks, embedder.encode(chunks))
        coll.flush()
    coll.create_index(metric="L2")

    # Relational side: drop-and-recreate + seed.
    if sql is not None:
        sql.setup()

    return {
        "collection": collection_name,
        "num_chunks": len(chunks),
        "dim": embedder.dim,
        "sql_seeded": sql is not None,
    }
