"""Fin-Agent-Suite on the card: the port of ``k8s_gpu_tpu/finagent``, the
reference's one complete application.

The reference documents "Fin-Agent-Suite" (智能风控解决方案.md:368-419): a
FastAPI router-agent service where `POST /chat` triages a user query to a
complaint agent (PostgreSQL read + insert + empathetic LLM reply,
:268-306) or a marketing agent (RAG: embed → Milvus top-3 → context prompt
→ LLM, :235-266), over a knowledge base ingested idempotently
(:11-169: drop-and-recreate Milvus collection, 500/50 chunking, 1024-d
embeddings, seeded behavior-log row).

Each external service has an on-device or in-process equivalent, with
the reference's API, routes, prompts, keywords and 500/50 chunking:

- Milvus            → ``vectorstore.VectorStore``: each collection one
                      float32 tensor on the card; a search is one exact
                      product plus ``torch.topk``.
- bge-large-zh-v1.5 → ``embed.TextEmbedder``: hashed char-ngram features
                      on the host, a fixed random projection on the card
                      (1024-d).
- PostgreSQL        → ``sqlstore.SqlStore``: stdlib sqlite, same two tables
                      and seed row.
- Ollama qwen:72b   → ``llm.HttpLMClient`` against the port's own
                      ``LmServer`` (on the paged pool, through the paged
                      kernel): the reference's HTTP topology end to end;
                      or ``llm.TorchLMClient``, the port's
                      ``InferenceEngine`` in process over a byte-level
                      tokenizer (or ``llm.TemplateLM``).
- FastAPI           → ``server``: stdlib http.server, same routes/JSON.

Entry points that hold tensors (``TextEmbedder``, ``VectorStore``,
``TorchLMClient``) take ``device`` and run on the card unless the caller
asks for the CPU.
"""

from .agents import ChatResponse, FinAgentApp, QueryRequest
from .embed import TextEmbedder
from .ingest import ingest
from .llm import HttpLMClient, TemplateLM, TorchLMClient
from .splitter import recursive_split
from .sqlstore import SqlStore
from .vectorstore import VectorStore

__all__ = [
    "ChatResponse", "FinAgentApp", "QueryRequest", "TextEmbedder",
    "ingest", "TemplateLM", "TorchLMClient", "HttpLMClient",
    "recursive_split", "SqlStore", "VectorStore",
]
