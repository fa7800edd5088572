"""Run the Fin-Agent-Suite service on the port:
``python -m k8s_gpu_tpu_torch.finagent``.

Flags: --kb <dir> (knowledge base of .md files), --port (default 8000),
--torch-lm (the in-process ``TorchLMClient`` decode path instead of
``TemplateLM``), --device (default ``cuda``: the embedder, the vector
store and the in-process model; ``cpu`` when asked).  Equivalent of the reference's
`uvicorn main:app` entry (智能风控解决方案.md:470-476).
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

from http.server import ThreadingHTTPServer

from . import (
    FinAgentApp, SqlStore, TemplateLM, TextEmbedder, TorchLMClient,
    VectorStore, ingest,
)
from .server import make_handler

DEMO_KB = {
    "products.md": (
        "# 产品目录\n\n黄金积存支持每日定投，起投1克。\n\n"
        "个人消费贷款年利率低至3.4%。"
    ),
}


def main() -> None:
    ap = argparse.ArgumentParser(prog="k8s_gpu_tpu_torch.finagent")
    ap.add_argument("--kb", default="")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--torch-lm", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    if args.kb:
        kb = Path(args.kb)
    else:
        kb = Path(tempfile.mkdtemp(prefix="finagent-kb-"))
        for rel, text in DEMO_KB.items():
            (kb / rel).write_text(text, encoding="utf-8")
        print(f"no --kb given; using demo knowledge base at {kb}")

    embedder = TextEmbedder(device=args.device)
    vectors, sql = VectorStore(device=args.device), SqlStore()
    info = ingest(kb, vectors, sql, embedder=embedder)
    print(f"ingest: {info}")
    llm = TorchLMClient(device=args.device) if args.torch_lm else TemplateLM()
    app = FinAgentApp(embedder=embedder, vectors=vectors, sql=sql, llm=llm)
    srv = ThreadingHTTPServer(("127.0.0.1", args.port), make_handler(app))
    port = srv.server_address[1]
    print(f"Fin-Agent-Suite listening on http://127.0.0.1:{port}  (POST /chat)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()


if __name__ == "__main__":
    main()
