"""Router / marketing / complaint agents — the reference's core logic:
the port's own copy of ``k8s_gpu_tpu/finagent/agents.py``, wired to the
port's embedder, vector store and LLM clients.

Mirrors 智能风控解决方案.md:
- router (:309-323): keyword triage — complaint keywords → complaint
  agent, else marketing agent; response is {agent, response}.
- marketing (:235-266): embed query → top-3 vector search → "---"-joined
  context → marketing-specialist prompt → LLM.
- complaint (:268-306): latest '%failed%' behavior-log row for the user →
  insert the complaint → empathy prompt with the verified facts → LLM.

Extension contract kept from the reference (:545-556): adding an agent is
one handler plus a routing keyword entry.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .embed import TextEmbedder
from .ingest import COLLECTION_NAME
from .llm import LMClient
from .sqlstore import SqlStore
from .vectorstore import VectorStore

# Reference :313 — complaint keywords (Chinese) plus English equivalents so
# the router is usable in both; lowercase matched against lowercased query.
COMPLAINT_KEYWORDS = [
    "投诉", "失败", "不满", "登不上", "无法登录", "问题",
    "complaint", "failed", "unhappy", "cannot log", "can't log", "issue",
]

MARKETING_AGENT = "营销专员"   # marketing specialist (:320)
COMPLAINT_AGENT = "投诉专员"   # complaint specialist (:317)


@dataclass
class QueryRequest:
    query: str
    user_id: str = "user_123"  # reference default (:227)


@dataclass
class ChatResponse:
    agent: str
    response: str


@dataclass
class FinAgentApp:
    embedder: TextEmbedder
    vectors: VectorStore
    sql: SqlStore
    llm: LMClient
    collection_name: str = COLLECTION_NAME
    top_k: int = 3  # reference :246
    extra_routes: dict = field(default_factory=dict)  # keyword → handler

    # -- marketing (RAG) ---------------------------------------------------
    def handle_marketing(self, query: str) -> str:
        qv = self.embedder.encode(query)
        hits = self.vectors.collection(self.collection_name).search(
            qv, limit=self.top_k, metric="L2"
        )
        context = "\n---\n".join(h.text for h in hits)
        prompt = (
            "你是一个专业的金融营销专员。请基于以下背景知识，清晰、准确地回答"
            "用户的问题。如果背景知识无法回答，请礼貌地告知用户你暂时无法提供"
            "该信息。\n\n[背景知识]\n"
            f"{context}\n\n[用户问题]\n{query}"
        )
        return self.llm.chat(prompt)

    # -- complaint (SQL) ---------------------------------------------------
    def handle_complaint(self, query: str, user_id: str) -> str:
        ev = self.sql.latest_failed_event(user_id)
        context = (
            f"我们已经核实到您在{ev.event_time} 尝试{ev.details}。"
            if ev else "未查询到相关用户行为日志。"
        )
        ts = self.sql.insert_complaint(user_id, query)
        context += (
            f" 您的反馈对我们至关重要，我们已将此次投诉于{ts}"
            "记录下来以便进一步分析和改进。"
        )
        prompt = (
            "你是一位经验丰富且富有同理心的客户投诉专员。你的任务是安抚用户"
            "情绪，并告知用户你已经采取的行动。\n\n[已知情况]\n"
            f"{context}\n\n[用户抱怨]\n{query}\n\n"
            "请根据已知情况，生成一段专业、诚恳且有帮助的回复。首先要表示理解"
            "和歉意，然后说明你已经核实到的信息和记录的投诉，最后表达解决问题"
            "的意愿。"
        )
        return self.llm.chat(prompt)

    # -- router ------------------------------------------------------------
    def chat(self, request: QueryRequest) -> ChatResponse:
        q = request.query.lower()
        for kw, (name, handler) in self.extra_routes.items():
            if kw in q:
                return ChatResponse(name, handler(request))
        if any(kw in q for kw in COMPLAINT_KEYWORDS):
            return ChatResponse(
                COMPLAINT_AGENT,
                self.handle_complaint(request.query, request.user_id),
            )
        return ChatResponse(MARKETING_AGENT, self.handle_marketing(request.query))
