"""L3: the agentic query engine — plan -> retrieve -> judge -> rewrite ->
synthesize, rebuilt from the reference's LangGraph agent
(rag_worker/src/worker/services/agent_graph.py) as a plain state machine;
port of ``githubrepostorag_tpu/agent/``."""

from githubrepostorag_tpu_torch.agent.graph import AgentResult, GraphAgent, RunCancelled
from githubrepostorag_tpu_torch.agent.state import AgentState

__all__ = ["GraphAgent", "AgentResult", "AgentState", "RunCancelled"]
