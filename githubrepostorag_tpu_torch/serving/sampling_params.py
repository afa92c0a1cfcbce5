"""Per-request sampling parameters (the OpenAI/vLLM request-surface knobs the
reference's clients send: temperature/top_p/repetition_penalty/max tokens —
qwen_llm.py:107-114, llm_init.py:107-117)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.7
    top_p: float = 0.9
    top_k: int = 0  # 0 disables
    max_tokens: int = 256
    repetition_penalty: float = 1.0
    stop_token_ids: tuple[int, ...] = ()
    # stop strings are applied by the tokenizer-aware HTTP layer
    stop: tuple[str, ...] = ()

    def clamped(self, context_budget: int) -> "SamplingParams":
        """Cap max_tokens to the remaining context budget."""
        if self.max_tokens <= context_budget:
            return self
        import dataclasses

        return dataclasses.replace(self, max_tokens=max(context_budget, 0))
