"""Resilience layer: retry/breaker/deadline policies, deterministic fault
injection, and supervision wrappers (see policy.py / faults.py /
supervise.py module docs); port of
``githubrepostorag_tpu/resilience/__init__.py``."""

from githubrepostorag_tpu_torch.resilience.policy import (
    CircuitBreaker,
    CircuitOpen,
    Deadline,
    DeadlineExceeded,
    RetryPolicy,
    breaker_states,
    current_deadline,
    deadline_scope,
    get_breaker,
    reset_breakers,
)
from githubrepostorag_tpu_torch.resilience.faults import (
    FaultSpecError,
    InjectedFault,
    fire_async,
    fire_sync,
    reset_faults,
)
from githubrepostorag_tpu_torch.resilience.supervise import ResilientBus
from githubrepostorag_tpu_torch.resilience.admission import (
    admission_hint,
    clear_hint_provider,
    set_hint_provider,
    should_shed,
)

__all__ = [
    "CircuitBreaker",
    "admission_hint",
    "clear_hint_provider",
    "set_hint_provider",
    "should_shed",
    "CircuitOpen",
    "Deadline",
    "DeadlineExceeded",
    "FaultSpecError",
    "InjectedFault",
    "ResilientBus",
    "RetryPolicy",
    "breaker_states",
    "current_deadline",
    "deadline_scope",
    "fire_async",
    "fire_sync",
    "get_breaker",
    "reset_breakers",
    "reset_faults",
]
