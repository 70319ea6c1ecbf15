"""Fault tolerance (counterpart of ``p2p_tpu/resilience``), as far as
serving needs it: graceful shutdown (:mod:`.preempt`), retry with backoff
(:mod:`.retry`), fault injection (:mod:`.chaos`) and the bounded request
queue with quarantine (:mod:`.queue`). The training health ladder, the
elastic reshape and the exit codes 75/76 come later."""

from p2p_tpu_torch.resilience.chaos import (
    ChaosMonkey,
    FaultInjected,
    chaos_point,
    install as install_chaos,
    parse_spec,
)
from p2p_tpu_torch.resilience.preempt import PreemptionGuard
from p2p_tpu_torch.resilience.queue import (
    BoundedRequestQueue,
    Quarantine,
    Request,
)
from p2p_tpu_torch.resilience.retry import (
    DEFAULT_POLICY,
    RetryPolicy,
    retry_call,
    retrying,
)

__all__ = [
    "BoundedRequestQueue",
    "ChaosMonkey",
    "DEFAULT_POLICY",
    "FaultInjected",
    "PreemptionGuard",
    "Quarantine",
    "Request",
    "RetryPolicy",
    "chaos_point",
    "install_chaos",
    "parse_spec",
    "retry_call",
    "retrying",
]
