"""Fault tolerance (counterpart of ``p2p_tpu/resilience``): graceful
shutdown and preemption with exit code 75 (:mod:`.preempt`), the training
health sentinel and recovery ladder with exit code 76 (:mod:`.health`),
retry with backoff (:mod:`.retry`), fault injection (:mod:`.chaos`) and
the bounded request queue with quarantine (:mod:`.queue`) and the
restore-time migrations of an elastic relaunch, the data-axis part
(:mod:`.reshape`)."""

from p2p_tpu_torch.resilience.chaos import (
    ChaosMonkey,
    FaultInjected,
    chaos_point,
    get_chaos,
    install as install_chaos,
    parse_spec,
)
from p2p_tpu_torch.resilience.health import (
    DIVERGED_EXIT_CODE,
    DivergenceError,
    DivergenceSentinel,
    RecoveryLadder,
    TrainingHealth,
)
from p2p_tpu_torch.resilience.preempt import (
    PREEMPTED_EXIT_CODE,
    Preempted,
    PreemptionGuard,
)
from p2p_tpu_torch.resilience.queue import (
    BoundedRequestQueue,
    Quarantine,
    Request,
)
from p2p_tpu_torch.resilience.retry import (
    CKPT_POLICY,
    DEFAULT_POLICY,
    RetryPolicy,
    retry_call,
    retrying,
)

__all__ = [
    "BoundedRequestQueue",
    "CKPT_POLICY",
    "ChaosMonkey",
    "DEFAULT_POLICY",
    "DIVERGED_EXIT_CODE",
    "DivergenceError",
    "DivergenceSentinel",
    "FaultInjected",
    "PREEMPTED_EXIT_CODE",
    "Preempted",
    "PreemptionGuard",
    "RecoveryLadder",
    "TrainingHealth",
    "Quarantine",
    "Request",
    "RetryPolicy",
    "chaos_point",
    "get_chaos",
    "install_chaos",
    "parse_spec",
    "retry_call",
    "retrying",
]
