"""Query admission control and deadlines (the JAX package's sched/).

Per-tenant token buckets and concurrency limits over a bounded priority
queue (`admission.py`), and absolute deadlines checked at every
cancellation checkpoint (`deadline.py`). Under overload the accepting
edge sheds a typed error — `QueryOverloadedError` (429),
`QueryQueueTimeoutError` (503), `QueryDeadlineExceededError` (503) —
never a hang.
"""

from greptimedb_tpu_torch.sched.admission import (
    AdmissionController,
    SchedulerConfig,
    tenant_of,
)
from greptimedb_tpu_torch.sched.deadline import Deadline

__all__ = [
    "AdmissionController",
    "Deadline",
    "SchedulerConfig",
    "tenant_of",
]
