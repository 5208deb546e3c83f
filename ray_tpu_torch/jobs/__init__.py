"""ray_tpu_torch.jobs — the multi-job platform tier.

Sits between the core runtime and clients: submitted jobs live in a
GCS-owned, checkpointed job table; per-node agents (`jobs/agent.py`,
hosted inside each raylet) launch driver subprocesses with kill-handshake
hygiene (`jobs/procutil.py`) and stream logs back; the raylet dispatch
loop applies per-job fairness and rate quotas (`jobs/tenancy.py`) so a
batch job's task storm and serve traffic share one admission model.

Client entry point is `ray_tpu_torch.job_submission.JobSubmissionClient`
(`submit_job(entrypoint, runtime_env=..., tenant=...)`); see
docs/JOBS.md for the submission API, the runtime_env contract,
detached-actor lifetimes, and cleanup guarantees.
"""

from ray_tpu_torch.jobs import procutil  # noqa: F401
from ray_tpu_torch.jobs.agent import JobAgent  # noqa: F401
from ray_tpu_torch.jobs.state import (  # noqa: F401
    FAILED, RUNNING, STOPPED, SUBMITTED, SUCCEEDED, TERMINAL,
    is_terminal, new_record, public_details,
)
from ray_tpu_torch.jobs.tenancy import JobAdmission  # noqa: F401
