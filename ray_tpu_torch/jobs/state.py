"""Submitted-job records: the schema of the GCS job table.

One dict per submission, created here so the GCS (which persists and
mutates records), the job agent (which reports transitions), and the
client (which reads `public_details`) agree on the fields. States follow
the reference's submission state machine
(`dashboard/modules/job/common.py:JobStatus`) minus PENDING-vs-SUBMITTED
hairsplitting: a record is SUBMITTED until its driver process is alive.

    SUBMITTED --> RUNNING --> SUCCEEDED | FAILED
        \\------------------> STOPPED    (client stop, node death rules)

Terminal states never transition again — a late agent report against a
STOPPED/deleted record is dropped, not resurrected.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

SUBMITTED = "SUBMITTED"
RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
STOPPED = "STOPPED"

TERMINAL = (SUCCEEDED, FAILED, STOPPED)


def new_record(sid: str, entrypoint: str,
               runtime_env: Optional[Dict[str, Any]],
               metadata: Optional[Dict[str, str]],
               tenant_qos: Optional[Dict[str, Any]],
               env_sig: str, now: float) -> Dict[str, Any]:
    return {
        "submission_id": sid,
        "entrypoint": entrypoint,
        "state": SUBMITTED,
        "message": "",
        "runtime_env": dict(runtime_env or {}),
        "env_sig": env_sig,
        "metadata": dict(metadata or {}),
        "tenant_qos": dict(tenant_qos or {}),
        "submit_time": now,
        "start_time": None,
        "end_time": None,
        # Where the agent runs the driver (node hex) and what it reported.
        "node_id": None,
        "driver_pid": None,
        # Driver JobID hex, linked when the entrypoint calls ray_tpu_torch.init()
        # and register_job carries RAY_TPU_TORCH_SUBMISSION_ID back to us.
        "driver_job_id": None,
    }


def public_details(rec: Dict[str, Any]) -> Dict[str, Any]:
    """The wire form JobSubmissionClient builds JobDetails from — keep in
    sync with `job_submission.JobDetails` (dataclass ctor takes **this)."""
    return {
        "submission_id": rec["submission_id"],
        "entrypoint": rec["entrypoint"],
        "status": rec["state"],
        "message": rec["message"],
        "start_time": rec["start_time"],
        "end_time": rec["end_time"],
        "metadata": dict(rec["metadata"]),
        "runtime_env": dict(rec["runtime_env"]),
        "tenant": rec["tenant_qos"].get("name", ""),
        "node_id": rec["node_id"],
        "driver_job_id": rec["driver_job_id"],
    }


def is_terminal(rec: Dict[str, Any]) -> bool:
    return rec["state"] in TERMINAL
