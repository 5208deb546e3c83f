"""Job submission: run driver scripts against a cluster, track their fate.

The port's copy of `ray_tpu/job_submission/__init__.py`. Equivalent of the reference's job submission stack (`JobSubmissionClient`,
`dashboard/modules/job/job_manager.py:507`): a job is an entrypoint shell
command spawned near the head node with the cluster address in its
environment; status transitions PENDING -> RUNNING -> SUCCEEDED / FAILED /
STOPPED are tracked server-side and logs are captured per job.

The manager runs inside the GCS process (this framework has no separate
dashboard process); the client talks to it over the normal GCS RPC channel,
so `JobSubmissionClient(address)` works from anywhere that can reach the
cluster.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.rpc import RpcClient


class JobStatus:
    # SUBMITTED: accepted into the GCS job table, driver not launched yet
    # (agent path); the legacy in-GCS manager reports PENDING instead.
    SUBMITTED = "SUBMITTED"
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = (SUCCEEDED, FAILED, STOPPED)


@dataclass
class JobDetails:
    submission_id: str
    entrypoint: str
    status: str
    message: str = ""
    start_time: Optional[float] = None
    end_time: Optional[float] = None
    metadata: Dict[str, str] = field(default_factory=dict)
    # Agent-path jobs only (jobs/state.py public_details — keep in sync);
    # the legacy manager leaves these at their defaults.
    runtime_env: Dict[str, Any] = field(default_factory=dict)
    tenant: str = ""
    node_id: Optional[str] = None
    driver_job_id: Optional[str] = None


class JobSubmissionClient:
    """Client API (reference `ray.job_submission.JobSubmissionClient`)."""

    def __init__(self, address: str):
        # Accept "ray://host:port", "http://host:port" or bare "host:port" —
        # they all route to the GCS RPC endpoint here.
        for prefix in ("ray://", "http://", "https://"):
            if address.startswith(prefix):
                address = address[len(prefix):]
        self._client = RpcClient(address, name="job-client")

    def submit_job(self, *, entrypoint: str,
                   submission_id: Optional[str] = None,
                   runtime_env: Optional[Dict[str, Any]] = None,
                   metadata: Optional[Dict[str, str]] = None,
                   tenant: Optional[Any] = None) -> str:
        """Submit an entrypoint. `runtime_env` is prepared CLIENT-side
        (working_dir/py_modules zip + upload to the GCS blob store) so
        the job record only ever carries content-addressed URIs — the
        agent node needs no access to the client's filesystem. `tenant`
        is a tenant name (str) or TenantSpec-shaped dict; the job's
        tasks are then admitted under that tier/weight/rate quota by
        every raylet dispatch loop (docs/JOBS.md "Jobs as tenants")."""
        if runtime_env:
            from ray_tpu_torch.core.runtime_env import prepare

            runtime_env = prepare(runtime_env, self._client)
        resp = self._client.call("submit_job", {
            "entrypoint": entrypoint, "submission_id": submission_id,
            "runtime_env": runtime_env, "metadata": metadata or {},
            "tenant": tenant})
        if resp.get("error"):
            raise RuntimeError(resp["error"])
        return resp["submission_id"]

    def get_job_status(self, submission_id: str) -> str:
        return self._details(submission_id).status

    def get_job_info(self, submission_id: str) -> JobDetails:
        return self._details(submission_id)

    def _details(self, submission_id: str) -> JobDetails:
        resp = self._client.call("job_info", {"submission_id": submission_id})
        if resp is None or not resp.get("found"):
            raise ValueError(f"no job with submission_id {submission_id!r}")
        return JobDetails(**resp["details"])

    def get_job_logs(self, submission_id: str) -> str:
        resp = self._client.call("job_logs", {"submission_id": submission_id})
        if not resp.get("found"):
            raise ValueError(f"no job with submission_id {submission_id!r}")
        return resp["logs"]

    def stop_job(self, submission_id: str) -> bool:
        return bool(self._client.call(
            "stop_job", {"submission_id": submission_id}).get("stopped"))

    def delete_job(self, submission_id: str) -> bool:
        return bool(self._client.call(
            "delete_job", {"submission_id": submission_id}).get("deleted"))

    def list_jobs(self) -> List[JobDetails]:
        return [JobDetails(**d) for d in self._client.call("list_jobs")]

    def tail_job_logs(self, submission_id: str, poll_s: float = 0.5):
        """Generator of new log chunks until the job terminates."""
        import time

        seen = 0
        # Unbounded by API contract (tail -f semantics: follow the job
        # until it terminates); the bound is the TERMINAL status check —
        # a dead job server fails the poll's own RPC instead of hanging.
        while True:  # raylint: disable=RL010
            logs = self.get_job_logs(submission_id)
            if len(logs) > seen:
                yield logs[seen:]
                seen = len(logs)
            if self.get_job_status(submission_id) in JobStatus.TERMINAL:
                rest = self.get_job_logs(submission_id)
                if len(rest) > seen:
                    yield rest[seen:]
                return
            time.sleep(poll_s)

    def close(self):
        self._client.close()


__all__ = ["JobStatus", "JobDetails", "JobSubmissionClient"]
