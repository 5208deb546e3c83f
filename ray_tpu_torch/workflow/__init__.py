"""Workflows: durable DAG execution with exactly-once step checkpointing.

The port's counterpart of `ray_tpu.workflow`, the equivalent of the
reference's workflow layer (`python/ray/workflow/api.py`:
run/resume/get_output, step checkpointing in `workflow_storage`): a DAG
built with `.bind()` runs step by step; each step's result is persisted to
the workflow's storage directory the moment it completes, so a crashed or
interrupted workflow resumes from its last finished step instead of
recomputing.

    @ray_tpu_torch.remote
    def fetch(): ...
    @ray_tpu_torch.remote
    def train(data): ...

    wf = train.bind(fetch.bind())
    result = workflow.run(wf, workflow_id="nightly")
    # later, after a crash mid-run:
    result = workflow.resume("nightly")

Step identity: deterministic ids from DAG structure (topological position
+ task name), so the same DAG shape maps onto the same checkpoints.
Storage: `$RAY_TPU_TORCH_WORKFLOW_DIR`, else `~/ray_tpu_torch_workflows`.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.dag import DAGNode, FunctionNode

__all__ = ["run", "run_async", "resume", "get_output", "get_status",
           "list_all", "delete", "WorkflowStatus"]


class WorkflowStatus:
    RUNNING = "RUNNING"
    SUCCESSFUL = "SUCCESSFUL"
    FAILED = "FAILED"
    RESUMABLE = "RESUMABLE"


def _storage_root() -> str:
    return os.environ.get("RAY_TPU_TORCH_WORKFLOW_DIR") or os.path.join(
        os.path.expanduser("~"), "ray_tpu_torch_workflows")


def _wf_dir(workflow_id: str) -> str:
    return os.path.join(_storage_root(), workflow_id)


def _step_ids(dag: FunctionNode) -> Dict[int, str]:
    """Deterministic id per node: depth-first position + task name."""
    ids: Dict[int, str] = {}
    counter = [0]

    def walk(node: DAGNode):
        if id(node) in ids or not isinstance(node, FunctionNode):
            return
        for child in node._children():
            walk(child)
        ids[id(node)] = f"step_{counter[0]:04d}_{node.name}"
        counter[0] += 1

    walk(dag)
    return ids


def _atomic_pickle(path: str, obj: Any):
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
    os.replace(tmp, path)


class _WorkflowRun:
    def __init__(self, workflow_id: str, dag: FunctionNode):
        self.workflow_id = workflow_id
        self.dag = dag
        self.dir = _wf_dir(workflow_id)
        os.makedirs(self.dir, exist_ok=True)
        self.step_ids = _step_ids(dag)

    # -------------------------------------------------------------- state

    def _meta(self) -> Dict[str, Any]:
        path = os.path.join(self.dir, "meta.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                return pickle.load(f)
        return {}

    def _set_status(self, status: str, error: Optional[str] = None):
        meta = self._meta()
        meta.update({"status": status, "error": error,
                     "updated_at": time.time()})
        meta.setdefault("created_at", time.time())
        _atomic_pickle(os.path.join(self.dir, "meta.pkl"), meta)

    def _step_path(self, step_id: str) -> str:
        return os.path.join(self.dir, f"{step_id}.pkl")

    # ---------------------------------------------------------- execution

    def execute(self) -> Any:
        self._set_status(WorkflowStatus.RUNNING)
        try:
            result = self._run_node(self.dag)
            _atomic_pickle(os.path.join(self.dir, "output.pkl"), result)
            self._set_status(WorkflowStatus.SUCCESSFUL)
            return result
        except BaseException as e:
            self._set_status(WorkflowStatus.RESUMABLE, error=repr(e))
            raise

    def _run_node(self, node: DAGNode) -> Any:
        if not isinstance(node, FunctionNode):
            raise TypeError(
                "workflows run task DAGs (fn.bind(...)); InputNode-"
                "parameterized DAGs need their inputs bound first")
        step_id = self.step_ids[id(node)]
        path = self._step_path(step_id)
        if os.path.exists(path):  # checkpointed: skip re-execution
            with open(path, "rb") as f:
                return pickle.load(f)
        args = [self._run_arg(a) for a in node._args]
        kwargs = {k: self._run_arg(v) for k, v in node._kwargs.items()}
        fn = node._fn.options(**node._options) if node._options else node._fn
        value = ray_tpu_torch.get(fn.remote(*args, **kwargs))
        _atomic_pickle(path, value)
        return value

    def _run_arg(self, arg: Any) -> Any:
        if isinstance(arg, DAGNode):
            return self._run_node(arg)
        if isinstance(arg, (list, tuple)):
            return type(arg)(self._run_arg(a) for a in arg)
        if isinstance(arg, dict):
            return {k: self._run_arg(v) for k, v in arg.items()}
        return arg


# ------------------------------------------------------------------- API #


def run(dag: FunctionNode, *, workflow_id: Optional[str] = None) -> Any:
    """Execute a DAG durably; returns the final result. Raises on step
    failure, leaving the workflow RESUMABLE."""
    from ray_tpu_torch.core import serialization

    workflow_id = workflow_id or f"wf_{int(time.time() * 1000):x}"
    runner = _WorkflowRun(workflow_id, dag)
    # cloudpickle: DAGs close over user functions/lambdas that plain
    # pickle cannot carry across a restart.
    blob = serialization.dumps(dag)
    tmp = os.path.join(runner.dir, "dag.bin.tmp")
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, os.path.join(runner.dir, "dag.bin"))
    return runner.execute()


def run_async(dag: FunctionNode, *, workflow_id: Optional[str] = None):
    """Run in a background thread; returns (workflow_id, thread)."""
    import threading

    workflow_id = workflow_id or f"wf_{int(time.time() * 1000):x}"
    t = threading.Thread(target=run, args=(dag,),
                         kwargs={"workflow_id": workflow_id}, daemon=True)
    t.start()
    return workflow_id, t


def resume(workflow_id: str) -> Any:
    """Re-run a failed/interrupted workflow; completed steps are loaded
    from their checkpoints, not re-executed."""
    from ray_tpu_torch.core import serialization

    dag_path = os.path.join(_wf_dir(workflow_id), "dag.bin")
    if not os.path.exists(dag_path):
        raise ValueError(f"no workflow {workflow_id!r}")
    with open(dag_path, "rb") as f:
        dag = serialization.loads(f.read())
    return _WorkflowRun(workflow_id, dag).execute()


def get_output(workflow_id: str) -> Any:
    path = os.path.join(_wf_dir(workflow_id), "output.pkl")
    if not os.path.exists(path):
        raise ValueError(f"workflow {workflow_id!r} has no output "
                         f"(status={get_status(workflow_id)})")
    with open(path, "rb") as f:
        return pickle.load(f)


def get_status(workflow_id: str) -> Optional[str]:
    meta_path = os.path.join(_wf_dir(workflow_id), "meta.pkl")
    if not os.path.exists(meta_path):
        return None
    with open(meta_path, "rb") as f:
        return pickle.load(f).get("status")


def list_all(status_filter: Optional[str] = None) -> List[tuple]:
    root = _storage_root()
    if not os.path.isdir(root):
        return []
    out = []
    for wid in sorted(os.listdir(root)):
        status = get_status(wid)
        if status is not None and \
                (status_filter is None or status == status_filter):
            out.append((wid, status))
    return out


def delete(workflow_id: str):
    import shutil

    shutil.rmtree(_wf_dir(workflow_id), ignore_errors=True)
