"""The port's DAG API (`.bind()` / `.execute()`, `ray_tpu_torch.dag`) and
durable workflows (`ray_tpu_torch.workflow`) against the JAX package's.

The reference's seven cases (`tests/test_dag_workflow.py`) run under both
packages, each on its own runtime (2 CPUs each, both up for the module),
and must give the same results. Workflow storage is a directory of each
package's own (`RAY_TPU_WORKFLOW_DIR`, `RAY_TPU_TORCH_WORKFLOW_DIR`).
"""

import os
from types import SimpleNamespace

import pytest

import ray_tpu
import ray_tpu.dag
import ray_tpu.workflow
import ray_tpu_torch
import ray_tpu_torch.dag
import ray_tpu_torch.workflow


def _add(a, b):
    return a + b


def _double(x):
    return 2 * x


def _bump_counter(path, value):
    with open(path, "a") as f:
        f.write("x")
    return value


def _fail_until_flag(path, value):
    if not os.path.exists(path):
        raise RuntimeError("transient failure (flag missing)")
    return value + 1


def _package(rt, dag, workflow, dir_env):
    return SimpleNamespace(
        rt=rt, InputNode=dag.InputNode, workflow=workflow, dir_env=dir_env,
        add=rt.remote(_add), double=rt.remote(_double),
        bump_counter=rt.remote(_bump_counter),
        fail_until_flag=rt.remote(_fail_until_flag))


PACKAGES = {
    "ray_tpu": _package(ray_tpu, ray_tpu.dag, ray_tpu.workflow,
                        "RAY_TPU_WORKFLOW_DIR"),
    "ray_tpu_torch": _package(ray_tpu_torch, ray_tpu_torch.dag,
                              ray_tpu_torch.workflow,
                              "RAY_TPU_TORCH_WORKFLOW_DIR"),
}


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    ray_tpu.init(num_cpus=2)
    ray_tpu_torch.init(num_cpus=2)
    for pkg in PACKAGES.values():   # the workers' cold start, once
        assert pkg.rt.get([pkg.double.remote(i) for i in range(2)]) == [0, 2]
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _both(case, tmp_path, monkeypatch):
    """case(pkg, dir) under each package, in a directory of its own."""
    out = {}
    for name, pkg in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        monkeypatch.setenv(pkg.dir_env, str(d / "workflows"))
        out[name] = case(pkg, d)
    assert out["ray_tpu_torch"] == out["ray_tpu"]
    return out["ray_tpu_torch"]


def test_dag_bind_execute(tmp_path, monkeypatch):
    def case(p, d):
        dag = p.add.bind(p.double.bind(3), p.double.bind(4))
        return p.rt.get(dag.execute())

    assert _both(case, tmp_path, monkeypatch) == 14


def test_dag_shared_subtree_runs_once(tmp_path, monkeypatch):
    def case(p, d):
        counter = str(d / "count")
        shared = p.bump_counter.bind(counter, 5)
        dag = p.add.bind(shared, shared)  # diamond: shared node runs once
        return p.rt.get(dag.execute()), open(counter).read()

    assert _both(case, tmp_path, monkeypatch) == (10, "x")


def test_dag_input_node(tmp_path, monkeypatch):
    def case(p, d):
        with p.InputNode() as inp:
            dag = p.add.bind(p.double.bind(inp), 1)
        return p.rt.get(dag.execute(10)), p.rt.get(dag.execute(0))

    assert _both(case, tmp_path, monkeypatch) == (21, 1)


def test_dag_options(tmp_path, monkeypatch):
    def case(p, d):
        dag = p.double.options(name="custom").bind(21)
        return p.rt.get(dag.execute()), repr(dag)

    assert _both(case, tmp_path, monkeypatch) == (42, "FunctionNode(_double)")


def test_workflow_run_and_output(tmp_path, monkeypatch):
    def case(p, d):
        wf = p.workflow
        dag = p.add.bind(p.double.bind(10), 2)
        return (wf.run(dag, workflow_id="wf1"), wf.get_status("wf1"),
                wf.get_output("wf1"), wf.list_all(),
                sorted(os.listdir(d / "workflows" / "wf1")))

    result, status, output, listed, files = _both(case, tmp_path,
                                                  monkeypatch)
    assert (result, status, output) == (22, "SUCCESSFUL", 22)
    assert listed == [("wf1", "SUCCESSFUL")]
    assert files == ["dag.bin", "meta.pkl", "output.pkl",
                     "step_0000__double.pkl", "step_0001__add.pkl"]


def test_workflow_resume_skips_completed_steps(tmp_path, monkeypatch):
    def case(p, d):
        wf = p.workflow
        counter, flag = str(d / "exec_count"), str(d / "flag")
        dag = p.fail_until_flag.bind(flag, p.bump_counter.bind(counter, 7))
        with pytest.raises(Exception):
            wf.run(dag, workflow_id="wf2")
        failed = (wf.get_status("wf2"), open(counter).read())
        open(flag, "w").write("go")
        resumed = wf.resume("wf2")
        # The checkpointed first step was NOT re-executed on resume.
        return failed, resumed, open(counter).read(), wf.get_status("wf2")

    assert _both(case, tmp_path, monkeypatch) == (
        ("RESUMABLE", "x"), 8, "x", "SUCCESSFUL")


def test_workflow_delete(tmp_path, monkeypatch):
    def case(p, d):
        wf = p.workflow
        wf.run(p.double.bind(1), workflow_id="wf3")
        before = wf.get_status("wf3")
        wf.delete("wf3")
        return before, wf.get_status("wf3"), wf.list_all()

    assert _both(case, tmp_path, monkeypatch) == ("SUCCESSFUL", None, [])
