"""raylint of the port: whole-program rules, mutations, cache and CLI.

RL014-RL016 parity: every `lint_tree` fixture of the JAX package's
test_raylint_project.py (RL014, RL015, RL016) runs over a tmp_path tree in
both engines, the port's with `ray_tpu` rewritten to `ray_tpu_torch`, and
both must report the same findings.  RL023 and RL024 (the torch family's
whole-program rules) get known-bad / known-good twins.  The mutation
controls lint a COPY of the live port with one real line changed and
assert the rule fires — proof that the rules resolve the port's own code,
not just fixtures.  Then the incremental cache (the port keeps its own,
`.raylint_torch_cache/`, so the two linters never evict each other) and
the CLI's exit-code contract.
"""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
import time

import pytest

import test_raylint_project as ref_tests
import torch_lint_fixtures as twins
from ray_tpu.analysis import engine as ref_engine
from ray_tpu_torch.analysis import engine
from ray_tpu_torch.analysis.engine import lint_file, lint_paths_full

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ray_tpu_torch")
FRAMEWORK = [f"RL{n:03d}" for n in range(1, 20) if n != 6]


def to_port(src: str) -> str:
    return re.sub(r"\bray_tpu\b", "ray_tpu_torch", src)


def write_tree(root, files, port=False):
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        src = textwrap.dedent(src)
        p.write_text(to_port(src) if port else src)
    return root


def lint_tree(tmp_path, files, rules=None):
    root = write_tree(tmp_path, files)
    return lint_paths_full([str(root)], rules).findings


def rule_ids(findings):
    return [f.rule for f in findings]


# --------------------------------------------------- RL014-RL016 parity


def _reference_trees():
    """(case id, {path: source}) for every `lint_tree(tmp_path, {...})`
    call in the reference's RL014/RL015/RL016 tests, module constants
    resolved."""
    with open(ref_tests.__file__, "r", encoding="utf-8") as f:
        tree = ast.parse(f.read())
    cases = []
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef)
                and re.match(r"test_rl01[456]_", fn.name)):
            continue
        calls = [c for c in ast.walk(fn) if isinstance(c, ast.Call)
                 and getattr(c.func, "id", "") == "lint_tree"
                 and len(c.args) > 1 and isinstance(c.args[1], ast.Dict)]
        for i, call in enumerate(sorted(calls, key=lambda c: c.lineno)):
            files = {}
            for k, v in zip(call.args[1].keys, call.args[1].values):
                files[k.value] = v.value if isinstance(v, ast.Constant) \
                    else getattr(ref_tests, v.id)
            cases.append((f"{fn.name}-{i}", files))
    return cases


PROJECT_TREES = _reference_trees()


def test_project_parity_covers_every_reference_tree():
    rules = {case[:len("test_rl01x")] for case, _ in PROJECT_TREES}
    assert rules == {"test_rl014", "test_rl015", "test_rl016"}
    assert len(PROJECT_TREES) == 22


@pytest.mark.parametrize("case,files", PROJECT_TREES,
                         ids=[c for c, _ in PROJECT_TREES])
def test_project_rule_parity(tmp_path, case, files):
    root = tmp_path / "tree"
    write_tree(root, files)
    want = ref_engine.lint_paths_full([str(root)], FRAMEWORK).findings
    shutil.rmtree(root)
    write_tree(root, files, port=True)
    got = lint_paths_full([str(root)], FRAMEWORK).findings
    assert [f.as_dict() for f in got] == [f.as_dict() for f in want]


# ------------------------------------------------------------------ RL023

RL023_MESH = """
    from ray_tpu_torch.parallel.mesh import MeshSpec

    SPEC = MeshSpec({"dp": 2, "tp": 4})
"""

RL023_BAD_RULES = """
    AXIS_RULES = (
        ("batch", "dp"),
        ("mlp", "model"),
    )
"""

RL023_GOOD_RULES = """
    AXIS_RULES = (
        ("batch", "dp"),
        ("mlp", "tp"),
    )
"""


def test_rl023_flags_rule_onto_undeclared_axis(tmp_path):
    findings = lint_tree(tmp_path, {"pkg/mesh.py": RL023_MESH,
                                    "pkg/rules.py": RL023_BAD_RULES},
                         rules=["RL023"])
    assert rule_ids(findings) == ["RL023"]
    assert findings[0].line == 4 and findings[0].path.endswith("rules.py")
    assert "'mlp'" in findings[0].message and "'model'" in findings[0].message


def test_rl023_quiet_on_declared_axes(tmp_path):
    assert lint_tree(tmp_path, {"pkg/mesh.py": RL023_MESH,
                                "pkg/rules.py": RL023_GOOD_RULES},
                     rules=["RL023"]) == []


def test_rl023_flags_logical_axis_no_rule_maps(tmp_path):
    use = """
        from ray_tpu_torch.parallel.sharding import named_sharding

        def place(mesh):
            return named_sharding(mesh, "batch", "mlpp")
    """
    findings = lint_tree(tmp_path, {"pkg/mesh.py": RL023_MESH,
                                    "pkg/rules.py": RL023_GOOD_RULES,
                                    "pkg/use.py": use}, rules=["RL023"])
    assert rule_ids(findings) == ["RL023"]
    assert "'mlpp'" in findings[0].message
    fixed = use.replace('"mlpp"', '"mlp"')
    assert lint_tree(tmp_path, {"pkg/use.py": fixed},
                     rules=["RL023"]) == []


def test_rl023_shard_params_dict_and_rules_override(tmp_path):
    use = """
        from ray_tpu_torch.parallel.sharding import shard_params

        def place(params, mesh):
            return shard_params(params, mesh, {"w": ("embed", "mlp")},
                                rules={"embed": "fsdp"})
    """
    findings = lint_tree(tmp_path, {"pkg/mesh.py": RL023_MESH,
                                    "pkg/rules.py": RL023_GOOD_RULES,
                                    "pkg/use.py": use}, rules=["RL023"])
    # "embed" is mapped (by the override), onto fsdp, which no mesh has.
    assert rule_ids(findings) == ["RL023"]
    assert "'fsdp'" in findings[0].message


def test_rl023_flags_partition_spec_over_undeclared_axis(tmp_path):
    findings = lint_tree(tmp_path, {
        "pkg/mesh.py": RL023_MESH,
        "pkg/model.py": """
            from ray_tpu_torch.parallel.sharding import PartitionSpec as P

            RULES = (
                (r"embed$", P("tp")),
                (r"wq_weight$", P(None, "model")),
            )
        """}, rules=["RL023"])
    assert rule_ids(findings) == ["RL023"]
    assert "wq_weight$" in findings[0].message


def test_rl023_shardspec_and_meshspec_variable_declare(tmp_path):
    findings = lint_tree(tmp_path, {
        "pkg/gang.py": """
            from ray_tpu_torch.shardgroup import ShardSpec
            from ray_tpu_torch.parallel.mesh import MeshSpec

            SPEC = ShardSpec(tp=4, pp=1)

            def mesh(sp):
                axes = {"dp": 2}
                axes["sp"] = sp
                return MeshSpec(axes)
        """,
        "pkg/rules.py": """
            AXIS_RULES = (("mlp", "tp"), ("seq", "sp"), ("stage", "pp"))
        """}, rules=["RL023"])
    assert rule_ids(findings) == ["RL023"]   # pp=1 declares nothing
    assert "'pp'" in findings[0].message


def test_rl023_axis_check_needs_a_declared_mesh(tmp_path):
    assert lint_tree(tmp_path, {"pkg/rules.py": RL023_BAD_RULES},
                     rules=["RL023"]) == []


# ------------------------------------------------------------------ RL024


def test_rl024_flags_fork_after_cuda_init(tmp_path):
    findings = lint_tree(tmp_path, {"pkg/launch.py": twins.RL024_BAD},
                         rules=["RL024"])
    assert rule_ids(findings) == ["RL024"]
    assert findings[0].line == 18
    assert "spawn" in findings[0].message and "launch" in findings[0].message


def test_rl024_quiet_on_spawn_context(tmp_path):
    assert lint_tree(tmp_path, {"pkg/launch.py": twins.RL024_GOOD},
                     rules=["RL024"]) == []


@pytest.mark.parametrize("fork,flagged", [
    ("os.fork()", True),
    ("multiprocessing.Process(target=print).start()", True),
    ("multiprocessing.get_context().Pool(2)", True),
    ("ProcessPoolExecutor(2)", True),
    ('ProcessPoolExecutor(2, mp_context=multiprocessing.get_context('
     '"spawn"))', False),
])
def test_rl024_fork_shapes(tmp_path, fork, flagged):
    src = ("import multiprocessing\nimport os\n"
           "from concurrent.futures import ProcessPoolExecutor\n\n"
           "import torch\n\n\ndef go(x):\n    x = x.cuda()\n"
           f"    {fork}\n")
    findings = lint_tree(tmp_path, {"pkg/go.py": src}, rules=["RL024"])
    assert [f.line for f in findings] == ([10] if flagged else [])


FORGE_TREE = {
    "pkg/__init__.py": "",
    "pkg/config.py": """
        _TABLE = {}

        def _flag(name, type_, default, doc=""):
            _TABLE[name] = default

        _flag("worker_forge_preimports", str, "pkg.worker,numpy",
              "modules the forge template preimports")
    """,
    "pkg/worker.py": """
        from pkg import helpers

        def main():
            return helpers.table()
    """,
}


def test_rl024_flags_cuda_at_import_of_a_preimported_module(tmp_path):
    findings = lint_tree(tmp_path, dict(FORGE_TREE, **{
        "pkg/helpers.py": """
            import torch

            _DEVICE = torch.zeros(1, device="cuda").device

            def table():
                return {}
        """}), rules=["RL024"])
    assert rule_ids(findings) == ["RL024"]
    assert findings[0].path.endswith("helpers.py") and findings[0].line == 4
    assert "pkg.worker" in findings[0].message


def test_rl024_quiet_on_lazy_init_or_unimported_module(tmp_path):
    assert lint_tree(tmp_path, dict(FORGE_TREE, **{
        "pkg/helpers.py": """
            import torch

            HAVE_CUDA = torch.cuda.is_available()

            def table():
                return {"dev": torch.zeros(1, device="cuda").device}
        """,
        "pkg/tools.py": """
            import torch

            torch.cuda.init()
        """}), rules=["RL024"]) == []


# ------------------------------------------- mutation negative-controls


def copy_package(tmp_path) -> str:
    dst = str(tmp_path / "ray_tpu_torch")
    shutil.copytree(PKG, dst, ignore=shutil.ignore_patterns(
        "__pycache__", ".raylint_torch_cache", "_native", "*.so", "csrc"))
    return dst


def mutate(root: str, rel: str, needle: str, replacement: str) -> None:
    path = os.path.join(root, rel)
    with open(path, "r", encoding="utf-8") as f:
        src = f.read()
    assert needle in src, f"mutation target vanished from {rel}: {needle!r}"
    with open(path, "w", encoding="utf-8") as f:
        f.write(src.replace(needle, replacement, 1))


MUTATIONS = {
    # direct_call is the task fast path: core/direct_task.py pushes
    # specs at it, so dropping the registration leaves its calls
    # unregistered.
    "RL014": ("core/worker.py",
              'self.direct_server.register("direct_call", '
              'self._handle_direct_call)', "pass", '"direct_call"'),
    "RL015": ("core/config.py",
              '_flag("rpc_call_timeout_s", float, 120.0, '
              '"Default RPC call timeout")', "", "rpc_call_timeout_s"),
    "RL016": ("tenancy/admission.py",
              "self._queues: Dict[tuple, Deque[_Waiter]] = {}  "
              "# raylint: confine=loop",
              "self._queues: Dict[tuple, Deque[_Waiter]] = {}", "_queues"),
    # A debugging assert on the decode positions: bool() of a device
    # tensor on every decode step.
    "RL020": ("models/llama.py",
              "        for blk, layer_cache in zip(self.layers, cache):",
              "        assert (positions >= 0).all()\n"
              "        for blk, layer_cache in zip(self.layers, cache):",
              "'decode'"),
    # The rollout's per-step copy is the env-step contract and carries
    # the reference's reasoned suppression; without it RL021 fires.
    "RL021": ("rllib/rollout.py",
              "host = {k: v.cpu().numpy() for k, v in out.items()}  "
              "# raylint: disable=RL021 — per-step sync is the env-step "
              "contract",
              "host = {k: v.cpu().numpy() for k, v in out.items()}",
              "'sample'"),
    # A slice of the paged arena kept across its in-place write and read
    # after it.
    "RL022": ("models/llama.py",
              "    k_flat.index_copy_(0, flat, kw.reshape(-1, kvh, hd))\n",
              "    k_prev = k_flat[flat]\n"
              "    k_flat.index_copy_(0, flat, kw.reshape(-1, kvh, hd))\n"
              "    k_prev = k_prev.float()\n", "k_prev"),
    "RL023": ("parallel/sharding.py", '    ("mlp", "tp"),',
              '    ("mlp", "tensor"),', "'tensor'"),
    # CUDA initialised at import of the module the forge preimports.
    "RL024": ("core/worker.py",
              "from ray_tpu_torch.core import serialization\n",
              "import torch\ntorch.cuda.init()\n"
              "from ray_tpu_torch.core import serialization\n",
              "ray_tpu_torch.core.worker"),
}


@pytest.mark.parametrize("rid", sorted(MUTATIONS))
def test_mutation_of_live_port_code_fires(tmp_path, rid):
    rel, needle, replacement, marker = MUTATIONS[rid]
    # The unmutated port lints clean (test_torch_raylint.py's
    # test_package_clean), so what fires here is the mutation's.
    root = copy_package(tmp_path)
    mutate(root, rel, needle, replacement)
    after = [f for f in lint_paths_full([root], [rid]).findings
             if marker in f.message]
    assert after, f"{rid} did not notice the mutation of {rel}"


def test_mutation_cuda_init_in_a_module_the_worker_imports(tmp_path):
    # core/ids.py is not in the preimport list: the worker pulls it in.
    root = copy_package(tmp_path)
    mutate(root, "core/ids.py", "import threading\n",
           "import threading\n\nimport torch\n_DEV = torch.ones(1).cuda()\n")
    findings = lint_paths_full([root], ["RL024"]).findings
    assert [os.path.basename(f.path) for f in findings] == ["ids.py"]
    assert "imported through ray_tpu_torch.core.worker" in \
        findings[0].message


def test_project_rules_see_whole_package_from_subset_paths():
    res = lint_paths_full([os.path.join(PKG, "core", "worker.py")],
                          ["RL014", "RL024"])
    assert res.findings == [], [f.render() for f in res.findings]
    res = lint_paths_full([os.path.join(PKG, "parallel")], ["RL015",
                                                            "RL023"])
    assert res.findings == [], [f.render() for f in res.findings]


# --------------------------------------------------- incremental cache


def test_cache_dirs_are_apart():
    assert engine.CACHE_DIR_DEFAULT == ".raylint_torch_cache"
    assert engine.CACHE_DIR_DEFAULT != ref_engine.CACHE_DIR_DEFAULT


def test_incremental_subset_run_does_not_evict_cache(tmp_path):
    cache_dir = str(tmp_path / "cache")
    root = write_tree(tmp_path, {
        "pkg/__init__.py": "",
        "pkg/server.py": ref_tests.RL014_SERVER,
        "pkg/client.py": """
            def f(c):
                c.call("get_thing", {})
                c.call_raw("blob_get", b"x")
                return c.call("client_hello")
        """,
    })
    full = lint_paths_full([str(root)], incremental=True,
                           cache_dir=cache_dir)
    assert full.findings == [] and full.cache_misses == 3
    sub = lint_paths_full([str(root / "pkg" / "client.py")],
                          incremental=True, cache_dir=cache_dir)
    assert sub.findings == []
    again = lint_paths_full([str(root)], incremental=True,
                            cache_dir=cache_dir)
    assert again.cache_misses == 0, "subset run evicted unrelated entries"


def test_incremental_warm_run_is_identical_and_fast(tmp_path):
    cache_dir = str(tmp_path / "cache")
    paths = [os.path.join(PKG, "core"), os.path.join(PKG, "models"),
             os.path.join(PKG, "inference")]
    t0 = time.perf_counter()
    cold = lint_paths_full(paths, incremental=True, cache_dir=cache_dir)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm = lint_paths_full(paths, incremental=True, cache_dir=cache_dir)
    warm_s = time.perf_counter() - t0
    assert warm.cache_misses == 0 and warm.cache_hits == cold.cache_misses
    assert [f.as_dict() for f in warm.findings] == \
        [f.as_dict() for f in cold.findings]
    # scripts/gate.sh's bound for the reference is 25% of the cold run;
    # 50% here keeps the check meaningful on a loaded host.
    assert warm_s < 0.5 * cold_s, (cold_s, warm_s)


def test_incremental_detects_edit_and_reanalyzes_one_file(tmp_path):
    cache_dir = str(tmp_path / "cache")
    client = ('def f(c):\n    c.call_raw("blob_get", b"x")\n'
              '    c.call("client_hello")\n'
              '    return c.call("{}", {{}})\n')
    root = write_tree(tmp_path, {
        "pkg/server.py": ref_tests.RL014_SERVER,
        "pkg/client.py": client.format("get_thing"),
    })
    cold = lint_paths_full([str(root)], incremental=True,
                           cache_dir=cache_dir)
    assert cold.findings == []
    (root / "pkg/client.py").write_text(client.format("get_thingg"))
    warm = lint_paths_full([str(root)], ["RL014"], incremental=True,
                           cache_dir=cache_dir)
    assert warm.cache_misses == 1 and warm.cache_hits == 1
    assert any("get_thingg" in f.message for f in warm.findings)


def test_incremental_extract_only_change_updates_rl023(tmp_path):
    """An edit that only changes a file's `torch_extract` section (one
    rule-table axis — no per-file rule cares) flows through the cached
    summaries into the RL023 join."""
    cache_dir = str(tmp_path / "cache")
    rules = 'AXIS_RULES = (("mlp", "{}"),)\n'
    root = write_tree(tmp_path, {"pkg/mesh.py": RL023_MESH})
    (root / "pkg" / "rules.py").write_text(rules.format("tp"))
    cold = lint_paths_full([str(root)], incremental=True,
                           cache_dir=cache_dir)
    assert cold.findings == [] and cold.cache_misses == 2
    (root / "pkg" / "rules.py").write_text(rules.format("model"))
    warm = lint_paths_full([str(root)], incremental=True,
                           cache_dir=cache_dir)
    assert warm.cache_misses == 1 and warm.cache_hits == 1
    assert any(f.rule == "RL023" and "'model'" in f.message
               for f in warm.findings)


def test_incremental_cache_invalidates_on_rule_change(tmp_path, monkeypatch):
    cache_dir = str(tmp_path / "cache")
    root = write_tree(tmp_path, {"pkg/a.py": "x = 1\n"})
    cold = lint_paths_full([str(root)], incremental=True,
                           cache_dir=cache_dir)
    assert cold.cache_misses == 1
    monkeypatch.setattr(engine, "_tool_fingerprint", lambda: "changed")
    rerun = lint_paths_full([str(root)], incremental=True,
                            cache_dir=cache_dir)
    assert rerun.cache_misses == 1, "stale cache survived a rule change"


def test_both_linters_keep_their_caches_in_one_cwd(tmp_path, monkeypatch):
    """The JAX package's linter and the port's, run in turn from one
    directory with their default cache dirs: each warm run is all hits,
    so neither run threw the other's cache away."""
    root = write_tree(tmp_path / "src", {
        "pkg/__init__.py": "",
        "pkg/server.py": ref_tests.RL014_SERVER,
        "pkg/client.py": 'def f(c):\n    return c.call("get_thing", {})\n',
    })
    monkeypatch.chdir(tmp_path)
    linters = (ref_engine.lint_paths_full, lint_paths_full)
    assert [lint([str(root)], incremental=True).cache_misses
            for lint in linters] == [3, 3]
    for _ in range(2):
        for lint in linters:
            warm = lint([str(root)], incremental=True)
            assert warm.cache_misses == 0 and warm.cache_hits == 3
    assert sorted(os.listdir(tmp_path)) == [
        ".raylint_cache", ".raylint_torch_cache", "src"]


# -------------------------------------------------- CLI contract: SARIF,
# exit codes, unused suppressions, timings


def run_cli(args, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.analysis", *args],
        capture_output=True, text=True, cwd=cwd, env=env)


def test_cli_sarif_output_and_exit_codes(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent("""
        import threading

        def spawn():
            threading.Thread(target=print).start()
    """))
    proc = run_cli([str(bad), "--format", "sarif"])
    assert proc.returncode == 1
    doc = json.loads(proc.stdout)
    assert doc["version"] == "2.1.0"
    run = doc["runs"][0]
    assert run["tool"]["driver"]["name"] == "raylint"
    results = run["results"]
    assert results and results[0]["ruleId"] == "RL005"
    loc = results[0]["locations"][0]["physicalLocation"]
    assert loc["region"]["startLine"] == 5
    assert loc["artifactLocation"]["uri"].endswith("bad.py")
    rules_meta = {r["id"] for r in run["tool"]["driver"]["rules"]}
    assert {"RL001", "RL014", "RL017",
            "RL020", "RL021", "RL022", "RL023", "RL024"} <= rules_meta
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    assert run_cli([str(good), "--format", "sarif"]).returncode == 0
    assert run_cli([str(good), "--rules", "RL999"]).returncode == 2


def test_cli_json_output(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(twins.RL020_BAD))
    proc = run_cli([str(bad), "--json"])
    assert proc.returncode == 1
    assert [(f["rule"], f["line"]) for f in json.loads(proc.stdout)] == [
        ("RL020", 6)]


def test_cli_retired_rl006_errors_with_pointer(tmp_path):
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    proc = run_cli([str(good), "--rules", "RL006"])
    assert proc.returncode == 2
    assert "retired" in proc.stderr and "RL020" in proc.stderr


def test_cli_unknown_rule_hints_at_catalog(tmp_path):
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    proc = run_cli([str(good), "--rules", "RL999"])
    assert proc.returncode == 2
    assert "unknown rule" in proc.stderr and "--list-rules" in proc.stderr


def test_cli_missing_path_is_a_usage_error(tmp_path):
    assert run_cli([str(tmp_path / "nowhere.py")]).returncode == 2


def test_cli_list_rules_catalog():
    proc = run_cli(["--list-rules"])
    assert proc.returncode == 0
    for rid in ("RL001", "RL014", "RL020", "RL021",
                "RL022", "RL023", "RL024"):
        assert rid in proc.stdout, rid
    assert "device-value-control-flow" in proc.stdout
    assert "cuda-before-fork" in proc.stdout
    assert "[file]" in proc.stdout and "[project]" in proc.stdout
    assert "superseded by RL020" in proc.stdout


def test_cli_unused_suppression_report(tmp_path):
    mod = tmp_path / "mod.py"
    mod.write_text(textwrap.dedent("""
        import threading

        def spawn():
            threading.Thread(target=print).start()  # raylint: disable=RL005

        def clean():
            return 1  # raylint: disable=RL002
    """))
    proc = run_cli([str(mod), "--report-unused-suppressions"])
    assert proc.returncode == 1
    assert "unused suppression of RL002" in proc.stderr
    assert "RL005" not in proc.stderr
    proc = run_cli([str(mod), "--report-unused-suppressions",
                    "--rules", "RL005"])
    assert proc.returncode == 2


def test_cli_rules_subset_still_reports_syntax_errors(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def broken(:\n")
    proc = run_cli([str(bad), "--rules", "RL001"])
    assert proc.returncode == 1
    assert "RL000" in proc.stdout


def test_cli_incremental_and_timings(tmp_path):
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    proc = run_cli([str(good), "--incremental", "--timings"], cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "raylint timings" in proc.stderr and "RL023" in proc.stderr
    assert "raylint cache: 0 unchanged, 1 analyzed" in proc.stderr
    assert os.path.isfile(tmp_path / ".raylint_torch_cache" / "cache.json")


def test_cli_sleep_report(tmp_path):
    mod = tmp_path / "sleepy.py"
    mod.write_text(textwrap.dedent("""
        import time

        def test_poll():
            for _ in range(20):
                time.sleep(1.0)
    """))
    proc = run_cli(["--sleep-report", "--json", str(mod)])
    assert proc.returncode == 0
    rows = {r["function"]: r["sleep_s"] for r in json.loads(proc.stdout)}
    assert rows["test_poll"] == pytest.approx(20.0)


def test_suppressions_line_above_and_file_wide(tmp_path):
    src = """
        # raylint: disable-file=RL020
        import torch

        def decode_step(x: torch.Tensor, reqs):
            for r in reqs:
                # raylint: disable=RL021 — fixture
                y = x[r].item()
    """
    path = tmp_path / "s.py"
    path.write_text(textwrap.dedent(src))
    assert lint_file(str(path)) == []


def test_package_has_no_unused_suppressions():
    """Every `# raylint: disable=` comment in the port still earns its
    keep."""
    proc = run_cli(["ray_tpu_torch/", "--report-unused-suppressions"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
