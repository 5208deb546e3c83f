"""raylint of the port (ray_tpu_torch.analysis): per-file rules.

Parity first: every RL001-RL019 fixture constant of the JAX package's
raylint tests goes through both engines — the reference's as written, the
port's with the identifier `ray_tpu` rewritten to `ray_tpu_torch` — and
both must report the same (line, rule, message) findings.  Then the torch
hazard family: each of RL020-RL022 flags its known-bad twin and stays
quiet on the known-good one (the fix its message prescribes); the
reference's RL021 and RL022 fixtures get torch translations that the port
must flag at the reference's line.  RL023 and RL024 (whole-program) have
their twins in test_torch_raylint_project.py.  `test_package_clean` is the
port's lint contract: zero unsuppressed findings over ray_tpu_torch/.
"""

import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

import test_raylint as ref_tests
import test_raylint_project as ref_project_tests
import torch_lint_fixtures as twins
from ray_tpu.analysis.engine import lint_file as ref_lint_file
from ray_tpu_torch.analysis import PROJECT_RULES, RULES
from ray_tpu_torch.analysis.engine import lint_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the framework rules both packages share (RL006 is retired in both).
FRAMEWORK = [f"RL{n:03d}" for n in range(1, 20) if n != 6]


def to_port(src: str) -> str:
    """A reference fixture as port code: the package identifier rewritten
    (imports, and calls such as `ray_tpu.get`)."""
    return re.sub(r"\bray_tpu\b", "ray_tpu_torch", src)


def lint_src(tmp_path, src, rules=None, name="snippet.py"):
    path = tmp_path / name
    path.write_text(textwrap.dedent(src))
    return lint_file(str(path), rule_ids=rules)


def rule_ids(findings):
    return [f.rule for f in findings]


def triples(findings):
    return [(f.line, f.rule, f.message) for f in findings]


def _framework_fixtures():
    names = []
    for mod in (ref_tests, ref_project_tests):
        for name, value in sorted(vars(mod).items()):
            m = re.match(r"RL0(\d\d)_", name)
            if m and isinstance(value, str) and \
                    f"RL0{m.group(1)}" in FRAMEWORK and \
                    f"RL0{m.group(1)}" in RULES:
                names.append((mod.__name__, name))
    return names


FRAMEWORK_FIXTURES = _framework_fixtures()


def test_parity_covers_every_framework_fixture_constant():
    # 69 constants of test_raylint.py (RL001-RL013, RL018, RL019) and the
    # four RL017 ones of test_raylint_project.py.
    assert len(FRAMEWORK_FIXTURES) == 73
    assert {n[:5] for _, n in FRAMEWORK_FIXTURES} == {
        "RL001", "RL002", "RL003", "RL004", "RL005", "RL007", "RL008",
        "RL009", "RL010", "RL011", "RL012", "RL013", "RL017", "RL018",
        "RL019"}


@pytest.mark.parametrize("module,name", FRAMEWORK_FIXTURES,
                         ids=[n for _, n in FRAMEWORK_FIXTURES])
def test_framework_rule_parity(tmp_path, module, name):
    src = textwrap.dedent(getattr(sys.modules[module], name))
    ref_path = tmp_path / "ref" / "snippet.py"
    port_path = tmp_path / "port" / "snippet.py"
    for path, text in ((ref_path, src), (port_path, to_port(src))):
        path.parent.mkdir()
        path.write_text(text)
    want = ref_lint_file(str(ref_path), rule_ids=FRAMEWORK,
                         display_path="snippet.py")
    got = lint_file(str(port_path), rule_ids=FRAMEWORK,
                    display_path="snippet.py")
    assert triples(got) == triples(want)
    if "_BAD" in name:
        assert want, f"{name} is a known-bad fixture: the reference flags it"


def test_rl019_getter_is_the_ports(tmp_path):
    # The bulk-get shape names the port's getter; `ray.get` stays.
    src = """
        import ray_tpu_torch

        def collect(refs):
            return ray_tpu_torch.get([r for r in refs])

        def collect_ray(refs):
            return ray.get([r for r in refs])
    """
    findings = lint_src(tmp_path, src, rules=["RL019"])
    assert [f.line for f in findings] == [5, 8]


def _tree(root, files):
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))


@pytest.mark.parametrize("rid,pkg,scoped_in", [
    ("RL004", "core", True), ("RL004", "data", False),
    ("RL011", "serve", True), ("RL011", "models", False),
    ("RL013", "data", True), ("RL013", "core", False),
])
def test_package_scope_keyed_on_the_port(tmp_path, rid, pkg, scoped_in):
    # In-tree files are checked only in their rule's subpackages of the
    # directory named ray_tpu_torch; a tree named ray_tpu is out of tree
    # for the port (always checked), as ray_tpu_torch is for the
    # reference.
    bad = {"RL004": ref_tests.RL004_BAD,
           "RL011": ref_tests.RL011_BAD_NO_EVICTION,
           "RL013": ref_tests.RL013_BAD_NO_BOUND}[rid]
    for top in ("ray_tpu_torch", "ray_tpu"):
        _tree(tmp_path, {f"{top}/__init__.py": "",
                         f"{top}/{pkg}/__init__.py": "",
                         f"{top}/{pkg}/mod.py": bad})
    port_in = lint_file(str(tmp_path / "ray_tpu_torch" / pkg / "mod.py"),
                        rule_ids=[rid])
    port_out = lint_file(str(tmp_path / "ray_tpu" / pkg / "mod.py"),
                         rule_ids=[rid])
    assert bool(port_in) == scoped_in
    assert rule_ids(port_out) == [rid]


# ------------------------------------------------------------------ RL020


def test_rl020_flags_branch_on_device_value(tmp_path):
    findings = lint_src(tmp_path, twins.RL020_BAD, rules=["RL020"])
    assert rule_ids(findings) == ["RL020"]
    assert findings[0].line == 6
    assert "train_step" in findings[0].message


def test_rl020_quiet_on_device_side_select(tmp_path):
    assert lint_src(tmp_path, twins.RL020_GOOD, rules=["RL020"]) == []


# The reference's traced-`if` twins, in eager torch.
RL020_TRACED_IF = """
    import torch


    def step(x: torch.Tensor):
        if x.sum() > 0:
            return x * 2
        return x
"""

RL020_GOOD_SHAPE_IF = """
    import torch


    def step(x: torch.Tensor):
        if x.shape[0] > 1:
            return torch.where(x > 0, x * 2, x)
        return x
"""


def test_rl020_translation_flagged_at_the_references_line(tmp_path):
    ref = tmp_path / "ref.py"
    ref.write_text(textwrap.dedent(ref_tests.RL020_TRACED_IF))
    want = [f.line for f in ref_lint_file(str(ref), rule_ids=["RL020"])]
    got = lint_src(tmp_path, RL020_TRACED_IF, rules=["RL020"])
    assert [f.line for f in got] == want == [6]


def test_rl020_quiet_on_shape_based_if(tmp_path):
    # Shapes are host metadata: branching on them never syncs.
    assert lint_src(tmp_path, RL020_GOOD_SHAPE_IF, rules=["RL020"]) == []


@pytest.mark.parametrize("body,kind", [
    ("n = int(logits.argmax())", "int"),
    ("assert torch.isfinite(logits).all()", "assert"),
    ("k = float(logits.max()) if True else 0.0", "float"),
    ("ok = not (logits > 0).any()", "not"),
    ("for _ in range(logits.argmax()):\n        pass", "range"),
])
def test_rl020_flags_each_implicit_sync(tmp_path, body, kind):
    src = ("import torch\n\n\ndef train_step(logits: torch.Tensor):\n"
           f"    {body}\n")
    (tmp_path / "s.py").write_text(src)
    findings = lint_file(str(tmp_path / "s.py"), rule_ids=["RL020"])
    assert rule_ids(findings) == ["RL020"]
    assert f"`{kind}`" in findings[0].message


def test_rl020_quiet_outside_per_step_code(tmp_path):
    # Factories and cold methods may sync: only per-step code is held.
    src = """
        import torch

        def make_train_step(x: torch.Tensor):
            if x.sum() > 0:
                return x
            return -x

        def save_checkpoint(x: torch.Tensor):
            return int(x.sum())
    """
    assert lint_src(tmp_path, src, rules=["RL020"]) == []


def test_rl020_leaves_loop_syncs_to_rl021(tmp_path):
    src = """
        import torch

        def decode_step(logits: torch.Tensor, reqs):
            for r in reqs:
                if logits[r] > 0:
                    pass
    """
    findings = lint_src(tmp_path, src, rules=["RL020", "RL021"])
    assert rule_ids(findings) == ["RL021"]


# ------------------------------------------------------------------ RL021

# The reference's RL021 twins, in torch: jax.jit's step becomes a module,
# np.asarray(nxt) the hoisted `.cpu()`.
RL021_BAD = """
    import torch

    step = torch.nn.Identity()

    class Engine:
        def decode_step(self, params, tokens, reqs):
            nxt = step(tokens)
            for r in reqs:
                r.out.append(int(nxt[r.slot]))
"""

RL021_GOOD = """
    import torch

    step = torch.nn.Identity()

    class Engine:
        def decode_step(self, params, tokens, reqs):
            nxt = step(tokens)
            host = nxt.cpu()
            for r in reqs:
                r.out.append(int(host[r.slot]))
"""


def test_rl021_translation_flagged_at_the_references_line(tmp_path):
    ref = tmp_path / "ref.py"
    ref.write_text(textwrap.dedent(ref_tests.RL021_BAD))
    want = [f.line for f in ref_lint_file(str(ref), rule_ids=["RL021"])]
    got = lint_src(tmp_path, RL021_BAD, rules=["RL021"])
    assert [f.line for f in got] == want == [10]
    assert "decode_step" in got[0].message


def test_rl021_quiet_on_hoisted_post_step_sync(tmp_path):
    assert lint_src(tmp_path, RL021_GOOD, rules=["RL021"]) == []
    ref = tmp_path / "ref.py"
    ref.write_text(textwrap.dedent(ref_tests.RL021_GOOD))
    assert ref_lint_file(str(ref), rule_ids=["RL021"]) == []


def test_rl021_chip_twins(tmp_path):
    findings = lint_src(tmp_path, twins.RL021_BAD, rules=["RL021"])
    assert rule_ids(findings) == ["RL021"] and findings[0].line == 9
    assert lint_src(tmp_path, twins.RL021_GOOD) == []


def test_rl021_quiet_in_cold_methods(tmp_path):
    src = RL021_BAD.replace("decode_step", "save_checkpoint")
    assert lint_src(tmp_path, src, rules=["RL021"]) == []


@pytest.mark.parametrize("sync,kind", [
    ("nxt[r].item()", ".item"), ("nxt[r].tolist()", ".tolist"),
    ("nxt.cpu()", ".cpu"), ("np.asarray(nxt)", "asarray"),
    ("bool(nxt[r])", "bool"), ("nxt.nonzero()", ".nonzero"),
    ("nxt[nxt > r]", "boolean-mask index"),
    ("torch.cuda.synchronize()", "synchronize"),
    ("nxt.to('cpu')", ".to"),
])
def test_rl021_flags_each_torch_sync(tmp_path, sync, kind):
    src = ("import numpy as np\nimport torch\n\n\n"
           "def decode_step(logits: torch.Tensor, reqs):\n"
           "    nxt = logits.argmax(-1)\n"
           "    for r in reqs:\n"
           f"        out = {sync}\n")
    (tmp_path / "s.py").write_text(src)
    findings = lint_file(str(tmp_path / "s.py"), rule_ids=["RL021"])
    assert rule_ids(findings) == ["RL021"]
    assert f"({kind})" in findings[0].message


def test_rl021_flags_sync_in_comprehension(tmp_path):
    src = """
        import torch

        def sample(out: torch.Tensor, keys):
            return {k: out[k].cpu() for k in keys}
    """
    assert rule_ids(lint_src(tmp_path, src, rules=["RL021"])) == ["RL021"]


# ------------------------------------------------------------------ RL022

# The reference's use-after-donate twins, in torch: a window of the arena
# kept across an in-place write, read where the reference read the
# donated arena.
RL022_BAD = """
    import torch


    class Engine:
        def run(self, params):
            head = self._arena[:1]
            self._arena.index_copy_(0, params, self._fresh)
            out = self.decode(params)
            return head
"""

RL022_GOOD = """
    import torch


    class Engine:
        def run(self, params):
            head = self._arena[:1].clone()
            self._arena.index_copy_(0, params, self._fresh)
            out = self.decode(params)
            return head
"""


def test_rl022_translation_flagged_at_the_references_line(tmp_path):
    ref = tmp_path / "ref.py"
    ref.write_text(textwrap.dedent(ref_tests.RL022_BAD))
    want = [f.line for f in ref_lint_file(str(ref), rule_ids=["RL022"])]
    got = lint_src(tmp_path, RL022_BAD, rules=["RL022"])
    assert [f.line for f in got] == want == [10]
    assert "index_copy_" in got[0].message and "head" in got[0].message


def test_rl022_quiet_on_clone(tmp_path):
    assert lint_src(tmp_path, RL022_GOOD, rules=["RL022"]) == []


def test_rl022_flags_read_on_one_cfg_branch(tmp_path):
    src = """
        import torch

        class Engine:
            def run(self, params, flaky):
                head = self._arena[:1]
                self._arena.index_copy_(0, params, self._fresh)
                if flaky:
                    return head
                return self._arena
    """
    assert rule_ids(lint_src(tmp_path, src, rules=["RL022"])) == ["RL022"]


def test_rl022_quiet_when_view_taken_after_the_write(tmp_path):
    src = """
        import torch

        class Engine:
            def run(self, params):
                head = self._arena[:1]
                self._arena.index_copy_(0, params, self._fresh)
                head = self._arena[:1]
                return head
    """
    assert lint_src(tmp_path, src, rules=["RL022"]) == []


def test_rl022_quiet_on_reading_the_buffer_it_wrote_through(tmp_path):
    # The paged arena's idiom: a flat view written in place and read
    # back is one buffer, not a stale window.
    src = """
        import torch

        def write(arena, idx, kv):
            flat = arena.view(-1, 8)
            flat.index_copy_(0, idx, kv)
            return flat[idx], arena
    """
    assert lint_src(tmp_path, src, rules=["RL022"]) == []


@pytest.mark.parametrize("write", [
    "torch.add(a, b, out=buf)", "buf.copy_(a)", "buf.zero_()",
    "buf.masked_fill_(a > 0, 0.0)"])
def test_rl022_flags_each_inplace_write(tmp_path, write):
    src = ("import torch\n\n\ndef f(buf, a, b):\n"
           "    v = buf.reshape(-1).narrow(0, 0, 2)\n"
           f"    {write}\n"
           "    return v\n")
    (tmp_path / "s.py").write_text(src)
    findings = lint_file(str(tmp_path / "s.py"), rule_ids=["RL022"])
    assert [f.line for f in findings] == [7]


def test_rl022_flags_parameter_view_across_optimizer_step(tmp_path):
    src = """
        import torch

        def train_step(model, opt, batch):
            w0 = model.weight[:]
            model(batch).sum().backward()
            opt.step()
            return (model.weight - w0).abs().max()
    """
    findings = lint_src(tmp_path, src, rules=["RL022"])
    assert rule_ids(findings) == ["RL022"]
    assert "optimizer.step()" in findings[0].message
    fixed = src.replace("model.weight[:]", "model.weight.detach().clone()")
    assert lint_src(tmp_path, fixed, rules=["RL022"]) == []


# ---------------------------------------------------------- whole package


def test_every_rule_has_fixture_coverage():
    # Every id of the port's catalog is named in this file or the
    # project-rule file next door.
    body = ""
    here = os.path.dirname(os.path.abspath(__file__))
    for fname in ("test_torch_raylint.py", "test_torch_raylint_project.py"):
        with open(os.path.join(here, fname), "r", encoding="utf-8") as f:
            body += f.read()
    ids = list(RULES) + list(PROJECT_RULES)
    assert set(ids) == set(FRAMEWORK) | {"RL020", "RL021", "RL022",
                                         "RL023", "RL024"}
    for rid in ids:
        assert rid in body, f"rule {rid} has no fixture test here"


def test_package_clean():
    """The port's lint contract: zero unsuppressed findings over
    ray_tpu_torch/."""
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.analysis", "ray_tpu_torch/"],
        capture_output=True, text=True, cwd=REPO)
    assert proc.returncode == 0, (
        "raylint found regressions:\n" + proc.stdout + proc.stderr)


def test_linting_imports_neither_jax_nor_the_reference(tmp_path):
    mod = tmp_path / "mod.py"
    mod.write_text(textwrap.dedent(twins.RL021_BAD))
    code = textwrap.dedent(f"""
        import json, sys
        from ray_tpu_torch.analysis import lint_paths_full
        res = lint_paths_full([{str(mod)!r}])
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu",
                                            "torch", "flax", "optax"))
        print(json.dumps({{"rules": [f.rule for f in res.findings],
                          "modules": bad}}))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    assert out == {"rules": ["RL021"], "modules": []}
