"""Self-tests for the port's lint suite, ``repro_torch.analysis``: every
rule fires exactly once on its known-bad fixture
(``tests/torch_analysis_fixtures/``), the JB and LK passes agree with
the JAX package's ``repro.analysis`` on shared inputs, the committed
baseline (``analysis_baseline_torch.json``) keeps the port clean with no
stale entry, and the CLI's exit status follows the baseline."""
import collections
import json
import os
import subprocess
import sys

import pytest

from repro.analysis import run_analysis as jax_run_analysis
from repro_torch.analysis import load_baseline, run_analysis
from repro_torch.analysis.__main__ import DEFAULT_BASELINE, DEFAULT_PATHS
from repro_torch.analysis.core import HOT_PATH_ROOTS, PUBLIC, build_index
from repro_torch.analysis.findings import dedupe_keys, split_new

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = "tests/torch_analysis_fixtures"
JAX_FIXTURES = "tests/analysis_fixtures"
# The JB fixtures' functions are hot-path roots only in these tests.
FIXTURE_ROOTS = dict(HOT_PATH_ROOTS, **{
    f"tests.torch_analysis_fixtures.{m}": PUBLIC
    for m in ("jb_bad", "jb05_bad", "jb05_host_ok")})

# rule -> (fixture file, scope it fires in)
EXPECTED = {
    "JB01": ("jb_bad.py", "jb01_item"),
    "JB02": ("jb_bad.py", "jb02_cast"),
    "JB03": ("jb_bad.py", "jb03_materialize"),
    "JB04": ("jb_bad.py", "jb04_iterate"),
    "JB05": ("jb05_bad.py", "jb05_truthiness"),
    "RT01": ("rt_bad.py", "replay_twice"),
    "RT03": ("rt_bad.py", "scaled"),
    "PT01": ("pt01_bad.py", "ToyState"),
    "PT02": ("pt02_bad.py", "ToyState"),
    "LK01": ("lk_bad.py", "Counter.reset"),
    "LK02": ("lk_bad.py", "Pending.drop_all"),
    "KW01": ("kernels/badwrap/ops.py", "badwrap"),
    "KW02": ("kernels/badwrap/ops.py", "_launch"),
    "KW03": ("kernels/badwrap/kernel.py", "badwrap_blocked"),
}


@pytest.fixture(scope="module")
def fixture_findings():
    return run_analysis([FIXTURES], repo_root=ROOT, roots=FIXTURE_ROOTS)


@pytest.fixture(scope="module")
def port_findings():
    return run_analysis(DEFAULT_PATHS, repo_root=ROOT)


def test_every_rule_fires_exactly_once(fixture_findings):
    counts = collections.Counter(f.rule for f in fixture_findings)
    assert counts == {r: 1 for r in EXPECTED}


@pytest.mark.parametrize("rule", sorted(EXPECTED))
def test_rule_fires_at_its_scope(fixture_findings, rule):
    (f,) = [f for f in fixture_findings if f.rule == rule]
    path, scope = EXPECTED[rule]
    assert (f.path, f.scope) == (f"{FIXTURES}/{path}", scope)
    assert f.line > 0 and f.message and f.hint and f.rule in f.render()


def test_rules_filter():
    only_kw = run_analysis([FIXTURES], repo_root=ROOT, rules=["KW"])
    assert {f.rule for f in only_kw} == {"KW01", "KW02", "KW03"}
    by_pass = run_analysis([FIXTURES], repo_root=ROOT,
                           rules=["kernel_hygiene"])
    assert [f.key for f in by_pass] == [f.key for f in only_kw]
    assert {f.rule for f in run_analysis(
        [FIXTURES], repo_root=ROOT, rules=["RT03"])} == {"RT03"}


def test_jb_mirrors_the_jax_pass():
    """The torch fixture mirrors tests/analysis_fixtures/jb_bad.py
    function by function: the same (rule, function) set."""
    ours = run_analysis([f"{FIXTURES}/jb_bad.py"], repo_root=ROOT,
                        rules=["JB"], roots=FIXTURE_ROOTS)
    theirs = jax_run_analysis([f"{JAX_FIXTURES}/jb_bad.py"],
                              repo_root=ROOT, rules=["JB"])
    assert {(f.rule, f.scope) for f in ours} == {
        (f.rule, f.scope) for f in theirs}
    assert len(ours) == len(theirs) == 4


def test_jb05_leaves_host_conditions_alone():
    assert run_analysis([f"{FIXTURES}/jb05_host_ok.py"], repo_root=ROOT,
                        roots=FIXTURE_ROOTS) == []


# Each place Python reads a value as a bool, on a tensor (flagged once)
# and on host metadata (not flagged).
JB05_FORMS = {
    "if": ("    if {c}:\n        y = y + 1\n", 1),
    "elif": ("    if x.shape[0] > 2:\n        y = y + 1\n"
             "    elif {c}:\n        y = y + 2\n", 1),
    "while": ("    while {c}:\n        y = y - 1\n", 1),
    "assert": ("    assert {c}\n", 1),
    "ifexp": ("    y = y if {c} else -y\n", 1),
    "and": ("    y = x.shape[0] > 1 and {c}\n", 1),
    "or": ("    y = {c} or x.shape[0] > 1\n", 1),
    "not": ("    y = not {c}\n", 1),
    "comprehension": ("    y = [v for v in range(3) if {c}]\n", 1),
}


@pytest.mark.parametrize("form", sorted(JB05_FORMS))
@pytest.mark.parametrize("cond,flagged", [
    ("x.any()", True), ("x.sum() > 0", True), ("t", True),
    ("x.sum() > x.shape[0]", True), ("t.max() < len(x)", True),
    ("x.shape[0] > 1", False), ("len(x) == 4", False),
    ("x is None", False), ("cfg.causal", False),
    ("x.dtype != t.dtype", False), ('"w_q" in x', False)])
def test_jb05_fires_on_each_bool_form(tmp_path, form, cond, flagged):
    body, n = JB05_FORMS[form]
    (tmp_path / "snip.py").write_text(
        "import torch\n\n\ndef f(x, cfg):\n"
        "    t = torch.ones(()) * x.sum()\n    y = 0\n"
        + body.format(c=cond) + "    return y\n")
    got = run_analysis(["snip.py"], repo_root=str(tmp_path),
                       roots={"snip": PUBLIC}, rules=["JB"])
    assert [f.rule for f in got] == ["JB05"] * (n if flagged else 0), got


@pytest.mark.parametrize("paths", [[f"{JAX_FIXTURES}/lk_bad.py"],
                                   ["src/repro_torch/serving"]])
def test_lk_keys_equal_the_jax_pass(paths):
    ours = run_analysis(paths, repo_root=ROOT, rules=["LK"])
    theirs = jax_run_analysis(paths, repo_root=ROOT, rules=["LK"])
    assert [f.key for f in ours] == [f.key for f in theirs]


def test_kw02_flags_an_is_available_fallback(tmp_path):
    pkg = tmp_path / "kernels" / "w"
    pkg.mkdir(parents=True)
    (pkg / "ref.py").write_text("def w_ref(x):\n    return x\n")
    (pkg / "ops.py").write_text(
        "import torch\n"
        "from kernels.w.ref import w_ref\n\n\n"
        "def w(x):\n"
        "    if not torch.cuda.is_available():\n"
        "        return w_ref(x)\n"
        "    return x\n")
    (f,) = run_analysis(["kernels"], repo_root=str(tmp_path))
    assert (f.rule, f.scope, f.detail) == ("KW02", "w", "is_available")


def test_hot_path_roots_exist():
    """Every root the table names is a function of the port, so a rename
    cannot drop a root silently; every kernel wrapper's public function
    is a root."""
    idx = build_index(["src/repro_torch"], repo_root=ROOT)
    for pattern, names in HOT_PATH_ROOTS.items():
        if names == PUBLIC:
            continue
        for n in names:
            assert f"{pattern}.{n}" in idx.hot_roots, (pattern, n)
    for op in ("linucb_score", "linucb_step", "flash_attention",
               "decode_attention", "ssd_scan"):
        assert f"repro_torch.kernels.{op}.ops.{op}" in idx.hot_roots
    assert "repro_torch.core.linucb.ucb_scores_batch" in idx.hot


def test_port_is_clean_against_the_baseline(port_findings):
    baseline = load_baseline(os.path.join(ROOT, DEFAULT_BASELINE))
    new, _ = split_new(port_findings, baseline)
    assert not new, "new findings:\n" + "\n".join(f.render() for f in new)


def test_baseline_entries_all_still_fire(port_findings):
    baseline = load_baseline(os.path.join(ROOT, DEFAULT_BASELINE))
    stale = sorted(set(baseline) - set(dedupe_keys(port_findings)))
    assert not stale, f"stale baseline entries: {stale}"
    assert all(why.strip() for why in baseline.values())


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True)


def test_cli_fails_on_a_new_finding_and_passes_once_baselined(tmp_path):
    bad = f"{FIXTURES}/lk_bad.py"
    base = str(tmp_path / "base.json")
    r = _cli(bad, "--no-baseline")
    assert r.returncode == 1 and "2 new finding(s)" in r.stdout
    assert _cli(bad, "--baseline", base, "--write-baseline").returncode == 0
    assert _cli(bad, "--baseline", base).returncode != 0   # no 'why' yet
    with open(base) as fh:
        data = json.load(fh)
    for e in data["findings"]:
        e["why"] = "fixture: deliberately bad"
    with open(base, "w") as fh:
        json.dump(data, fh)
    r = _cli(bad, "--baseline", base, "--report", str(tmp_path / "r.json"))
    assert r.returncode == 0 and "all baselined" in r.stdout, r.stdout
    with open(tmp_path / "r.json") as fh:
        assert json.load(fh)["total"] == 2


def test_cli_defaults_are_clean():
    r = _cli()
    assert r.returncode == 0, r.stdout + r.stderr
    assert "analysis clean" in r.stdout
