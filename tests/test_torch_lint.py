"""The port's repro-lint (``repro_torch.analysis.lint``) against its
fixtures, the shipped port, the JAX package's linter and the engine's run.

* every port rule id fires on ``tests/analysis_fixtures/port/bad/`` and
  none on ``port/good/`` (shaped like the port's idiom, so the good files
  double as false-positive regressions); inline markers and the baseline
  suppress;
* the shipped port lints clean against the committed (empty) baseline,
  through ``lint_paths`` and through the CLI, which lists ``ALL_RULE_IDS``
  and keeps the reference's exit codes;
* the framework-neutral families (sole-writer, phase-transitions,
  obs-hot-path, cube-boundary, ``tune-lookup-in-hot-path``) give the same
  (rule, path, line, func) as ``repro.analysis.lint`` on the reference's
  corpus ``tests/analysis_fixtures/{bad,good}``, and a finding's
  fingerprint is the reference's for the same fields;
* ``capture-safety``'s closure holds every port function the reduced
  qwen2.5-3b engine's ``_decode_impl`` (paged and gather) and
  ``extend_step`` enter on the CPU, outside ``kernels/ref.py``
  (``sys.setprofile``), and every one two CPU training steps of each family
  enter through ``TrainStep.__call__`` (the training step's body, a root);
  a host read or tensor-valued control flow seeded in a copy of
  ``DecoderLM.decode_step_paged`` is flagged.
"""
import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.analysis.findings import Finding, SourceFile
from repro_torch.analysis.lint import DEFAULT_BASELINE, lint_paths, run_rules
from repro_torch.analysis.rules import ALL_RULE_IDS, capture_safety

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
PORT = SRC / "repro_torch"
FIXTURES = REPO / "tests" / "analysis_fixtures"
PORT_FIXTURES = FIXTURES / "port"

# the families copied from the JAX package, by rule-id prefix
NEUTRAL = ["sole-writer/", "phase-transitions/", "obs-hot-path", "cube-boundary/",
           "tune-lookup-in-hot-path"]


def _sources(root: Path) -> list[SourceFile]:
    # SourceFile directly: a directory run skips analysis_fixtures
    paths = sorted(root.rglob("*.py"))
    assert paths, f"fixture dir {root} is empty"
    return [SourceFile(p, display_path=p.relative_to(REPO).as_posix()) for p in paths]


@functools.lru_cache(maxsize=None)
def _port_findings(sub: str) -> tuple:
    return tuple(run_rules(_sources(PORT_FIXTURES / sub)))


def _cli(*args, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint", *args],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


# ---------------------------------------------------------------------------
# fixture corpus
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule", ALL_RULE_IDS)
def test_rule_fires_on_port_bad_fixtures(rule):
    assert rule in {f.rule for f in _port_findings("bad")}


def test_port_bad_fixtures_fire_port_rules_only():
    assert {f.rule for f in _port_findings("bad")} == set(ALL_RULE_IDS)


def test_port_good_fixtures_lint_clean():
    findings = _port_findings("good")
    assert findings == (), [f.render() for f in findings]


def test_good_fixture_closure_follows_wrappers_not_plain_versions():
    """The clean result is not vacuous: the good steps' closure reaches the
    launch wrappers in ``kernels/ops.py``, the tunable ``attend`` and the
    tree walk, and stops at ``kernels/ref.py``."""
    reached = {(Path(p).parent.name, Path(p).name, q)
               for p, q in capture_safety.closure(_sources(PORT_FIXTURES / "good"))}
    for want in [("kernels", "ops.py", "flash_attention"), ("kernels", "ops.py", "_on_device"),
                 ("kernels", "ops.py", "paged_write"), ("kernels", "ops.py", "_launch"),
                 ("models", "step.py", "attend"), ("models", "common.py", "tree_items"),
                 ("models", "step.py", "LM._layers")]:
        assert want in reached, want
    assert not {r for r in reached if r[1] == "ref.py"}


def test_inline_suppression_covers_finding(tmp_path):
    mdir = tmp_path / "models"
    mdir.mkdir()
    text = (PORT_FIXTURES / "bad" / "models" / "step.py").read_text()
    seeded = "        idle = torch.where(~active)"
    assert seeded in text
    (mdir / "step.py").write_text(text.replace(
        seeded, seeded + "  # repro-lint: skip[graph-host-read] test"))
    findings, errors = lint_paths([mdir], baseline=None)
    assert not errors
    lines = {f.line for f in findings if f.rule == "graph-host-read"}
    # the marker covers its own line and the next, as the reference's
    assert 26 not in lines and {24, 25} <= lines
    assert {"graph-tensor-cast", "graph-tensor-branch", "graph-tensor-loop"} <= {
        f.rule for f in findings}


def test_baseline_suppresses_by_fingerprint(tmp_path):
    sdir = tmp_path / "serve"
    sdir.mkdir()
    (sdir / "mod.py").write_text(
        "import torch\n\n\nclass C:\n    def f(self):\n        with self._lock:\n"
        "            return torch.zeros(1)\n")
    findings, _ = lint_paths([sdir], baseline=None)
    assert [f.rule for f in findings] == ["no-device-work-under-lock"]
    base = tmp_path / "baseline.json"
    base.write_text(json.dumps({
        "version": 1,
        "suppressions": [{"fingerprint": findings[0].fingerprint()}],
    }))
    again, _ = lint_paths([sdir], baseline=base)
    assert again == []


# ---------------------------------------------------------------------------
# the shipped port is clean; the CLI
# ---------------------------------------------------------------------------


def test_committed_baseline_is_empty():
    assert json.loads(DEFAULT_BASELINE.read_text())["suppressions"] == []


def test_shipped_port_lints_clean_api():
    findings, errors = lint_paths([PORT], baseline=DEFAULT_BASELINE, root=REPO)
    assert not errors, errors
    assert findings == [], "\n".join(f.render() for f in findings)


def test_shipped_port_lints_clean_cli():
    proc = _cli()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout


def test_cli_lists_all_rules():
    proc = _cli("--list-rules")
    assert proc.returncode == 0
    assert proc.stdout.split() == ALL_RULE_IDS


def test_cli_exit_codes_and_baseline_update(tmp_path):
    """1 on findings, 0 once ``--update-baseline`` accepted them, 2 on a
    file that does not parse; ``--format json`` carries the fingerprints."""
    mdir = tmp_path / "models"
    shutil.copytree(PORT_FIXTURES / "bad" / "models", mdir)
    shutil.copytree(PORT_FIXTURES / "bad" / "kernels", tmp_path / "kernels")
    base = tmp_path / "baseline.json"
    proc = _cli(str(tmp_path), "--baseline", str(base), "--format", "json")
    assert proc.returncode == 1, proc.stderr
    rows = json.loads(proc.stdout)
    assert rows and all(len(r["fingerprint"]) == 16 for r in rows)
    assert _cli(str(tmp_path), "--baseline", str(base), "--update-baseline").returncode == 0
    assert len(json.loads(base.read_text())["suppressions"]) == len(rows)
    assert _cli(str(tmp_path), "--baseline", str(base)).returncode == 0
    assert _cli(str(tmp_path), "--baseline", str(base), "--no-baseline").returncode == 1
    (mdir / "broken.py").write_text("def f(:\n")
    assert _cli(str(tmp_path), "--baseline", str(base)).returncode == 2


def test_lint_imports_no_torch():
    code = ("import sys, repro_torch.analysis.lint\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy', 'jax', 'repro'))\nassert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr


def test_captured_step_marks_the_two_bodies_and_is_a_no_op():
    from repro_torch.analysis.ownership import captured_step
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.serve.engine import ServeEngine

    def f(x):
        return x

    assert captured_step(f) is f and f._repro_captured_step
    assert ServeEngine._decode_impl._repro_captured_step
    assert DecoderLM.extend_step._repro_captured_step
    roots = {q for p, q in capture_safety.closure([SourceFile(PORT / "serve" / "engine.py")])}
    assert roots == {"ServeEngine._decode_impl"}


# ---------------------------------------------------------------------------
# parity with the JAX package's linter
# ---------------------------------------------------------------------------


def _rows(findings, prefix):
    return sorted((f.rule, f.path, f.line, f.func) for f in findings
                  if f.rule.startswith(prefix))


@pytest.mark.parametrize("prefix", NEUTRAL)
@pytest.mark.parametrize("corpus", ["bad", "good"])
def test_neutral_rules_match_reference(corpus, prefix):
    from repro.analysis.findings import SourceFile as JaxSourceFile
    from repro.analysis.lint import run_rules as jax_run_rules

    paths = sorted((FIXTURES / corpus).rglob("*.py"))
    assert paths
    display = [p.relative_to(REPO).as_posix() for p in paths]
    ours = run_rules([SourceFile(p, d) for p, d in zip(paths, display)])
    theirs = jax_run_rules([JaxSourceFile(p, d) for p, d in zip(paths, display)])
    assert _rows(ours, prefix) == _rows(theirs, prefix)
    if corpus == "bad":
        assert _rows(theirs, prefix), f"the reference corpus fires no {prefix} rule"


def test_fingerprint_and_render_match_reference():
    from repro.analysis.findings import Finding as JaxFinding
    from repro.analysis.findings import SourceFile as JaxSourceFile
    from repro.analysis.lint import run_rules as jax_run_rules

    theirs = jax_run_rules([JaxSourceFile(p) for p in sorted((FIXTURES / "bad").rglob("*.py"))])
    assert theirs
    for j in theirs:
        ours = Finding(rule=j.rule, path=j.path, line=j.line, func=j.func, message=j.message)
        assert ours.fingerprint() == j.fingerprint() and ours.render() == j.render()
    assert JaxFinding("r", "p", 1, "<module>", "m").render() == \
        Finding("r", "p", 1, "<module>", "m").render()


# ---------------------------------------------------------------------------
# the closure covers what the engine runs; seeded violations on the real tree
# ---------------------------------------------------------------------------


@pytest.fixture
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _shipped_closure() -> frozenset:
    files = [SourceFile(p, display_path=p.relative_to(PORT).as_posix())
             for p in sorted(PORT.rglob("*.py"))]
    return frozenset(capture_safety.closure(files))


def _entered(fn, seen: set):
    """``fn`` with every port function it enters, outside ``kernels/ref.py``,
    recorded into ``seen`` as (path in the package, qualname of the
    enclosing top-level function or method)."""
    root = str(PORT) + os.sep

    def prof(frame, event, arg):
        name = frame.f_code.co_filename
        if event == "call" and name.startswith(root):
            rel = name[len(root):].replace(os.sep, "/")
            if rel != "kernels/ref.py":
                seen.add((rel, frame.f_code.co_qualname.split(".<locals>")[0]))

    @functools.wraps(fn)
    def wrapped(*a, **k):
        sys.setprofile(prof)
        try:
            return fn(*a, **k)
        finally:
            sys.setprofile(None)

    return wrapped


@pytest.mark.parametrize("path", ["paged", "gather"])
def test_closure_covers_the_engine_run(path, _one_thread):
    import torch

    from repro_torch import serve as tserve
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_arch("qwen2.5-3b").reduced(), dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    ecfg = tserve.EngineConfig(
        batch_slots=2, max_len=32, cache=tserve.CacheConfig(page_size=4, decode_path=path),
        admission=tserve.AdmissionConfig(async_prefill=False, prefill_chunk=8))
    eng = tserve.ServeEngine(model, params, ecfg, device="cpu")
    seen: set = set()
    eng._decode_impl = _entered(eng._decode_impl, seen)
    model.extend_step = _entered(model.extend_step, seen)
    rng = np.random.default_rng(7)
    # 19 tokens: two full chunks (the captured form, a 0-d tensor position)
    # and a tail (the int form) per prompt; three prompts over two lanes
    reqs = [tserve.Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=(19,))
                           .astype(np.int32), max_new_tokens=4) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    assert eng.prefill_slots.runs >= 6 and eng.decode_graph.runs >= 4
    want = {("serve/engine.py", "ServeEngine._decode_impl"),
            ("models/transformer.py", "DecoderLM.extend_step"),
            ("kernels/ops.py", "paged_write" if path == "paged" else "paged_gather_many"),
            ("kernels/ops.py", "flash_attention")}
    assert want <= seen
    assert seen <= _shipped_closure(), sorted(seen - _shipped_closure())


def test_captured_step_marks_the_train_step_body():
    """The training step body is a root, and its closure holds the backward's
    entry, the grad norm and the three optimizers' updates."""
    from repro_torch.train.train_step import TrainStep

    assert TrainStep.__call__._repro_captured_step
    roots = {q for p, q in capture_safety.closure([SourceFile(PORT / "train" / "train_step.py")])}
    assert "TrainStep.__call__" in roots
    want = {("train/train_step.py", q) for q in ("TrainStep.__call__", "value_and_grad",
                                                  "global_norm", "_split_microbatches")}
    want |= {("optim/optimizer.py", q) for q in ("sgd", "momentum", "adamw")}
    want |= {("kernels/ops.py", "stream_gd_foreach"), ("models/transformer.py", "DecoderLM.loss"),
             ("models/encdec.py", "EncDecLM.loss"), ("models/api.py", "VLM.loss")}
    assert want <= _shipped_closure(), sorted(want - _shipped_closure())


# (arch, optimizer, microbatches, remat) of the training steps run on the CPU
TRAIN_CASES = [("qwen2.5-3b", "sgd", 1, "none"), ("qwen2.5-3b", "momentum", 2, "full"),
               ("qwen2.5-3b", "adamw", 2, "none"), ("mamba2-130m", "momentum", 1, "full"),
               ("qwen3-moe-235b-a22b", "sgd", 2, "full"), ("deepseek-v3-671b", "sgd", 1, "none"),
               ("recurrentgemma-9b", "sgd", 1, "full"),
               ("llava-next-mistral-7b", "sgd", 1, "full"), ("whisper-large-v3", "adamw", 1, "full")]


@pytest.mark.parametrize("arch,opt,n_micro,remat", TRAIN_CASES,
                         ids=[f"{a.split('-')[0]}-{o}-{n}-{r}" for a, o, n, r in TRAIN_CASES])
def test_closure_covers_the_training_step(arch, opt, n_micro, remat, _one_thread):
    """Every port function two CPU training steps enter (through the static
    buffers of ``CapturedTrainStep``; on the CPU the backward and its remat
    recompute run on this thread) lies in the closure of
    ``TrainStep.__call__``."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.optim import get_optimizer
    from repro_torch.train.captured import CapturedTrainStep
    from repro_torch.train.train_step import make_train_step

    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32", remat=remat)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    o = get_optimizer(opt, lr=1e-2)
    state = o.init(params)
    seen: set = set()
    body = _entered(make_train_step(model, o, n_microbatches=n_micro), seen)
    step = CapturedTrainStep(body, params, state, torch.device("cpu"), capture=False)
    data = SyntheticLMData(cfg, batch=2, seq=8, device="cpu")
    for _ in range(2):
        params, state, m = step(params, state, data.next())
    assert torch.isfinite(m["loss"]) and int(state["count"]) == 2
    want = {("train/train_step.py", "TrainStep.__call__"), ("train/train_step.py", "value_and_grad"),
            ("train/train_step.py", "global_norm"), ("optim/optimizer.py", opt)}
    if opt != "adamw":
        want.add(("kernels/ops.py", "stream_gd_foreach"))
    assert want <= seen, sorted(want - seen)
    assert seen <= _shipped_closure(), sorted(seen - _shipped_closure())


# (rule, the line inserted after ``positions = positions.long()`` in
# DecoderLM.decode_step_paged)
SEEDED = [
    ("graph-host-read", "_seeded = positions.max().item()"),
    ("graph-tensor-branch", "if active.any():\n            x = x * 1"),
    ("graph-tensor-cast", "_seeded = int(positions[0])"),
    ("graph-tensor-loop", "for _seeded in range(positions[0]):\n            x = x * 1"),
]


@pytest.mark.parametrize("rule,line", SEEDED, ids=[r for r, _ in SEEDED])
def test_seeded_violation_in_decode_step_paged_is_flagged(tmp_path, rule, line):
    copy = tmp_path / "repro_torch"
    shutil.copytree(PORT, copy, ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    target = copy / "models" / "transformer.py"
    text = target.read_text()
    anchor = ("        positions = positions.long()\n"
              "        tables = self._rope(positions[:, None])\n")
    assert text.count(anchor) == 1                      # decode_step_paged's
    target.write_text(text.replace(anchor, anchor + "        " + line + "\n"))
    findings, errors = lint_paths([copy], baseline=None, root=tmp_path)
    assert not errors
    assert [(f.rule, f.path, f.func) for f in findings] == [
        (rule, "repro_torch/models/transformer.py", "DecoderLM.decode_step_paged")]
