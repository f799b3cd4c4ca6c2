"""The port stands alone: no JAX, no ``repro`` package, no silent CPU path.

* every ``repro_torch`` module imports in a fresh interpreter without
  pulling in ``jax`` or ``repro``, and no source file of the port, of its
  examples (``examples/torch_*.py``) or ``chip_smoke.py`` names them in an
  import;
* without a card, an entry point that was not asked for the CPU raises;
* ``chip_smoke.py`` exits non-zero with a message when there is no card,
  and when it stands alone in a directory.
"""
import ast
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def _foreign(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_sources_import_no_jax_and_no_repro():
    examples = sorted((REPO / "examples").glob("torch_*.py"))
    assert len(examples) >= 2
    files = sorted(PORT.rglob("*.py")) + examples + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    bad = {str(f.relative_to(REPO)): sorted(n for n in _imports(f) if _foreign(n))
           for f in files}
    assert not {f: n for f, n in bad.items() if n}


def test_every_port_module_imports_without_jax():
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[-1]) >= 18


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card behaviour cannot be observed")


def test_entry_points_raise_without_a_card():
    _no_card()
    from repro_torch.configs import get_arch
    from repro_torch.device import resolve
    from repro_torch.models import build_model
    from repro_torch.serve import EngineConfig, ServeEngine

    cfg = get_arch("qwen2.5-3b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, params, EngineConfig(batch_slots=1, max_len=32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator().manual_seed(0), "cuda")
    eng = ServeEngine(model, params, EngineConfig(batch_slots=1, max_len=32), device="cpu")
    assert eng.device.type == "cpu"


def test_train_launcher_raises_without_a_card_unless_asked_for_the_cpu():
    _no_card()
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.train import main

    args = ["--arch", "qwen2.5-3b", "--steps", "2", "--batch", "2", "--seq", "8",
            "--optimizer", "momentum"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticLMData(get_arch("qwen2.5-3b").reduced(), batch=2, seq=8)
    _, state, restarts = main(args + ["--device", "cpu"])
    assert state.step == 2 and restarts == 0
    assert all(np.isfinite(state.losses))


def _load_example(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_examples_raise_without_a_card_unless_asked_for_the_cpu(tmp_path):
    _no_card()
    train = _load_example("torch_train_convnet")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "2", "--ckpt", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train(steps=2, ckpt=None)
    losses, _, _ = train.train(steps=2, ckpt=None, device="cpu")
    assert len(losses) == 2 and all(np.isfinite(losses))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load_example("torch_quickstart").main([])


def test_chip_smoke_refuses_without_card_and_alone(tmp_path):
    _no_card()
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and '"ok"' not in proc.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "src/repro_torch is not beside" in proc.stderr and not proc.stdout
