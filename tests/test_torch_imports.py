"""Import hygiene of the PyTorch port and of chip_smoke.py: they import
neither JAX nor the JAX package, nor cv2, PIL, yaml, fontTools or optax; chip_smoke.py fails
(and prints no result) without a card or outside the repo."""

import ast
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "manual_yolo_tpu_torch"
BLOCKED = ("jax", "jaxlib", "manual_yolo_tpu", "cv2", "PIL", "yaml", "fontTools", "optax")

_BLOCKER = textwrap.dedent(f"""
    import importlib.abc, sys
    BLOCKED = {BLOCKED!r}

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import: {{name}}")
            return None

    sys.meta_path.insert(0, Blocker())
""")


def _run(code: str, cwd: Path, env_extra=None, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(REPO), **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_and_chip_smoke_import_with_blocked_packages():
    modules = sorted(
        "manual_yolo_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py"
    )
    code = _BLOCKER + textwrap.dedent(f"""
        import importlib
        import manual_yolo_tpu_torch.cli.shot, manual_yolo_tpu_torch.runtime.shot
        import manual_yolo_tpu_torch.cli.serve, manual_yolo_tpu_torch.runtime.serving
        import manual_yolo_tpu_torch.runtime.fieldocr
        import chip_smoke
        for m in {modules!r}:
            importlib.import_module(m)
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not leaked, leaked
        print("ok", len({modules!r}))
    """)
    proc = _run(code, REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_port_sources_name_no_blocked_package():
    """Static check, so that a lazy import inside a function is caught too."""
    for path in [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in BLOCKED, (path, n)


def test_port_never_uses_cpp_extension():
    for path in PORT.rglob("*.py"):
        assert "cpp_extension" not in path.read_text(), path


def test_chip_smoke_fails_without_card():
    """Here torch has no CUDA: chip_smoke exits non-zero before any result."""
    code = _BLOCKER + textwrap.dedent("""
        import runpy, torch
        torch.cuda.is_available = lambda: False
        runpy.run_path("chip_smoke.py", run_name="__main__")
    """)
    proc = _run(code, REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_serving_entry_points_need_a_card_unless_told_cpu(tmp_path):
    """cli.serve, BatchStream and StreamingEngine default to cuda: without a
    card, and with the blocked packages out of reach, each raises the device
    error."""
    code = _BLOCKER + textwrap.dedent(f"""
        import torch
        torch.cuda.is_available = lambda: False
        from manual_yolo_tpu_torch.cli import serve
        from manual_yolo_tpu_torch.runtime import serving
        for call in (lambda: serve.main(["--tables", "1", "--ticks", "1", "--out", {str(tmp_path)!r}]),
                     lambda: serving.load_batch_stream("weights/poker_detector_n.npz",
                                                       "weights/rank_classifier_matched.npz"),
                     lambda: serving.load_streaming_engine("weights/poker_detector_n.npz",
                                                           "weights/rank_classifier_matched.npz")):
            try:
                call()
            except RuntimeError as e:
                assert "device='cpu'" in str(e), e
            else:
                raise AssertionError("ran without a card")
        print("ok")
    """)
    proc = _run(code, REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_training_clis_need_a_card_unless_told_cpu(tmp_path):
    """cli.train_cls, cli.train_det and cli.eval_det default to cuda: without
    a card, and with the blocked packages out of reach, each raises the
    device error before it reads any data."""
    code = _BLOCKER + textwrap.dedent(f"""
        import torch
        torch.cuda.is_available = lambda: False
        from manual_yolo_tpu_torch.cli import eval_det, train_cls, train_det
        import manual_yolo_tpu_torch.train.classifier, manual_yolo_tpu_torch.train.detector
        missing = {str(tmp_path / "none")!r}
        for call in (lambda: train_cls.main(["--data", missing]),
                     lambda: train_det.main(["--data", missing]),
                     lambda: eval_det.main(["--data", missing, "--weights",
                                            "weights/poker_detector_n.npz"])):
            try:
                call()
            except RuntimeError as e:
                assert "device='cpu'" in str(e), e
            else:
                raise AssertionError("ran without a card")
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not leaked, leaked
        print("ok")
    """)
    proc = _run(code, REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
