"""The port's tooling: ``cli.smoke`` (exit codes as the JAX CLI's), the
version, ``utils/profiling.py``'s ``trace`` and ``device_memory_stats`` on a
host without a card, and ``cli.train_embedder`` refusing to run without a
card unless told ``--device cpu``."""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import manual_yolo_tpu_torch  # noqa: E402
from manual_yolo_tpu_torch.cli import smoke  # noqa: E402
from manual_yolo_tpu_torch.utils import profiling  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_version_matches_the_jax_package():
    jax_version = {}
    with open(os.path.join(REPO, "manual_yolo_tpu", "version.py")) as f:
        exec(f.read(), jax_version)
    assert manual_yolo_tpu_torch.__version__ == jax_version["__version__"] == "0.1.0"
    from manual_yolo_tpu_torch.version import __version__

    assert __version__ is manual_yolo_tpu_torch.__version__


def test_smoke_passes_on_the_cpu(capsys, monkeypatch):
    """``--device cpu``: every check runs; exit 0, the backend line names the CPU."""
    monkeypatch.chdir(REPO)
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    assert smoke.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "✅ PyTorch backend (cpu" in out and out.rstrip().endswith("PASS")
    for name in ("rank classifier", "detector weights", "OCR recognizer", "trackers",
                 "native runtime", "capture sources"):
        assert f"✅ {name}" in out, name


def test_smoke_fails_without_a_card_or_with_missing_weights(capsys, monkeypatch, tmp_path):
    """Without a card the default (cuda) fails the backend, classifier and
    OCR checks: exit 1. A missing detector file fails a required check; a
    missing OCR checkpoint only warns (optional, as in the JAX CLI)."""
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert smoke.main([]) == 1
    out = capsys.readouterr().out
    assert "❌ PyTorch backend: RuntimeError" in out and "FAIL" in out
    assert smoke.main(["--device", "cpu", "--detector", str(tmp_path / "none.npz")]) == 1
    assert "❌ detector weights" in capsys.readouterr().out
    assert smoke.main(["--device", "cpu", "--ocr-weights", str(tmp_path / "none.npz")]) == 0
    assert "⚠ OCR recognizer" in capsys.readouterr().out


def test_device_memory_stats_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.device_memory_stats() == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    """On the CPU: CPU activities only; the file is a Chrome trace holding
    the profiled ops."""
    with profiling.trace(str(tmp_path / "traces")) as prof:
        torch.nn.functional.conv2d(torch.ones(1, 3, 16, 16), torch.ones(4, 3, 3, 3))
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "traces")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)


def test_train_embedder_needs_a_card_unless_told_cpu(tmp_path):
    code = (
        "import torch; torch.cuda.is_available = lambda: False\n"
        "from manual_yolo_tpu_torch.cli import train_embedder\n"
        f"train_embedder.main(['--data', {str(tmp_path / 'none')!r}])\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr, proc.stderr[-500:]
