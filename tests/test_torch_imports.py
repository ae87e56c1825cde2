"""The port stands alone: no module of `repro_torch` and nothing that
`chip_smoke.py` imports pulls in jax or the JAX package, and the port's
entry points refuse to fall back to the CPU silently."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _foreign(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_modules_import_without_jax_or_reference():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("kernels.decision_megakernel", "kernels.decode_attention",
                 "kernels.ssd_scan", "models.api", "models.blocks",
                 "models.bridge", "models.moe", "models.encdec", "configs.registry", "launch.steps",
                 "serving.scenarios", "serving.recovery", "serving.overload",
                 "serving.faults", "distributed.checkpoint",
                 "serving.hierarchy", "distributed.elastic",
                 "distributed.compression", "distributed.shardctx",
                 "launch.mesh", "launch.sharding", "launch.serve", "tracing",
                 "launch.train", "launch.dryrun", "training.data",
                 "training.optimizer", "training.train_loop",
                 "configs.gemma3_27b", "configs.granite_moe_3b_a800m",
                 "configs.whisper_tiny"):
        assert f"repro_torch.{name}" in mods
    assert not [m for m in mods if _foreign(m) or m == "ml_dtypes"]


def test_chip_smoke_imports_neither_jax_nor_reference():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "repro_torch.core" in names
    assert not [n for n in names if _foreign(n)]


def test_train_without_device_needs_cuda(monkeypatch):
    from repro_torch.core import EstimatorBundle
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        EstimatorBundle.train(None, [], [])
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.parametrize("which", ["knn", "encoder", "bestroute"])
def test_estimators_without_device_need_cuda(monkeypatch, which):
    """`device=None` means the card: without one these raise instead of
    landing on the CPU; `device="cpu"` still works."""
    from repro_torch.core.routers import BestRouteRouter
    from repro_torch.estimators.embedding import SentenceEncoder
    from repro_torch.estimators.knn import KNNEstimator
    make = {"knn": KNNEstimator, "encoder": SentenceEncoder,
            "bestroute": BestRouteRouter}[which]
    assert make(device="cpu") is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make()


def test_zoo_model_without_device_needs_cuda(monkeypatch):
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import Model
    cfg = smoke_variant(get_config("qwen2.5-3b"))
    assert Model(cfg, device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)


@pytest.mark.parametrize("name", ["quickstart", "budget_serving",
                                  "serve_cluster", "zoo_serving",
                                  "train_small"])
def test_port_examples_import_neither_jax_nor_reference(name):
    tree = ast.parse((ROOT / "examples" / f"torch_{name}.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert any(n.startswith("repro_torch") for n in names)
    assert not [n for n in names if _foreign(n)]


def test_cell_worker_without_device_needs_cuda(monkeypatch):
    """A span worker started without a device runs on the card, or
    raises; it never lands on the CPU."""
    from repro_torch.core.decision import cell_worker
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cell_worker(mesh=None)
