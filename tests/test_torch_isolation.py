"""The port stands alone: no file of ``k8s_gpu_tpu_torch/`` nor
``chip_smoke.py`` imports JAX or anything of the JAX package, the entry
points run on the card unless the caller asks for the CPU, and
``chip_smoke.py`` fails without CUDA and without the port beside it."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from k8s_gpu_tpu_torch.data.tokenizer import BpeTokenizer
from k8s_gpu_tpu_torch.models import TransformerConfig, TransformerLM
from k8s_gpu_tpu_torch.serve import ContinuousBatcher, InferenceEngine
from k8s_gpu_tpu_torch.serve import LmServer

# Tiny shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the host's cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "k8s_gpu_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "k8s_gpu_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = {
        str(f.relative_to(ROOT)): root
        for f in files for root in _imported_roots(f) if root in FORBIDDEN
    }
    assert bad == {}


CFG = TransformerConfig(vocab_size=300, d_model=16, n_layers=1, n_heads=2,
                        d_head=8, d_ff=32, max_seq=32, dtype=torch.float32)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TransformerLM(CFG)
    model = TransformerLM(CFG, device="cpu")
    params = model.init(0)
    tok = BpeTokenizer([])
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(model)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatcher(model, params, paged_blocks=8, page_size=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        LmServer(model, params, tok, paged_blocks=8, page_size=8)
    # Asked for the CPU, each of them runs there.
    assert InferenceEngine(model, device="cpu").device.type == "cpu"
    b = ContinuousBatcher(model, params, paged_blocks=8, page_size=8,
                          device="cpu")
    assert b._dev["cache"]["k"].device.type == "cpu"


def _run_smoke(cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, str(cwd / "chip_smoke.py")], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_cuda_or_without_the_port(tmp_path):
    here = _run_smoke(ROOT)
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = _run_smoke(tmp_path)
    for proc in (here, alone):
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
