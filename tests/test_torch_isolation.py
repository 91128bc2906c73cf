"""The port stands alone and does not fall back to the CPU.

``paddle_tpu_torch`` and ``chip_smoke.py`` import neither ``jax`` nor
``paddle_tpu`` (checked on the source with an AST walk, and on a fresh
interpreter's ``sys.modules``).  Without a CUDA device the default device
raises instead of running on the CPU, and ``chip_smoke.py`` exits non-zero
without printing a result.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_fresh_import_loads_no_jax():
    code = ("import sys; import paddle_tpu_torch, paddle_tpu_torch.models, "
            "paddle_tpu_torch.generation, paddle_tpu_torch.inference, "
            "paddle_tpu_torch.convert, paddle_tpu_torch.ops._build, "
            "paddle_tpu_torch.serving, paddle_tpu_torch.ops.sharded, "
            "paddle_tpu_torch.distributed.meta_parallel; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    yield
    ptt.set_device(None)


def test_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match=r"set_device\('cpu'\)"):
        ptt.get_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(llama_tiny())


def test_cpu_only_when_asked(no_cuda):
    assert LlamaForCausalLM(llama_tiny(num_hidden_layers=1), device="cpu") \
        .lm_head.weight.device.type == "cpu"
    assert ptt.set_device("cpu") == torch.device("cpu")
    m = LlamaForCausalLM(llama_tiny(num_hidden_layers=1))
    assert next(m.parameters()).device.type == "cpu"
    ptt.set_device(None)
    with pytest.raises(RuntimeError):
        ptt.get_device()


def test_seeded_weights_are_reproducible():
    a = LlamaForCausalLM(llama_tiny(num_hidden_layers=1), device="cpu", seed=7)
    b = LlamaForCausalLM(llama_tiny(num_hidden_layers=1), device="cpu", seed=7)
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})


def test_chip_smoke_fails_without_a_card():
    res = _run_smoke(ROOT)
    assert res.returncode != 0 and '"ok"' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_bytes((ROOT / "chip_smoke.py").read_bytes())
    res = _run_smoke(tmp_path)
    assert res.returncode != 0 and '"ok"' not in res.stdout
