"""The PyTorch package stands alone: no jax, nothing of highs_tpu.

Its option registry is the JAX package's, name for name and default for
default, and it never moves a solve to the CPU on its own."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import highs_tpu.options as jax_options
import highs_tpu_torch
import highs_tpu_torch.options as torch_options
from highs_tpu_torch.device import resolve_device

# the tests run in parallel worker processes on shared cores: torch's
# own thread pool in each of them would oversubscribe the machine
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "highs_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def test_import_leaves_jax_and_highs_tpu_out():
    code = (
        "import sys\n"
        "import highs_tpu_torch\n"
        "import highs_tpu_torch.solvers.dispatch\n"
        "import highs_tpu_torch.solvers.pdlp.wrapper\n"
        "import highs_tpu_torch.convert\n"
        "import highs_tpu_torch.utils.gen_block_lp\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'highs_tpu' or m.startswith('highs_tpu.')]\n"
        "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    assert path.exists()
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "highs_tpu"), (path, name)
    text = path.read_text()
    assert "__import__('jax" not in text and '__import__("jax' not in text


def test_option_registry_matches_jax_package():
    ref = {r.name: r for r in jax_options.HighsOptions.records()}
    port = {r.name: r for r in torch_options.HighsOptions.records()}
    assert list(port) == list(ref)
    for name, r in ref.items():
        p = port[name]
        assert p.type is r.type, name
        if isinstance(r.default, float) and r.default != r.default:
            assert p.default != p.default, name
        else:
            assert p.default == r.default, name
        assert (p.minimum, p.maximum, p.choices) == \
            (r.minimum, r.maximum, r.choices), name
    assert torch_options.HighsOptions().to_dict().keys() == \
        jax_options.HighsOptions().to_dict().keys()


def test_cuda_requested_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        highs_tpu_torch.Highs()
    assert resolve_device("cpu") == torch.device("cpu")
    assert highs_tpu_torch.Highs(device="cpu").device == torch.device("cpu")
