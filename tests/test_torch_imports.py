"""The PyTorch package stands alone: no jax, nothing of highs_tpu.

Its option registry is the JAX package's, name for name and default for
default, and it never moves a solve to the CPU on its own."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import highs_tpu.options as jax_options
import highs_tpu_torch
import highs_tpu_torch.options as torch_options
from highs_tpu_torch import convert
from highs_tpu_torch.device import resolve_device
from highs_tpu_torch.ops import block_csr, linops, onehot_spmv
from highs_tpu_torch.options import HighsOptions
from highs_tpu_torch.solvers.icrash import run_icrash
from highs_tpu_torch.solvers.ipm.banded_chol import BandedCholesky
from highs_tpu_torch.solvers.ipm.solver import (IpmProblem, IpmState,
                                                solve_lp_ipm_native)

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
        "import highs_tpu_torch.utils.gen_synth_lp\n"
        "import highs_tpu_torch.tools.gather_probe\n"
        "import highs_tpu_torch.tools.profile_ipm\n"
        "import highs_tpu_torch.solvers.ipm.wrapper\n"
        "import highs_tpu_torch.solvers.ipm.banded_chol\n"
        "import highs_tpu_torch.solvers.ipm.sparse_ldl\n"
        "import highs_tpu_torch.solvers.classify\n"
        "import highs_tpu_torch.solvers.icrash\n"
        "import highs_tpu_torch.solvers.simplex.dualize\n"
        "import highs_tpu_torch.utils.gen_grid_flow_lp\n"
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


_A = sp.random(256, 256, density=0.02, random_state=0, format="csr")
_LP = convert.lp_from_numpy(dict(
    num_col=2, num_row=1, col_cost=[1.0, 2.0], col_lower=[0.0, 0.0],
    col_upper=[1.0, 1.0], row_lower=[1.0], row_upper=[np.inf],
    a_start=[0, 1, 2], a_index=[0, 0], a_value=[1.0, 1.0]))

# every public constructor of device objects, called without a device
CONSTRUCTORS = {
    "linops.from_scipy": lambda: linops.from_scipy(_A),
    "linops.from_scipy_ell": lambda: linops.from_scipy_ell(_A),
    "linops.from_scipy_panel_ell": lambda: linops.from_scipy_panel_ell(_A),
    "linops.from_scipy_bucket_panel_ell":
        lambda: linops.from_scipy_bucket_panel_ell(_A),
    "linops.from_scipy_bucket_perm": lambda: linops.from_scipy_bucket_perm(
        _A[linops.bucket_row_perm(_A)][:, linops.bucket_row_perm(
            _A.T.tocsr())]),
    "linops.from_scipy_bcoo": lambda: linops.from_scipy_bcoo(_A),
    "block_csr.from_scipy_block_csr":
        lambda: block_csr.from_scipy_block_csr(_A),
    "onehot_spmv.from_scipy_onehot":
        lambda: onehot_spmv.from_scipy_onehot(_A),
    "convert.block_csr_from_numpy": lambda: convert.block_csr_from_numpy(
        np.zeros((1, 128, 128)), [0], [0], [1], shape=(128, 128)),
    "convert.linop_from_numpy":
        lambda: convert.linop_from_numpy({"a": np.eye(2)}),
    "convert.pdhg_problem_from_numpy": lambda: convert.pdhg_problem_from_numpy(
        {"k_op": None, **{f: np.zeros(2) for f in
                          ("b", "c", "lo", "up", "is_eq", "lo_fin", "up_fin",
                           "inv_row_scale", "inv_col_scale", "norm_b",
                           "norm_c")}}),
    "convert.pdhg_state_from_numpy": lambda: convert.pdhg_state_from_numpy(
        {f: np.zeros(2) for f in ("x", "y", "x_pd", "y_pd", "x_anchor",
                                  "y_anchor", "aty", "k", "eta", "omega")}),
    "convert.restart_ctl_from_numpy": lambda: convert.restart_ctl_from_numpy(
        {f: np.zeros(()) for f in ("fpe_init", "fpe_last", "fresh",
                                   "total_k", "n_restarts")}),
    "convert.ipm_problem_from_numpy": lambda: convert.ipm_problem_from_numpy(
        {f: np.eye(2) if f == "a" else np.zeros(2)
         for f in IpmProblem._fields}),
    "convert.ipm_state_from_numpy": lambda: convert.ipm_state_from_numpy(
        {f: np.zeros(2) for f in IpmState._fields}),
    "banded_chol.BandedCholesky.from_spd":
        lambda: BandedCholesky.from_spd(sp.identity(256, format="csr")),
    "ipm.solver.solve_lp_ipm_native":
        lambda: solve_lp_ipm_native(_LP, HighsOptions()),
    "icrash.run_icrash": lambda: run_icrash(_LP, HighsOptions()),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructors_default_to_cuda(monkeypatch, name):
    # without a device a constructor asks for CUDA: with no card it raises,
    # it never builds on the CPU unasked
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CONSTRUCTORS[name]()
