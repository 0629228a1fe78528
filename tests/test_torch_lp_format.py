"""The port's `.lp` reader and writer (`io/lp_format.py`) against the JAX
package's, on the CPU.

- `write_lp` writes the JAX writer's text, character for character, for
  a seeded LP, a QP and a MIP with SOS sets and semi-continuous columns
  (neither writer writes an SOS section: ROADMAP queue 3).
- `read_lp` of that text gives the written model's arrays to the 12
  significant digits the writer prints (rtol 1e-11).  The JAX reader
  misreads texts both writers write (ROADMAP queue 3): it splits a row
  with a signed left-hand bound ("-1 <= x + y <= 1") in two, multiplies
  a quadratic objective by the offset written before its bracket, reads
  the "semi-continuous" keyword as a section and two columns, and a
  number with a negative exponent ("1.5e-05") as a column; the port
  reads them all right.
- A hand-written file with every section, which the JAX reader reads
  right, gives the JAX reader's arrays exactly.
- `readModel` / `writeModel` of the facade take `.lp` and `.lp.gz`."""
import gzip

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import highs_tpu
import highs_tpu_torch
from highs_tpu.io import lp_format as jax_lp_format
from highs_tpu_torch.io import lp_format

torch.set_num_threads(1)

RTOL = 1e-11  # the writer prints 12 significant digits
ARRAYS = ("col_cost", "col_lower", "col_upper", "row_lower", "row_upper")


def _arrays(kind, seed=7):
    """A seeded model's arrays, feasible by construction: an LP, a QP
    (with a Hessian) or a MIP (integer, semi-continuous columns and SOS
    sets); every kind has two-sided rows with signed left-hand bounds."""
    rng = np.random.default_rng(seed)
    m, n = 12, 10
    a = sp.random(m, n, density=0.4, random_state=rng, format="csc")
    a.data = np.round(rng.uniform(-5, 5, a.nnz), 3)
    lo, up = np.zeros(n), np.round(rng.uniform(1, 9, n), 2)
    lo[0], up[0] = -np.inf, np.inf       # free
    lo[1] = up[1] = 2.5                  # fixed
    lo[2], up[2] = -3.0, np.inf
    x0 = np.clip(np.round(rng.uniform(0, 1, n), 2), lo, up)
    x0[6] = 1.5  # inside the MIP's semi-continuous range
    r = a @ x0
    rl = np.floor(r) - np.round(rng.uniform(0, 2, m), 4)
    ru = np.ceil(r) + np.round(rng.uniform(0, 2, m), 4)
    ru[:3] = np.inf                      # >= rows
    rl[3:5] = -np.inf                    # <= rows
    rl[5:7] = ru[5:7] = r[5:7]           # equalities
    rl[7:9] = -np.abs(rl[7:9]) - 1.0     # signed left-hand bounds
    d = dict(num_col=n, num_row=m, col_cost=np.round(rng.normal(size=n), 5),
             col_lower=lo, col_upper=up, row_lower=rl, row_upper=ru, a=a,
             sense=-1 if kind == "mip" else 1, offset=1.25, hessian=None,
             integrality=None, sos=[])
    d["col_cost"][9] = 3.25e-06          # written with a negative exponent
    if kind == "qp":
        q = sp.random(n, n, density=0.3, random_state=rng)
        q = (q @ q.T + sp.identity(n)).tocsc()
        q = sp.tril(np.round(q.toarray(), 3)).tocsc()
        d["hessian"] = q
    if kind == "mip":
        integ = np.zeros(n, dtype=np.uint8)
        integ[3:6] = 1                   # integer
        integ[6] = 2                     # semi-continuous
        lo[6] = 1.0
        x0[3:6] = np.round(x0[3:6])
        d["integrality"] = integ
        d["sos"] = [("S1", 1, [7, 8], [1.0, 2.0]),
                    ("S2", 2, [3, 4, 5], [1.0, 2.0, 3.0])]
    return d


def _model(pkg, d):
    lp = pkg.HighsLp(
        num_col=d["num_col"], num_row=d["num_row"],
        col_cost=d["col_cost"].copy(), col_lower=d["col_lower"].copy(),
        col_upper=d["col_upper"].copy(), row_lower=d["row_lower"].copy(),
        row_upper=d["row_upper"].copy(),
        a_matrix=pkg.HighsSparseMatrix.from_scipy(d["a"]),
        sense=d["sense"], offset=d["offset"])
    if d["integrality"] is not None:
        lp.integrality = d["integrality"].copy()
        lp.sos = list(d["sos"])
    if d["hessian"] is None:
        return pkg.HighsModel(lp=lp)
    q = d["hessian"]
    return pkg.HighsModel(lp=lp, hessian=pkg.HighsHessian(
        dim=q.shape[0], start=q.indptr.copy(), index=q.indices.copy(),
        value=q.data.copy()))


def _assert_models_equal(got, want, rtol=0.0):
    assert (got.lp.num_col, got.lp.num_row) == \
        (want.lp.num_col, want.lp.num_row)
    for f in ARRAYS:
        np.testing.assert_allclose(getattr(got.lp, f), getattr(want.lp, f),
                                   rtol=rtol, atol=0)
    assert int(got.lp.sense) == int(want.lp.sense)
    assert got.lp.offset == pytest.approx(want.lp.offset, rel=rtol, abs=0)
    np.testing.assert_allclose(got.lp.a_matrix.to_scipy().toarray(),
                               want.lp.a_matrix.to_scipy().toarray(),
                               rtol=rtol, atol=0)
    np.testing.assert_array_equal(np.asarray(got.lp.integrality),
                                  np.asarray(want.lp.integrality))
    assert got.is_qp() == want.is_qp()
    if got.is_qp():
        np.testing.assert_allclose(
            got.hessian.to_scipy_full().toarray(),
            want.hessian.to_scipy_full().toarray(), rtol=rtol, atol=0)


@pytest.mark.parametrize("kind", ["lp", "qp", "mip"])
def test_write_lp_text_matches_jax(kind, tmp_path):
    d = _arrays(kind)
    lp_format.write_lp(_model(highs_tpu_torch, d), str(tmp_path / "t.lp"))
    jax_lp_format.write_lp(_model(highs_tpu, d), str(tmp_path / "j.lp"))
    text = (tmp_path / "t.lp").read_text()
    assert text == (tmp_path / "j.lp").read_text()
    assert "bounds" in text and "end" in text


@pytest.mark.parametrize("kind", ["lp", "qp", "mip"])
def test_read_lp_matches_written_model_and_jax(kind, tmp_path):
    d = _arrays(kind)
    path = str(tmp_path / "m.lp")
    lp_format.write_lp(_model(highs_tpu_torch, d), path)
    got = lp_format.read_lp(path)
    source = _model(highs_tpu_torch, d)
    if kind == "mip":
        source.lp.sos = []  # the writer writes no SOS section
    _assert_models_equal(got, source, rtol=RTOL)


# texts the JAX reader misreads, and what it reads instead
REFERENCE_FAULTS = {
    # the JAX reader takes "-1 <=" as a row of its own and then meets a
    # column where it expects that row's right-hand side
    "signed_left_bound": (
        "min\n obj: x + y\nst\n c0: -1 <= x - y <= 2\n c1: x + y >= 1\n"
        "end\n", None),
    "offset_before_bracket": (
        "min\n obj: x + y +1.25 + [ 2 x^2 ]/2\nst\n c0: x + y >= 1\nend\n",
        lambda m: m.lp.offset == 0.0 and
        m.hessian.to_scipy_full().toarray()[0, 0] == 2.5),
    "negative_exponent": (
        "min\n obj: 1.5e-05 x + y\nst\n c0: x + y >= 1\nend\n",
        lambda m: m.lp.num_col == 3),
    "semi_continuous_keyword": (
        "min\n obj: x + y\nst\n c0: x + y >= 1\nbounds\n 1 <= x <= 4\n"
        "semi-continuous\n x\nend\n", lambda m: m.lp.num_col == 4),
}


@pytest.mark.parametrize("fault", sorted(REFERENCE_FAULTS))
def test_reads_what_the_reference_reader_misreads(fault, tmp_path):
    text, misread = REFERENCE_FAULTS[fault]
    path = tmp_path / "m.lp"
    path.write_text(text)
    if misread is None:
        with pytest.raises(ValueError):
            jax_lp_format.read_lp(str(path))
    else:
        assert misread(jax_lp_format.read_lp(str(path)))
    got = lp_format.read_lp(str(path))
    lp = got.lp
    assert lp.num_col == 2 and lp.num_row == (2 if fault.startswith(
        "signed") else 1)
    if fault == "negative_exponent":
        np.testing.assert_array_equal(lp.col_cost, [1.5e-05, 1.0])
    elif fault == "signed_left_bound":
        np.testing.assert_array_equal(lp.row_lower, [-1.0, 1.0])
        np.testing.assert_array_equal(lp.row_upper, [2.0, np.inf])
    elif fault == "offset_before_bracket":
        assert lp.offset == 1.25
        np.testing.assert_array_equal(
            got.hessian.to_scipy_full().toarray(), [[2.0, 0.0], [0.0, 0.0]])
    else:
        np.testing.assert_array_equal(lp.integrality, [2, 0])
        assert (lp.col_lower[0], lp.col_upper[0]) == (1.0, 4.0)


HAND_WRITTEN = r"""\ every section of the format
Maximize
 value: 3 x1 + 2 x2 - 4 x3 + x4 + 1.5 s + 2 y
   + [ 2 x1 ^ 2 + 1 x1 * x2 + 4 x2 ^ 2 ] / 2 + 7
Subject To
 cap: x1 + x2 + x3 <= 10
 demand: 2 x1 - x2 >= -4
 bal: x3 - x4 = 0.5
 rng: 1 <= x1 + x4 + s <= 8
 x2 + y >= 0.25
Bounds
 x1 <= 6
 -2 <= x3 <= 5
 x4 free
 -inf <= x2 <= 3
 s <= 4
 s >= 1
General
 x4
Binary
 y
Semis
 s
SOS
 sos1: S1:: x1:1 x2:2
End
"""


@pytest.mark.parametrize("gz", [False, True])
def test_hand_written_file_every_section(gz, tmp_path):
    path = tmp_path / ("every.lp.gz" if gz else "every.lp")
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(HAND_WRITTEN)
    else:
        path.write_text(HAND_WRITTEN)
    got = lp_format.read_lp(str(path))
    _assert_models_equal(got, jax_lp_format.read_lp(str(path)))
    lp = got.lp
    assert (lp.num_col, lp.num_row) == (6, 5)
    assert int(lp.sense) == -1 and lp.offset == 7.0
    assert got.is_qp()
    assert lp.row_names[:4] == ["cap", "demand", "bal", "rng"]
    j = {name: k for k, name in enumerate(lp.col_names)}
    assert lp.col_lower[j["x4"]] == -np.inf and lp.col_upper[j["x4"]] == \
        np.inf
    assert (lp.col_lower[j["y"]], lp.col_upper[j["y"]]) == (0.0, 1.0)
    assert int(lp.integrality[j["s"]]) == 2
    assert int(lp.integrality[j["x4"]]) == 1


def _lp_facade_pair(d):
    port = highs_tpu_torch.Highs(device="cpu")
    jax = highs_tpu.Highs()
    for h, pkg in ((port, highs_tpu_torch), (jax, highs_tpu)):
        h.setOptionValue("output_flag", False)
        h.passModel(_model(pkg, d))
    return port, jax


@pytest.mark.parametrize("name", ["model.lp", "model.lp.gz"])
def test_read_and_write_model_through_lp_files(name, tmp_path):
    d = _arrays("qp")
    port, jax = _lp_facade_pair(d)
    path = str(tmp_path / name)
    assert port.writeModel(path) == highs_tpu_torch.HighsStatus.kOk
    if name.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            assert f.readline().startswith("\\ File written")
    back = highs_tpu_torch.Highs(device="cpu")
    back.setOptionValue("output_flag", False)
    assert back.readModel(path) == highs_tpu_torch.HighsStatus.kOk
    _assert_models_equal(back.getModel(), _model(highs_tpu_torch, d),
                         rtol=RTOL)
    # the JAX facade solves the model itself (its reader misreads the
    # file, see above)
    for h in (back, jax):
        h.run()
    assert back.getModelStatus().name == jax.getModelStatus().name == \
        "kOptimal"
    assert back.getObjectiveValue() == pytest.approx(
        jax.getObjectiveValue(), rel=1e-6)
