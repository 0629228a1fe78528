"""The PDLP scaling's one route against the JAX package's, bit for bit.

`scaling.scale_problem` runs the Ruiz, Pock-Chambolle and L2 passes in
torch on the device it is given.  On the CPU it sums with the segment
sums' plain version (`ops/segment_sum.py`); on a card with the kernel
(`csrc/segment_sum.cu`).  On the CPU the scaled values, the structure and
the row and column scales must equal the JAX package's numpy scaling
(`highs_tpu/solvers/pdlp/scaling.py`) in every bit, for each mode and
for matrices with empty rows and columns, unsorted and duplicate
entries, and a Ruiz run that stops early; on a card they must equal the
route's CPU form.  The single solve (`wrapper.pdlp_problem`) and the
batch (`batch.prepare_batch`) both scale through it.

The card tests skip without CUDA; on a card, without the repository's
conftest (and without the JAX package, which only the CPU test reads):

    python -m pytest --noconftest tests/test_torch_pdlp_scaling.py -q -k card
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from highs_tpu_torch.models.lp import HighsLp, HighsSparseMatrix
from highs_tpu_torch.ops import segment_sum as seg
from highs_tpu_torch.options import HighsOptions
from highs_tpu_torch.solvers.pdlp import batch, scaling, wrapper
from highs_tpu_torch.solvers.pdlp.preprocess import preprocess_lp
from highs_tpu_torch.utils.gen_block_lp import block_lp
from highs_tpu_torch.utils.gen_synth_lp import gen_synth_lp, synth_lp
from highs_tpu_torch.utils.timer import HighsTimer

# the tests run in parallel worker processes on shared cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
MODES = [1, 2, 4, 5, 7]


def _block16():
    """K of the 16-block-row staircase LP, as `pdlp_problem` scales it."""
    return preprocess_lp(block_lp(nblocks=16)).a


def _synth():
    """K of a small scattered LP (min c'x, Ax >= b, 0 <= x <= 10)."""
    a, b, c = gen_synth_lp(m=300, n=400, seed=5)
    m, n = a.shape
    lp = HighsLp(num_col=n, num_row=m, col_cost=c, col_lower=np.zeros(n),
                 col_upper=np.full(n, 10.0), row_lower=b,
                 row_upper=np.full(m, np.inf),
                 a_matrix=HighsSparseMatrix.from_scipy(a), sense=1)
    return preprocess_lp(lp).a


def _empty_lines():
    """Empty rows and columns, and stored zeros of both signs."""
    a = sp.random(60, 50, density=0.08, random_state=3, format="lil")
    a[[4, 17, 33], :] = 0.0
    a[:, [0, 21, 49]] = 0.0
    a = a.tocsr()
    a.eliminate_zeros()
    a.data[:2] = [0.0, -0.0]
    a.data *= np.random.default_rng(3).choice([-1.0, 1.0], a.nnz)
    return a


def _unsorted_duplicates():
    """A CSR whose rows hold unsorted and repeated column indices."""
    rng = np.random.default_rng(8)
    m, n, per_row = 40, 30, 6
    indices = rng.integers(0, n, size=m * per_row).astype(np.int32)
    indices[1::7] = indices[::7][:len(indices[1::7])]  # repeats
    data = rng.standard_normal(m * per_row) * rng.choice([1e-3, 1.0, 50.0],
                                                          m * per_row)
    indptr = np.arange(0, m * per_row + 1, per_row)
    a = sp.csr_matrix((data, indices, indptr), shape=(m, n))
    assert not a.has_canonical_format
    return a


def _ruiz_stops_early():
    """A scaled permutation: one pass brings every norm to 1 (within
    rounding), so the stop test ends Ruiz at its second pass."""
    rng = np.random.default_rng(2)
    n = 64
    return sp.csr_matrix((rng.uniform(0.1, 100.0, n) *
                          rng.choice([-1.0, 1.0], n),
                          (np.arange(n), rng.permutation(n))), shape=(n, n))


MATRICES = {"block16": _block16, "synth": _synth,
            "empty_lines": _empty_lines,
            "unsorted_duplicates": _unsorted_duplicates,
            "ruiz_stops_early": _ruiz_stops_early}


def _same_bits(got: np.ndarray, want: np.ndarray) -> bool:
    got, want = np.asarray(got), np.asarray(want)
    return (got.dtype == want.dtype == np.float64 and
            got.shape == want.shape and
            np.array_equal(got.view(np.int64), want.view(np.int64)))


def _assert_same(got, want):
    """Scaled values, structure and both scale vectors, bit for bit."""
    (ga, gs), (wa, ws) = got, want
    assert _same_bits(ga.data, wa.data)
    assert np.array_equal(ga.indices, wa.indices)
    assert np.array_equal(ga.indptr, wa.indptr)
    assert ga.shape == wa.shape
    assert _same_bits(gs.row_scale, ws.row_scale)
    assert _same_bits(gs.col_scale, ws.col_scale)


def _ruiz_passes(name, mode):
    if not mode & 1:
        return 0
    return 2 if name == "ruiz_stops_early" else 10


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(MATRICES))
def test_device_route_plain_matches_numpy(name, mode):
    # the reference imports JAX: inside the test, so that the card tests
    # of this file run where the JAX package is not installed
    from highs_tpu.solvers.pdlp.scaling import scale_problem as reference
    a = MATRICES[name]()
    got = scaling.scale_problem(a, mode, 10, CPU)
    _assert_same(got, reference(a, mode=mode, ruiz_iterations=10))
    assert got[1].ruiz_passes == _ruiz_passes(name, mode)


def test_prepare_batch_scales_as_scale_problem():
    """Each instance of a batch, of two sizes padded to one shape, holds
    the scales and the scaled K that `scale_problem` gives its standard
    form on the batch's device."""
    lps = [synth_lp(m=m, n=m + 16, seed=i)
           for i, m in enumerate((96, 120, 150))]
    opts = HighsOptions()
    start = batch.prepare_batch(lps, opts, CPU)
    k = start.problem.k_op.a.numpy()
    for i, lp in enumerate(lps):
        a, sv = scaling.scale_problem(
            preprocess_lp(lp).a, opts.pdlp_scaling_mode,
            opts.pdlp_ruiz_iterations, CPU)
        dr, dc = start.scales[i]
        assert _same_bits(dr, sv.row_scale) and _same_bits(dc, sv.col_scale)
        m, n = a.shape
        assert _same_bits(k[i, :m, :n], a.toarray())
        assert not k[i, m:].any() and not k[i, :, n:].any()


@pytest.mark.parametrize("square", [False, True])
def test_segment_sum_plain_is_bincount(square):
    """The plain sums equal np.bincount's, rows and columns, bit for bit
    (the sum of a segment is its terms added in order from 0)."""
    a = _unsorted_duplicates()
    terms = a.data * a.data if square else np.abs(a.data)
    m, n = a.shape
    row_of = np.repeat(np.arange(m), np.diff(a.indptr))
    values = torch.from_numpy(a.data)
    ptr = torch.from_numpy(a.indptr).long()
    cols = torch.from_numpy(a.indices).long()
    order = torch.sort(cols, stable=True)[1]
    col_ptr = torch.cat([torch.zeros(1, dtype=torch.int64),
                         torch.cumsum(torch.bincount(cols, minlength=n), 0)])
    rows = seg.segment_sum(values, ptr, square=square)
    cols_sum = seg.segment_sum(values, col_ptr, order, square=square)
    assert _same_bits(rows.numpy(), np.bincount(row_of, terms, minlength=m))
    assert _same_bits(cols_sum.numpy(),
                      np.bincount(a.indices, terms, minlength=n))


def test_segment_sum_checks_its_inputs():
    v = torch.ones(4, dtype=torch.float64)
    ptr = torch.tensor([0, 2, 4])
    with pytest.raises(TypeError):
        seg.segment_sum(v.float(), ptr)
    with pytest.raises(TypeError):
        seg.segment_sum(v, ptr.int())
    with pytest.raises(ValueError):
        seg.segment_sum(v, ptr, order=torch.arange(3))
    assert seg.segment_sum(v, torch.tensor([0])).shape == (0,)


def _lp_of(a):
    m, n = a.shape
    rng = np.random.default_rng(0)
    return HighsLp(num_col=n, num_row=m, col_cost=rng.uniform(0.1, 1, n),
                   col_lower=np.zeros(n), col_upper=np.full(n, 10.0),
                   row_lower=np.full(m, -1.0), row_upper=np.full(m, np.inf),
                   a_matrix=HighsSparseMatrix.from_scipy(a.tocsc()), sense=1)


def test_pdlp_problem_scales_in_its_span(monkeypatch):
    """`pdlp_problem` scales once, inside the span "pdlp.scale" of the
    options' timer, and pads what `scale_problem` gives."""
    lp = _lp_of(_synth())
    opts = HighsOptions()
    opts._timer = timer = HighsTimer()
    running = []

    def watched(a, *args):
        running.append(timer._clocks["pdlp.scale"].running)
        return scaling.scale_problem(a, *args)
    monkeypatch.setattr(wrapper, "scale_problem", watched)
    s = wrapper.pdlp_problem(lp, opts, device=CPU)
    assert running == [True] and timer.num_calls("pdlp.scale") == 1
    want, sv = scaling.scale_problem(
        preprocess_lp(lp).a, opts.pdlp_scaling_mode,
        opts.pdlp_ruiz_iterations, CPU)
    got = s.scaled
    assert _same_bits(got.scaled_pad.data, want.data)
    assert _same_bits(got.dr, sv.row_scale)
    assert _same_bits(got.dc, sv.col_scale)
    assert torch.equal(s.problem.inv_row_scale[:want.shape[0]],
                       torch.from_numpy(1.0 / sv.row_scale).to(s.dtype))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the segment-sum kernel has no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(MATRICES))
def test_card_route_matches_cpu_form(cuda_device, name, mode):
    a = MATRICES[name]()
    want = scaling.scale_problem(a, mode, 10, CPU)
    before = seg.LAUNCHES
    got = scaling.scale_problem(a, mode, 10, cuda_device)
    torch.cuda.synchronize()
    _assert_same(got, want)
    assert got[1].ruiz_passes == want[1].ruiz_passes == _ruiz_passes(name,
                                                                     mode)
    # two launches (rows, columns) for each of the Pock-Chambolle and L2
    assert seg.LAUNCHES - before == 2 * bin(mode & 6).count("1")


def test_segment_sum_kernel_matches_plain_on_card(cuda_device):
    a = _block16().tocsr()
    n = a.shape[1]
    values = torch.from_numpy(a.data).to(cuda_device)
    ptr = torch.from_numpy(a.indptr).to(cuda_device, torch.int64)
    cols = torch.from_numpy(a.indices).to(cuda_device, torch.int64)
    order = torch.sort(cols, stable=True)[1]
    col_ptr = torch.cat([
        torch.zeros(1, dtype=torch.int64, device=cuda_device),
        torch.cumsum(torch.bincount(cols, minlength=n), 0)])
    for square in (False, True):
        for p, o in ((ptr, None), (col_ptr, order)):
            got = seg.segment_sum(values, p, o, square=square)
            torch.cuda.synchronize()
            assert torch.equal(got, seg.segment_sum_plain(values, p, o,
                                                          square))
            assert torch.equal(got, seg.segment_sum(values, p, o,
                                                    square=square))


def _tensors(obj, prefix="k_op"):
    """(name, tensor) of every tensor inside an operator built of named
    tuples."""
    if isinstance(obj, torch.Tensor):
        yield prefix, obj
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        for field in obj._fields:
            yield from _tensors(getattr(obj, field), f"{prefix}.{field}")


def test_block64k_on_card(cuda_device):
    """block64k (base 2024, 25.1 M nonzeros) through `pdlp_problem` on
    the card: its scaled values, scales and f32 operator equal those
    built from the route's CPU form."""
    from highs_tpu_torch.ops import linops
    lp = block_lp()
    opts = HighsOptions()
    card = wrapper.pdlp_problem(lp, opts, device=cuda_device)
    std = preprocess_lp(lp)
    want, sv = scaling.scale_problem(
        std.a, opts.pdlp_scaling_mode, opts.pdlp_ruiz_iterations, CPU)
    assert _same_bits(card.scaled.scaled_pad.data, want.data)
    assert _same_bits(card.scaled.dr, sv.row_scale)
    assert _same_bits(card.scaled.dc, sv.col_scale)
    m, n = want.shape
    host_pad = sp.csr_matrix(
        (want.data, want.indices,
         np.concatenate([want.indptr, np.full(card.m_pad - m,
                                              want.indptr[-1])])),
        shape=(card.m_pad, card.n_pad))
    op = linops.from_scipy(host_pad, fmt=opts.tpu_matrix_format,
                           dtype=card.dtype, device=cuda_device)
    got = dict(_tensors(card.problem.k_op))
    assert got and got.keys() == dict(_tensors(op)).keys()
    for name, t in _tensors(op):
        assert torch.equal(got[name], t), name
