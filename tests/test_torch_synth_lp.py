"""The port's copy of the synth50k generator makes `bench.py`'s LP.

The port may not import `bench.py`; the test may.  At full size this
costs numpy and a few seconds."""
import os
import sys

import numpy as np

from highs_tpu_torch.utils import gen_synth_lp as port_gen

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import bench  # noqa: E402


def test_full_size_equals_bench_synth50k():
    a, b, c = port_gen.gen_synth_lp()
    ja, jb, jc = bench.synth50k()
    assert a.shape == ja.shape == (50_000, 50_000)
    assert a.nnz == ja.nnz == 499_953
    assert (a != ja).nnz == 0
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(c, jc)


def test_synth_lp_is_the_bench_lp():
    # the HighsLp of bench.py:179-183 on a small member
    a, b, c = port_gen.gen_synth_lp(m=300, n=200, per_col=4, seed=3)
    lp = port_gen.synth_lp(m=300, n=200, per_col=4, seed=3)
    assert (lp.num_row, lp.num_col) == (300, 200)
    assert (lp.a_matrix.to_scipy() != a).nnz == 0
    np.testing.assert_array_equal(lp.row_lower, b)
    np.testing.assert_array_equal(lp.col_cost, c)
    assert np.all(np.isinf(lp.row_upper)) and np.all(lp.col_lower == 0)
    assert np.all(lp.col_upper == 10.0) and int(lp.sense) == 1
