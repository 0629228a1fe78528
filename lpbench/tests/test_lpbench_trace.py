"""The trace's reduction and the roofline arithmetic on synthetic
profiler events."""
import pytest

from lpbench import trace, yardstick


def test_union_and_gaps():
    iv = [(10, 20), (15, 30), (40, 50), (45, 46), (60, 60)]
    assert trace.union_length(iv) == 30
    assert trace.union_length([]) == 0
    assert trace.gaps(iv, 0, 70) == [(0, 10), (30, 40), (50, 60), (60, 70)]
    assert trace.gaps(iv, 12, 25) == []
    assert trace.gaps([], 5, 9) == [(5, 9)]


def test_innermost_host_event():
    host = sorted([(0, 100, "lpbench.run"), (10, 50, "aten::copy_"),
                   (20, 30, "cudaMemcpyAsync"), (60, 70, "aten::add")])
    starts = [h[0] for h in host]
    assert trace.innermost(host, starts, 25) == "cudaMemcpyAsync"
    assert trace.innermost(host, starts, 40) == "aten::copy_"
    assert trace.innermost(host, starts, 55) == "lpbench.run"
    assert trace.innermost(host, starts, 150) is None


def test_trace_adds_busy_idle_and_kernels():
    t = trace.Trace()
    device = [(10, 20, "void block_csr_spmv_kernel<float>(float const*)"),
              (15, 25, "void block_csr_spmv_kernel<float>(float const*)"),
              (40, 50, "Memcpy DtoH (Device -> Pageable)"),
              (95, 130, "void gemv2N_kernel<int, int, double, double>")]
    host = [(0, 5, "lpbench.passModel"), (5, 100, "lpbench.run"),
            (26, 39, "aten::nonzero"), (60, 90, "cudaStreamSynchronize")]
    spans = [(0, 5, "passModel"), (5, 100, "run")]
    t.add(device, host, spans)
    # busy inside the spans: [10, 25] + [40, 50] + [95, 100]
    assert t.window_ns == 100 and t.busy_ns == 30
    assert t.idle_percent() == pytest.approx(70.0)
    # gaps [5, 10], [25, 40], [50, 95] of the run, labelled at their middle
    assert dict(t.idle) == {"passModel": 5, "run": 5,
                            "run: aten::nonzero": 15,
                            "run: cudaStreamSynchronize": 45}
    assert t.kernel_time("block_csr_spmv", 4) == (pytest.approx(20e-9), 2)
    assert t.kernel_time("block_csr_spmv", 8) == (0.0, 0)
    assert t.kernel_time("gemv", 8) == (pytest.approx(35e-9), 1)
    bd = t.breakdown()
    assert bd["device_ops"][0][0].startswith("void gemv2N")
    assert len(bd["idle_gaps"]) <= 10
    assert trace.float_bytes("Memcpy DtoH") is None
    # every host event, summed by name
    assert t.host_time("lpbench.run") == (pytest.approx(95e-9), 1)
    assert t.host_time("aten::nonzero") == (pytest.approx(13e-9), 1)
    assert t.host_time("no such span") == (0.0, 0)
    t.add([], [(0, 7, "aten::nonzero")], [(0, 7, "run")])
    assert t.host_time("aten::nonzero") == (pytest.approx(20e-9), 2)


def test_roofline_from_instance_bytes():
    st = {"m": 65536, "n": 65536, "nnz": 1534 * 128 * 128, "block": 128,
          "tiles": 1534}
    nbytes = yardstick.block_product_bytes(st, 4)
    # tiles, a column index a tile, 513 row pointers, x and y (f32)
    assert nbytes == 1534 * 16384 * 4 + 1534 * 4 + 513 * 4 + 2 * 65536 * 4
    # 0.0302 ms of bytes: a kernel at 0.0418 ms reads 72% of its roofline
    least = yardstick.least_seconds(nbytes)
    assert least * 1e3 == pytest.approx(0.0302, abs=5e-5)
    t = trace.Trace()
    t.kernels["void block_csr_spmv_kernel<float>(...)"] = [
        int(1000 * 0.0418e6), 1000]
    share = yardstick.roofline_percent(
        t, "block_csr_spmv", lambda item: yardstick.block_product_bytes(st, item))
    assert share == pytest.approx(100 * least / 0.0418e-3)
    assert yardstick.roofline_percent(t, "onehot_spmv", lambda i: 1.0) is None


def test_padding_rule_and_batch_bytes():
    assert [yardstick.padded(x) for x in (1, 128, 129, 2016, 4096, 4097,
                                          50000, 65536)] == \
        [128, 128, 256, 2048, 4096, 5120, 50176, 65536]
    st = {"m": 2016, "n": 2016, "count": 16}
    assert yardstick.dense_batch_product_bytes(st, 8) == \
        16 * (2048 * 2048 * 8 + 2 * 2048 * 8)
    sc = {"m": 50000, "n": 50000, "nnz": 499953}
    assert yardstick.scattered_product_bytes(sc, 4) == \
        499953 * 8 + 50177 * 4 + 2 * 50176 * 4
