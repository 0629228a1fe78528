"""The gather-rate probe: its shapes are the JAX probes', and its plain
version on the CPU is `torch.gather`.  The CUDA kernel runs only on a
card: its test holds it to exact equality there and skips elsewhere
(`python -m pytest --noconftest tests/test_torch_gather_probe.py` on a
machine with a card)."""
import pytest
import torch

from highs_tpu_torch.tools import gather_probe as gp

# the tests run in parallel worker processes on shared cores: torch's
# own thread pool in each of them would oversubscribe the machine
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def test_shapes_are_the_jax_probes():
    # tools/gather_probe.py:49-53 and tools/gather_probe2.py:72-77
    got = [(t, i, k) for _, t, i, k in gp.SHAPES]
    assert got[:2] == [((128, 128), (128, 4352), 128),
                       ((128, 512), (128, 4352), 512)]
    same = [((128, 128), 128), ((128, 256), 128), ((128, 256), 256),
            ((128, 4352), 128), ((128, 4352), 4352), ((256, 4352), 128)]
    assert got[2:] == [(s, s, k) for s, k in same]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_version_on_cpu(dtype):
    table, idx = gp.probe_inputs((16, 40), (16, 300), 40, dtype, "cpu")
    before = gp.LAUNCHES
    out = gp.gather_probe(table, idx)
    assert gp.LAUNCHES == before  # the plain version is no launch
    for s in range(16):
        assert torch.equal(out[s], table[s][idx[s].long()])


def test_wrapper_checks_its_inputs():
    table, idx = gp.probe_inputs((4, 8), (4, 10), 8, torch.float64, "cpu")
    with pytest.raises(TypeError):
        gp.gather_probe(table, idx.long())
    with pytest.raises(TypeError):
        gp.gather_probe(table.int(), idx)
    with pytest.raises(ValueError):
        gp.gather_probe(table, idx[:3])
    with pytest.raises(ValueError):
        gp.gather_probe(table, idx[:, ::2])  # not contiguous


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_equals_torch_gather_on_card(cuda_device, dtype):
    for _, t_shape, i_shape, idx_max in gp.SHAPES:
        table, idx = gp.probe_inputs(t_shape, i_shape, idx_max, dtype,
                                     cuda_device)
        before = gp.LAUNCHES
        out = gp.gather_probe(table, idx)
        torch.cuda.synchronize()
        assert gp.LAUNCHES == before + 1
        assert torch.equal(out, gp.gather_plain(table, idx))
