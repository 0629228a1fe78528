"""The port's bootstrap of a job of several processes
(`highs_tpu_torch/parallel/distributed.py`, on torch.distributed).

Two real CPU processes join one gloo process group, all-reduce a sum,
build the job's global mesh and each hold one row block of the same
seeded matrix: K x gives each rank its own rows, and K' y (the partial
products all-reduced) equals scipy's a.T @ y on every rank."""
import os
import pathlib
import socket
import subprocess
import sys

import pytest
import torch

from highs_tpu_torch.parallel import distributed

REPO = pathlib.Path(__file__).resolve().parent.parent

_ENV = ("HIGHS_TPU_COORDINATOR", "HIGHS_TPU_NUM_PROCESSES",
        "HIGHS_TPU_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
        "RANK")

_WORKER = r"""
import os, sys
import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from highs_tpu_torch.parallel import shard_ops
from highs_tpu_torch.parallel.distributed import (bootstrap_multihost,
                                                  global_mesh)

pid, config, fmt, port = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                          sys.argv[4])
if config == "arguments":
    ok = bootstrap_multihost(coordinator="127.0.0.1:" + port,
                             num_processes=2, process_id=pid,
                             device="cpu")
else:  # the launcher's variables, set by the test
    ok = bootstrap_multihost(device="cpu")
assert ok, "expected a 2-process job"
assert bootstrap_multihost(device="cpu")  # idempotent
rank = dist.get_rank()
assert rank == pid and dist.get_world_size() == 2
t = torch.tensor([float(rank + 1)], dtype=torch.float64)
dist.all_reduce(t)
assert float(t) == 3.0, float(t)

mesh = global_mesh()
assert mesh.shape == {"rows": 2} and mesh.home == torch.device("cpu")
rng = np.random.default_rng(11)
m, n = 700, 500
a = sp.random(m, n, density=0.02, random_state=rng, format="csr")
x = rng.standard_normal(n)
y = rng.standard_normal(m)
before = shard_ops.REDUCTIONS
op, m_pad = shard_ops.make_row_sharded(a, mesh, "rows", fmt=fmt,
                                       dtype=torch.float64)
assert m_pad == 768 and len(op.shards) == 1
lo, hi = op.row_offset, op.row_offset + op.m_local
assert (lo, hi) == (rank * 384, (rank + 1) * 384)
x_pad = np.zeros(op.shape[1])
x_pad[:n] = x
y_pad = np.zeros(m_pad)
y_pad[:m] = y
mv = op.mv(torch.as_tensor(x_pad)).numpy()
want_mv = np.zeros(m_pad)
want_mv[:m] = a @ x
assert np.abs(mv - want_mv[lo:hi]).max() <= 1e-12
aty = op.rmv(torch.as_tensor(y_pad[lo:hi])).numpy()
err = np.abs(aty[:n] - a.T @ y).max()
assert err <= 1e-12, err
assert np.all(aty[n:] == 0.0)
assert shard_ops.REDUCTIONS == before + 1
dist.destroy_process_group()
print("proc %d ok: K'y err %.3e" % (pid, err))
"""


def test_single_process_bootstrap_is_a_noop(monkeypatch):
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    assert distributed.bootstrap_multihost() is False
    # one process: no coordinator, nothing to join, no card asked for
    assert distributed.bootstrap_multihost(num_processes=1) is False
    assert not torch.distributed.is_initialized()
    m = distributed.global_mesh(device="cpu")
    assert m.shape == {"rows": 1} and m.processes is None


@pytest.mark.parametrize("config,fmt", [("arguments", "ell"),
                                        ("torch variables", "blockcsr"),
                                        ("highs variables", "panelell")])
def test_two_gloo_processes_share_the_rows(tmp_path, config, fmt):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = {k: v for k, v in os.environ.items() if k not in _ENV}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    for pid in range(2):
        penv = dict(env)
        if config == "torch variables":
            penv.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                        WORLD_SIZE="2", RANK=str(pid))
        elif config == "highs variables":
            penv.update(HIGHS_TPU_COORDINATOR=f"127.0.0.1:{port}",
                        HIGHS_TPU_NUM_PROCESSES="2",
                        HIGHS_TPU_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(pid), config, fmt, str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=penv,
            cwd=str(REPO)))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            outs.append(out.decode())
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("distributed workers timed out:\n" + "\n".join(outs))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
    assert any("proc 0 ok" in o for o in outs)
    assert any("proc 1 ok" in o for o in outs)
