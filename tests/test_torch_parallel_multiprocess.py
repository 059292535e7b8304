"""Processes of the port on the CPU, over gloo (the port of
tests/test_multihost.py, which the JAX package slow-marks): two spawned
processes join one world through ``parallel.distributed.maybe_initialize``
and take one data-parallel FR step (tests/torch_multihost_worker.py)
whose gradient all_reduce crosses the process boundary: their sampler
slices are disjoint and cover the set, both end with bit-identical
parameters, and those match one process's unsharded step on the whole
batch (rtol 1e-5). And ``tools.train_nr`` under the same environment
variables: each process joins the world and trains on its slice."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from tests import torch_multihost_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240  # seconds a spawned process may take


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(argv, n=2, **env):
    base = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}",
                NUM_PROCESSES=str(n), PYTHONPATH=REPO, OMP_NUM_THREADS="1", **env)
    procs = [subprocess.Popen(argv, env=dict(base, PROCESS_ID=str(i)), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), (
        [p.returncode for p in procs], *(o[-3000:] for o in outs))
    return outs


def _lines(out, tag):
    return [line for line in out.splitlines() if line.startswith(tag)]


def test_two_process_fr_dp_step():
    outs = _spawn([sys.executable, os.path.join(REPO, "tests", "torch_multihost_worker.py")])
    assert all(_lines(o, "BACKEND") == ["BACKEND gloo 2"] for o in outs)
    shard0 = eval(_lines(outs[0], "SHARD 0 ")[0].split(" ", 2)[2])
    shard1 = eval(_lines(outs[1], "SHARD 1 ")[0].split(" ", 2)[2])
    assert set(shard0).isdisjoint(shard1)
    assert sorted(shard0 + shard1) == [0, 1, 2, 3]
    assert _lines(outs[0], "LOSS") == _lines(outs[1], "LOSS")
    p0, p1 = _lines(outs[0], "PARAMS"), _lines(outs[1], "PARAMS")
    assert p0 and p0 == p1, f"params diverged across processes:\n{p0}\nvs\n{p1}"

    # one process, no mesh: the step over the whole batch, in the global
    # row order (process 0's rows, then process 1's)
    order = np.asarray(shard0 + shard1)
    dist_imgs, ref, targets, fx, fy = worker.global_batch()
    trainer = worker.make_trainer("cpu")
    params, opt_state = trainer.init(fx, fy)
    params, _, loss, _ = trainer.train_step(params, opt_state, dist_imgs[order],
                                            ref[order], targets[order])
    got_loss = float(_lines(outs[0], "LOSS")[0].split()[1])
    assert abs(got_loss - float(loss)) <= 1e-5 * abs(float(loss))
    for got, want in zip(p0, worker.param_lines(params)):
        name, g = got.split("=")
        assert name == want.split("=")[0]
        for a, b in zip(g.split("/"), want.split("=")[1].split("/")):
            assert abs(float(a) - float(b)) <= 1e-5 * max(abs(float(b)), 1e-3), (got, want)


def test_train_nr_under_cluster_env_trains_each_slice(tmp_path):
    from nerf_qa_torch.tools import make_synthetic_dataset as tsynth

    root = tmp_path / "nr"
    csv = tsynth.make_nr_tree(str(root), scenes=("chair", "drums"), methods=("nerfacto",),
                              frames=2, hw=(48, 48))
    # each process writes its own run directory, RUN_ROOT/<PROCESS_ID>
    code = ("import os, sys; from nerf_qa_torch.tools import train_nr; "
            "sys.exit(train_nr.main(sys.argv[1:] + ['--output-dir', os.path.join("
            "os.environ['RUN_ROOT'], os.environ['PROCESS_ID'])]))")
    argv = [sys.executable, "-c", code, "--data-dir", str(root), "--scores-csv", csv,
            "--epochs", "1", "--vit-depth", "1", "--refine-up-depth", "1",
            "--transformer-decoder-depth", "0", "--render-size", "32", "--sem-size", "28",
            "--batch-size", "1", "--num-workers", "0", "--device", "cpu"]
    outs = _spawn(argv, RUN_ROOT=str(tmp_path / "runs"))
    for rank, out in enumerate(outs):
        assert f"multi-host: process {rank}/2" in out, out[-2000:]
        assert "epoch 0:" in out
        assert os.path.isdir(tmp_path / "runs" / str(rank) / "ckpt")


@pytest.mark.parametrize("env", [{}, {"COORDINATOR_ADDRESS": "127.0.0.1:1"}])
def test_worker_without_a_world_size_or_address_fails(env):
    # no address: nothing to join; an address without NUM_PROCESSES: an error
    clean = {k: v for k, v in os.environ.items()
             if k not in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS", "NUM_PROCESSES")}
    out = subprocess.run([sys.executable, os.path.join(REPO, "tests",
                                                       "torch_multihost_worker.py")],
                         env=dict(clean, PYTHONPATH=REPO, **env), cwd=REPO,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode != 0
    assert ("NUM_PROCESSES" in out.stderr) == bool(env)
