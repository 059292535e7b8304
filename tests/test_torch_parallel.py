"""The port's mesh, samplers and multi-process setup (parallel/mesh.py,
parallel/distributed.py, data/samplers.host_shard), the scoring service's
--data-parallel and --spatial modes, and the utilities bench_op and
trace_if_enabled, on the CPU: against the JAX package where it has the
same function (create_mesh's grid, pad_to_multiple, host_shard,
HostShardedSampler's partition and __len__ as tests/test_data_plane.py
holds them, the service's per-frame DISTS and ADISTS against JAX's
forwards on the same frames at 2e-5 / 1e-4), otherwise against the port's
single-device path. The service builds its mesh from
``parallel.mesh.local_devices``, patched here to CPU devices."""
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nerf_qa_torch.compat import pretrained as tpre
from nerf_qa_torch.config import DISTSConfig as TConfig
from nerf_qa_torch.data import samplers as tsamplers
from nerf_qa_torch.parallel import distributed as tdist
from nerf_qa_torch.parallel import mesh as tmesh
from nerf_qa_torch.tools import score as tscore
from nerf_qa_torch.tools import serve as tserve
from nerf_qa_torch.utils.benchtime import bench_op
from nerf_qa_torch.utils.profiling import TRACE_ENV, trace_if_enabled
from nerf_qa_tpu.config import ADISTSConfig as JAConfig
from nerf_qa_tpu.config import DISTSConfig as JConfig
from nerf_qa_tpu.core import adists as jadists
from nerf_qa_tpu.core import dists as jdists
from nerf_qa_tpu.data.samplers import host_shard as jhost_shard
from nerf_qa_tpu.parallel import mesh as jmesh
from tests.torch_parity import jax_params, np_params, one_torch_thread, torch_model  # noqa: F401

CPU = torch.device("cpu")


# -- the mesh ------------------------------------------------------------------

@pytest.mark.parametrize("n,mp", [(8, 1), (8, 2), (8, 4), (4, 4), (1, 1)])
def test_create_mesh_matches_jax_grid(n, mp):
    got = tmesh.create_mesh([CPU] * n, model_parallel=mp)
    want = jmesh.create_mesh(jax.devices()[:n], model_parallel=mp)
    assert got.shape == dict(want.shape)
    assert got.data_devices == [CPU] * (n // mp)
    assert got.primary == CPU and got.distinct_devices == [CPU] and got.group is None


@pytest.mark.parametrize("n,mp", [(8, 3), (6, 4), (0, 1), (4, 0)])
def test_create_mesh_rejects_an_indivisible_model_axis(n, mp):
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.create_mesh([CPU] * n, model_parallel=mp)


def test_local_devices_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.local_devices()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.create_mesh()


@pytest.mark.parametrize("n,m", [(0, 4), (1, 4), (4, 4), (5, 4), (7, 1), (33, 8)])
def test_pad_to_multiple_matches_jax(n, m):
    assert tmesh.pad_to_multiple(n, m) == jmesh.pad_to_multiple(n, m)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_shard_batch_splits_the_leading_axis_in_order(kind):
    mesh = tmesh.create_mesh([CPU] * 8, model_parallel=2)  # data axis 4
    a = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    b = np.arange(8, dtype=np.int64)
    if kind == "torch":
        a, b = torch.from_numpy(a), torch.from_numpy(b)
    shards = tmesh.shard_batch(mesh, {"a": a, "b": (b, None)})
    assert len(shards) == 4
    for i, s in enumerate(shards):
        assert torch.is_tensor(s["a"]) and s["b"][1] is None
        np.testing.assert_array_equal(s["a"].numpy(), np.asarray(a)[2 * i:2 * i + 2])
        np.testing.assert_array_equal(s["b"][0].numpy(), np.asarray(b)[2 * i:2 * i + 2])
    assert tmesh.data_sharding(mesh, 8) == [slice(0, 2), slice(2, 4), slice(4, 6),
                                            slice(6, 8)]
    with pytest.raises(ValueError, match="pad it to 8"):
        tmesh.shard_batch(mesh, a[:6])


def test_pad_tail_repeats_the_last_row():
    a = np.arange(6).reshape(3, 2)
    np.testing.assert_array_equal(tmesh.pad_tail(a, 2), a[[0, 1, 2, 2, 2]])
    t = torch.from_numpy(a)
    assert torch.equal(tmesh.pad_tail(t, 1), t[[0, 1, 2, 2]])


def test_replicate_shares_one_copy_per_distinct_device(torch_model):
    mesh = tmesh.create_mesh([CPU] * 4)
    reps = tmesh.replicate(mesh, torch_model)
    assert list(reps) == [CPU] and reps[CPU] is torch_model
    t = torch.ones(3)
    assert tmesh.replicate(mesh, t)[CPU] is t  # .to(its own device) is itself


def test_shard_group_sums_in_shard_order_with_gradients():
    group = tmesh.ShardGroup(3)
    xs = [torch.full((2,), float(i + 1), requires_grad=True) for i in range(3)]

    def body(i):
        assert threading.current_thread().name == f"shard-{i}"
        return group.sum(i, xs[i] * (i + 1))

    totals = group.run(body)
    assert all(torch.equal(t, torch.full((2,), 14.0)) for t in totals)
    sum(t.sum() for t in totals).backward()
    assert [float(x.grad[0]) for x in xs] == [3.0, 6.0, 9.0]


def test_shard_draws_and_batch_stats_are_the_global_batchs():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((4, 3, 5, 6)).astype(np.float32))
    x.requires_grad_(True)
    group = tmesh.ShardGroup(2)
    shards = [tmesh.Shard(group, i, slice(2 * i, 2 * i + 2), 4,
                          torch.Generator().manual_seed(9)) for i in range(2)]
    state = shards[0].get_state()
    stats = group.run(lambda i: shards[i].batch_stats(x[2 * i:2 * i + 2]))
    mean = x.mean(dim=(0, 2, 3))
    var = (x * x).mean(dim=(0, 2, 3)) - mean.square()
    for m, v in stats:
        torch.testing.assert_close(m, mean, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(v, var, rtol=1e-5, atol=1e-6)
    # the gradient reaches every shard's rows through the sum
    sum(m.sum() + v.sum() for m, v in stats).backward()
    assert all(float(x.grad[i].abs().sum()) > 0 for i in range(4))
    want = torch.rand((4, 3, 1, 1), generator=torch.Generator().manual_seed(9))
    assert torch.equal(torch.cat([s.rand((2, 3, 1, 1), CPU) for s in shards]), want)
    replay = shards[1].at(state)
    assert (replay.index, replay.rows, replay.group) == (1, slice(2, 4), group)
    assert torch.equal(replay.rand((2, 3, 1, 1), CPU), want[2:])


def test_shard_group_raises_a_shard_failure_without_hanging():
    group = tmesh.ShardGroup(2)

    def body(i):
        if i == 1:
            raise KeyError("shard 1")
        return group.sum(i, torch.ones(1))

    with pytest.raises(KeyError, match="shard 1"):
        group.run(body)


# -- samplers and multi-process setup ------------------------------------------

@pytest.mark.parametrize("n,count", [(10, 3), (4, 2), (7, 1), (3, 5)])
def test_host_shard_matches_jax_and_partitions(n, count):
    idx = list(range(n))
    shards = [tsamplers.host_shard(idx, h, count) for h in range(count)]
    assert shards == [jhost_shard(idx, h, count) for h in range(count)]
    assert sorted(sum(shards, [])) == idx


def test_host_sharded_sampler_partitions_and_covers():
    base = list(range(10))
    shards = [list(tdist.HostShardedSampler(base, host_id=i, host_count=3))
              for i in range(3)]
    assert sorted(sum(shards, [])) == base
    assert [len(s) for s in shards] == [4, 3, 3]
    assert [len(tdist.HostShardedSampler(base, host_id=i, host_count=3))
            for i in range(3)] == [4, 3, 3]


def test_host_sharded_sampler_follows_the_epoch():
    sampler = tsamplers.SceneBalancedSampler({"a": [0, 1, 2], "b": [3, 4, 5, 6]}, seed=1)
    hs = tdist.HostShardedSampler(sampler, host_id=1, host_count=2)
    for epoch in (0, 3):
        hs.set_epoch(epoch)
        assert list(hs) == list(sampler)[1::2]
    assert len(hs) == 3  # six indices a process pair


def test_maybe_initialize_noop_without_cluster(monkeypatch):
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert tdist.maybe_initialize() is False
    assert tdist.host_info() == (0, 1)
    assert len(tdist.HostShardedSampler(range(5))) == 5


def test_maybe_initialize_needs_the_world_size(monkeypatch):
    monkeypatch.setenv("COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.delenv("NUM_PROCESSES", raising=False)
    with pytest.raises(ValueError, match="NUM_PROCESSES"):
        tdist.maybe_initialize()


@pytest.mark.parametrize("cuda,cards,local,want", [
    (False, 0, None, "gloo"), (True, 1, None, "nccl"), (True, 1, "2", "gloo"),
    (True, 4, "4", "nccl"), (True, 2, "4", "gloo")])
def test_backend_comes_from_the_environment(monkeypatch, cuda, cards, local, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    assert tdist.default_backend() == want


def test_nr_loader_takes_its_process_slice(monkeypatch, tmp_path):
    from nerf_qa_torch.data.factories import create_nr_dataloader
    from nerf_qa_torch.tools import make_synthetic_dataset as tsynth
    from nerf_qa_torch.tools.train_nr import read_rows

    csv = tsynth.make_nr_tree(str(tmp_path), scenes=("chair", "drums"),
                              methods=("nerfacto",), frames=2, hw=(48, 48))
    rows = read_rows(csv)
    kw = dict(batch_size=1, num_workers=0, render_size=32, sem_size=28)
    whole = create_nr_dataloader(rows, str(tmp_path), **kw)
    monkeypatch.setattr(tdist, "host_info", lambda: (1, 2))
    mine = create_nr_dataloader(rows, str(tmp_path), host_sharded=True, **kw)
    assert isinstance(mine.sampler, tdist.HostShardedSampler)
    assert list(mine.sampler) == list(whole.sampler)[1::2]
    assert len(mine) == len(whole) // 2


# -- the service over a mesh -----------------------------------------------------

def _frames(n, h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([yy / h, xx / w, (yy + xx) / (h + w)], axis=-1)
    ref = np.clip(base[None] * 0.8 + rng.normal(0, 0.03, (n, h, w, 3)), 0, 1)
    dist = np.clip(ref + 0.1 + rng.normal(0, 0.05, ref.shape), 0, 1)
    return [(f * 255).astype(np.uint8) for f in (ref, dist)]


@pytest.fixture(scope="module")
def pair_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_parallel")
    dirs = []
    for name, frames in zip(("ref", "dist"), _frames(2, 32, 48, 0)):
        (root / name).mkdir()
        for i, f in enumerate(frames):
            Image.fromarray(f).save(root / name / f"{i:03d}.png")
        dirs.append(str(root / name))
    return dirs


@pytest.fixture(scope="module")
def jax_scores(jax_params, pair_dirs):
    """Per-frame DISTS and ADISTS of the request's frames (the distorted
    frame as x), by the JAX package's forwards in fp32."""
    ref_dir, dist_dir = pair_dirs
    d = jnp.asarray(tscore._load_frames(dist_dir, resize=False, keep_aspect=False))
    r = jnp.asarray(tscore._load_frames(ref_dir, resize=False, keep_aspect=False))
    # under jit, as the JAX service runs them (eager ADISTS takes ~20 s here)
    return (np.asarray(jax.jit(lambda a, b: jdists.forward(
                jax_params, jdists.load_pretrained_weights(), a, b, JConfig()))(d, r)),
            np.asarray(jax.jit(lambda a, b: jadists.forward(
                jax_params, a, b, JAConfig(), as_loss=False))(d, r)))


@pytest.mark.parametrize("flags,devices,batch", [
    (["--data-parallel"], 2, 4),  # batch 3 rounded up to the data axis
    (["--spatial", "2", "--full-size"], 4, 4),  # data 2 x model 2
])
def test_service_over_a_mesh_matches_jax(torch_model, pair_dirs, jax_scores, monkeypatch,
                                         flags, devices, batch):
    monkeypatch.setattr(tmesh, "local_devices", lambda: [CPU] * devices)
    args = tserve.build_parser().parse_args(
        ["--stdio", "--fp32", "--metric", "both", "--batch-size", "3", *flags])
    svc = tserve.ScoringService(args, torch_model, tpre.resolve_dists_weights(TConfig()))
    try:
        assert svc.mesh is not None and svc.mesh.shape["model"] == devices // (
            2 if "--spatial" in flags else devices)
        assert {b.batch_size for b in svc.batchers.values()} == {batch}
        ref_dir, dist_dir = pair_dirs
        got = svc.handle({"id": 7, "dist": dist_dir, "ref": ref_dir})
    finally:
        svc.close()
    assert "error" not in got, got
    want_d, want_a = jax_scores
    assert got["frames"] == 2
    np.testing.assert_allclose(got["dists_frames"], want_d, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got["adists_frames"], want_a, rtol=1e-4, atol=1e-4)


def test_service_spatial_needs_full_size(torch_model, monkeypatch):
    monkeypatch.setattr(tmesh, "local_devices", lambda: [CPU] * 2)
    args = tserve.build_parser().parse_args(["--stdio", "--spatial", "2"])
    with pytest.raises(SystemExit, match="--full-size"):
        tserve.ScoringService(args, torch_model, tpre.resolve_dists_weights(TConfig()))


def test_service_spatial_refuses_unaligned_frames(torch_model, tmp_path, monkeypatch):
    # 1080-row frames do not split: the request fails, the service stays up
    monkeypatch.setattr(tmesh, "local_devices", lambda: [CPU] * 2)
    for name, frames in zip(("ref", "dist"), _frames(1, 40, 48, 1)):
        (tmp_path / name).mkdir()
        Image.fromarray(frames[0]).save(tmp_path / name / "000.png")
    args = tserve.build_parser().parse_args(
        ["--stdio", "--fp32", "--spatial", "2", "--full-size", "--batch-size", "1"])
    svc = tserve.ScoringService(args, torch_model, tpre.resolve_dists_weights(TConfig()))
    try:
        got = svc.handle({"id": 1, "dist": str(tmp_path / "dist"),
                          "ref": str(tmp_path / "ref")})
    finally:
        svc.close()
    assert "H % 32 == 0" in got["error"]


# -- the utilities ----------------------------------------------------------------

def test_bench_op_times_back_to_back_runs_on_the_cpu():
    calls = []

    def op(v):
        calls.append(1)
        return (v * 2.0).sum()

    dt = bench_op(op, torch.ones((4, 8, 8, 3)), iters=3)
    assert dt > 0.0 and len(calls) == 4  # one warm-up, three timed
    assert bench_op(lambda v: None, torch.ones(2), iters=2, warmup=False) >= 0.0


def test_trace_if_enabled_writes_a_trace_only_when_asked(tmp_path, monkeypatch):
    monkeypatch.delenv(TRACE_ENV, raising=False)
    with trace_if_enabled():
        (torch.ones(8) * 2).sum()
    assert not any(tmp_path.iterdir())
    for where in ("arg", "env"):
        out = tmp_path / where
        if where == "env":
            monkeypatch.setenv(TRACE_ENV, str(out))
        with trace_if_enabled(str(out) if where == "arg" else None):
            (torch.ones(8) * 2).sum()
        traces = list(out.glob("*.pt.trace.json"))
        assert len(traces) == 1
        events = json.loads(traces[0].read_text())["traceEvents"]
        assert any("aten::mul" in str(e.get("name", "")) for e in events)
    assert TRACE_ENV != "NERF_QA_TPU_TRACE_DIR" and os.environ[TRACE_ENV]
