"""The port's scoring service (tools/serve.py) against the JAX package's on
the CPU: the same requests through both services on bridged VGG weights
(--fp32 --metric both --batch-size 2; per-frame DISTS at atol 1e-4, ADISTS
at test_torch_adists.py's 1e-4), an mp4 request against its
frame-directory twin, the stdio and HTTP transports, bad requests,
FrameBatcher's coalescing, splitting and error isolation (as
tests/test_serve.py), concurrent HTTP clients sharing device batches, the
multi-device options' error without CUDA, and an NR request against the port's
``score --nr`` on the same frames."""
import io
import json
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from nerf_qa_torch.compat import pretrained as tpre
from nerf_qa_torch.config import DISTSConfig as TConfig
from nerf_qa_torch.config import NRModelConfig as TNRConfig
from nerf_qa_torch.data import imaging as timg
from nerf_qa_torch.data import native
from nerf_qa_torch.data import video as tvid
from nerf_qa_torch.models.nr.decoder import NRDecoder
from nerf_qa_torch.models.nr.layers import init_lecun_normal_
from nerf_qa_torch.tools import score as tscore
from nerf_qa_torch.tools import serve as tserve
from nerf_qa_tpu.compat.pretrained import resolve_dists_weights as jresolve_weights
from nerf_qa_tpu.config import DISTSConfig as JConfig
from nerf_qa_tpu.tools import serve as jserve
from tests.torch_parity import (  # noqa: F401
    NR_RENDER,
    NR_SEM,
    jax_params,
    np_params,
    nr_config,
    one_torch_thread,
    torch_model,
)


def _gradient(h=64, w=64, shift=0.0):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([yy / h, xx / w, (yy + xx) / (h + w)], axis=-1)
    return np.clip(img * 0.8 + shift, 0, 1)


def _frames(n=3, h=64, w=64, seed=0):
    """(ref, dist) uint8 frame stacks: textured gradients and a shifted,
    noisier copy."""
    rng = np.random.default_rng(seed)
    ref = np.stack([np.clip(_gradient(h, w, 0.01 * i)
                            + rng.normal(0, 0.03, (h, w, 3)), 0, 1)
                    for i in range(n)])
    dist = np.clip(ref + 0.1 + rng.normal(0, 0.05, ref.shape), 0, 1)
    return [(f * 255).astype(np.uint8) for f in (ref, dist)]


def _write_dir(path, frames, ext="png"):
    path.mkdir(parents=True)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(path / f"{i:03d}.{ext}", quality=90)
    return str(path)


@pytest.fixture(scope="module")
def pair_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    ref, dist = _frames()
    return _write_dir(root / "ref", ref), _write_dir(root / "dist", dist)


def _args(*extra):
    return tserve.build_parser().parse_args(["--stdio", "--device", "cpu", *extra])


@pytest.fixture(scope="module")
def service(torch_model):
    svc = tserve.ScoringService(_args("--fp32", "--metric", "both", "--batch-size", "2"),
                                torch_model, tpre.resolve_dists_weights(TConfig()))
    yield svc
    svc.close()


@pytest.fixture(scope="module")
def jax_service(jax_params):
    args = jserve.build_parser().parse_args(
        ["--stdio", "--fp32", "--metric", "both", "--batch-size", "2"])
    return jserve.ScoringService(args, jax_params, jresolve_weights(JConfig(), None))


def test_service_matches_jax_service(service, jax_service, pair_dirs):
    ref_dir, dist_dir = pair_dirs
    req = {"id": "a", "dist": dist_dir, "ref": ref_dir}
    got, want = service.handle(req), jax_service.handle(req)
    assert "error" not in got and "error" not in want, (got, want)
    assert got["id"] == "a" and got["frames"] == want["frames"] == 3
    assert set(got) == set(want)
    np.testing.assert_allclose(got["dists_frames"], want["dists_frames"], atol=1e-4)
    np.testing.assert_allclose(got["adists_frames"], want["adists_frames"], atol=1e-4)
    assert abs(got["dists"] - want["dists"]) <= 1e-4
    assert 0.0 < got["dists"] < 1.0 and 0.0 < got["adists"] < 1.0


def test_mp4_request_equals_its_frame_directory_twin(service, tmp_path):
    if not native.available():
        pytest.skip(f"native decoder not built: {native.unavailable_reason()}")
    ref, dist = _frames(n=3, h=96, w=112, seed=1)
    tvid.write_mjpeg_mp4(str(tmp_path / "ref.mp4"), ref)
    tvid.write_mjpeg_mp4(str(tmp_path / "dist.mp4"), dist)
    # the muxer's samples are PIL's JPEG bytes at quality 90
    ref_dir = _write_dir(tmp_path / "ref", ref, "jpg")
    dist_dir = _write_dir(tmp_path / "dist", dist, "jpg")
    before = timg.pil_fallbacks
    got = service.handle({"id": 1, "dist": str(tmp_path / "dist.mp4"),
                          "ref": str(tmp_path / "ref.mp4")})
    want = service.handle({"id": 1, "dist": dist_dir, "ref": ref_dir})
    assert "error" not in got, got
    assert got == want
    assert timg.pil_fallbacks == before


def test_stdio_roundtrip(service, pair_dirs):
    ref_dir, dist_dir = pair_dirs
    lines = [
        json.dumps({"id": "a", "dist": dist_dir, "ref": ref_dir}),
        "not json at all",
        json.dumps({"id": "b", "dist": dist_dir + "/missing.png", "ref": ref_dir}),
        "",
    ]
    before = service.stats()
    out = io.StringIO()
    assert tserve.serve_stdio(service, lines=lines, out=out) == 0
    resp = [json.loads(line) for line in out.getvalue().splitlines()]
    assert len(resp) == 3
    ok = resp[0]
    assert ok["id"] == "a" and ok["frames"] == 3
    assert 0.0 < ok["dists"] < 1.0 and len(ok["dists_frames"]) == 3
    assert 0.0 < ok["adists"] < 1.0 and len(ok["adists_frames"]) == 3
    assert resp[1]["id"] is None and "JSONDecodeError" in resp[1]["error"]
    assert resp[2]["id"] == "b" and "error" in resp[2]
    stats = service.stats()
    assert stats["requests"] == before["requests"] + 1
    assert stats["frames"] == before["frames"] + 3
    assert stats["device_fps"] > 0


def _serve_http(svc):
    server = tserve.make_http_server(svc, 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def _post(port, payload, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/score", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def test_http_roundtrip(service, pair_dirs):
    ref_dir, dist_dir = pair_dirs
    server, port = _serve_http(service)
    assert server.request_queue_size >= 32  # a burst of clients is queued
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            health = json.loads(r.read())
        assert health["ok"] is True and "queue_depth" in health
        resp = _post(port, [{"id": 7, "dist": dist_dir, "ref": ref_dir}])
        assert isinstance(resp, list) and resp[0]["id"] == 7
        assert 0.0 < resp[0]["dists"] < 1.0
        single = _post(port, {"id": 8, "dist": dist_dir, "ref": ref_dir})
        assert single["dists_frames"] == resp[0]["dists_frames"]
        with pytest.raises(urllib.error.HTTPError, match="404"):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope")
    finally:
        server.shutdown()
        server.server_close()


def test_nr_request_without_ckpt_errors(service, pair_dirs):
    _, dist_dir = pair_dirs
    resp = service.handle({"id": "x", "dist": dist_dir})
    assert resp["id"] == "x" and "--nr-ckpt" in resp["error"]


def test_non_object_requests_do_not_kill_the_service(service, pair_dirs):
    out = io.StringIO()
    lines = ["42", '"hello"', "[1, 2]", "null"]
    assert tserve.serve_stdio(service, lines=lines, out=out) == 0
    resp = [json.loads(line) for line in out.getvalue().splitlines()]
    assert len(resp) == 4 and all("error" in r for r in resp)
    ref_dir, dist_dir = pair_dirs  # still serving
    assert "error" not in service.handle({"id": 1, "dist": dist_dir, "ref": ref_dir})


@pytest.mark.parametrize("flag", [["--data-parallel"], ["--spatial", "2", "--full-size"]])
def test_multi_device_options_raise_naming_item_14(torch_model, flag, monkeypatch):
    # ported since (tests/test_torch_parallel.py serves with them): the
    # multi-device options build a mesh over the local GPUs, and without
    # CUDA they raise rather than carry on on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.ScoringService(_args(*flag), torch_model, tpre.resolve_dists_weights())


# -- cross-request dynamic batching ------------------------------------------

def test_frame_batcher_coalesces_and_splits():
    """Requests queued while the device is busy share the next batch;
    per-frame results scatter back to the right requests in order."""
    release = threading.Event()
    first_entered = threading.Event()
    grad_enabled = []

    def step(x):
        first_entered.set()
        grad_enabled.append(torch.is_grad_enabled())
        assert release.wait(timeout=30)
        return torch.from_numpy(x[:, 0])  # identity score: a tensor

    b = tserve.FrameBatcher(step, batch_size=4, device_lock=threading.Lock(),
                            name="test")
    arrays = [np.arange(2, dtype=np.float32).reshape(2, 1) + 10 * i
              for i in range(4)]
    results = {}

    def client(i):
        results[i] = b.score(arrays[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    threads[0].start()
    assert first_entered.wait(timeout=30)  # dispatcher busy with request 0
    for t in threads[1:]:
        t.start()
    for _ in range(500):  # the 3 late requests (6 frames) queue behind it
        if b.queue_depth() == 6:
            break
        time.sleep(0.01)
    assert b.queue_depth() == 6
    release.set()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    # step 1: request 0 alone (padded); step 2: requests 1+2 coalesced;
    # step 3: request 3 (padded)
    assert b.device_steps == 3 and b.frames_stepped == 8
    assert grad_enabled == [False] * 3  # autograd off in the dispatcher
    for i in range(4):
        np.testing.assert_allclose(results[i], arrays[i][:, 0])
    b.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        b.score(arrays[0])


def test_frame_batcher_splits_large_request():
    b = tserve.FrameBatcher(lambda x: x[:, 0], batch_size=4,
                            device_lock=threading.Lock(), name="split")
    arr = np.arange(10, dtype=np.float32).reshape(10, 1)
    np.testing.assert_allclose(b.score(arr), arr[:, 0])
    assert b.device_steps == 3  # 4 + 4 + 2 (padded)
    b.stop()


def test_frame_batcher_error_poisons_only_that_request():
    def step(x):
        if x[0, 0] < 0:
            raise ValueError("bad frame")
        return x[:, 0]

    b = tserve.FrameBatcher(step, batch_size=2, device_lock=threading.Lock(),
                            name="err")
    with pytest.raises(ValueError, match="bad frame"):
        b.score(np.full((2, 1), -1.0, np.float32))
    np.testing.assert_allclose(b.score(np.ones((2, 1), np.float32)), [1.0, 1.0])
    b.stop()


def test_http_concurrent_requests_share_device_batches(torch_model, pair_dirs):
    """8 concurrent HTTP clients x 3-frame requests coalesce into shared
    batches of 16: device_steps < requests in /healthz."""
    ref_dir, dist_dir = pair_dirs
    svc = tserve.ScoringService(_args("--fp32", "--metric", "dists", "--batch-size", "16"),
                                torch_model, tpre.resolve_dists_weights())
    svc.warmup((64, 64))  # one (16, 64, 64, 3) step; counters reset
    assert svc.stats()["requests"] == 0 and svc.stats()["device_steps"] == 0
    server, port = _serve_http(svc)
    n_clients = 8
    responses = [None] * n_clients

    def client(i):
        responses[i] = _post(port, {"id": i, "dist": dist_dir, "ref": ref_dir})

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert all(r is not None and 0.0 < r["dists"] < 1.0 for r in responses), responses
        # identical inputs -> identical scores whichever batch they rode in
        for r in responses[1:]:
            np.testing.assert_allclose(r["dists_frames"], responses[0]["dists_frames"],
                                       atol=1e-5)
        stats = svc.stats()
        assert stats["requests"] == n_clients and stats["frames"] == 3 * n_clients
        assert 1 <= stats["device_steps"] < n_clients, stats
        assert stats["queue_depth"] == 0
        assert stats["latency_ms_p95"] >= stats["latency_ms_p50"] is not None
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


def test_main_stdio_on_cpu(pair_dirs, monkeypatch, capsys):
    ref_dir, dist_dir = pair_dirs
    for env in (tpre.ENV_VGG, tpre.ENV_DISTS):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        json.dumps({"id": 1, "dist": dist_dir, "ref": ref_dir}) + "\n42\n"))
    assert tserve.main(["--stdio", "--metric", "dists", "--batch-size", "2",
                        "--no-warmup", "--device", "cpu"]) == 0
    resp = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert resp[0]["id"] == 1 and resp[0]["frames"] == 3 and "error" in resp[1]


def test_nr_request_matches_score_nr(pair_dirs, tmp_path, monkeypatch, capsys):
    # the service's NR path and the score CLI's on one reference-layout
    # .pth at a small depth (ViT depth 1, 64² / 56² inputs): the same
    # per-frame scores (the CSV holds 6 decimals)
    _, dist_dir = pair_dirs
    monkeypatch.setattr(tscore, "NR_SIZES", (NR_RENDER, NR_SEM))
    for env in (tpre.ENV_VGG, tpre.ENV_VIT, tpre.ENV_JBU, tpre.ENV_DISTS):
        monkeypatch.delenv(env, raising=False)
    decoder = init_lecun_normal_(NRDecoder(nr_config(TNRConfig)),
                                 torch.Generator().manual_seed(4))
    pth = str(tmp_path / "model.pth")
    torch.save(dict(decoder.state_dict()), pth)
    arch = ["--nr-ckpt", pth, "--vit-depth", "1", "--transformer-decoder-depth", "1",
            "--batch-size", "2", "--device", "cpu"]
    svc = tserve.ScoringService(
        tserve.build_parser().parse_args(["--stdio", "--metric", "dists", *arch]),
        tpre.resolve_vgg_params(), tpre.resolve_dists_weights())
    try:
        svc.warmup((32, 32))
        got = svc.handle({"id": "nr1", "dist": dist_dir})
    finally:
        svc.close()
    assert "error" not in got, got
    assert got["id"] == "nr1" and got["frames"] == 3 and np.isfinite(got["nr"])
    csv = tmp_path / "nr.csv"
    assert tscore.main(["--nr", "--dist", dist_dir, "--json", "--out-csv", str(csv),
                        *arch]) == 0
    want = np.loadtxt(csv, delimiter=",", skiprows=1)[:, 1]
    np.testing.assert_allclose(got["nr_frames"], want, atol=1e-6)
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert abs(summary["nr"]["video_score"] - got["nr"]) <= 1e-6
