"""Persistent scoring service: keep the DISTS/ADISTS/NR pipeline warm on
the GPU and stream scoring requests through it.

Counterpart of ``nerf_qa_tpu/tools/serve.py``. The reference has no
serving story — every evaluation is a cold script run that rebuilds the
model (run_test2.py:278-297). A resident process loads the weights and
builds the CUDA kernels once, picks cuDNN's algorithms on a warm-up batch,
then scores request streams at the card's steady-state rate.

Two transports, both line-oriented JSON so any client can drive them:

* ``--stdio``: read one JSON request per stdin line, write one JSON
  response per stdout line (the subprocess/sidecar integration mode).
* ``--http PORT``: ThreadingHTTPServer with POST /score (same request
  schema, a JSON object or list of them) and GET /healthz (liveness,
  throughput counters, request-latency p50/p95, queue depth). Decode and
  HTTP parsing run in the request threads; device work funnels through
  per-path FrameBatchers (below). ``--http 0`` binds a free port.

Cross-request dynamic batching: frames from CONCURRENT requests coalesce
into shared fixed-shape device batches (one dispatcher thread per metric
path drains a queue into batches of exactly --batch-size frames, pads
only when the queue runs dry, and scatters per-frame scores back to the
waiting requests). /healthz's device_steps < requests shows it engaged.

Paths on the card: DISTS through ``FrameScorer`` with the moments kernel
(both dtypes), ADISTS through ``tools.score.adists_batch`` with the
windowed T/S kernel (the distorted frame as ``x``, as the JAX service
does), NR through ``tools.score.NRScorer`` (the JBU and ChannelNorm
kernels). Frames are resized on the host by the decoder
(``tools.score._load_frames``); the device scores them as they come.

Request schema:  {"id": any, "dist": path, "ref": path}
  ``dist``/``ref``: image file, frame directory, or mp4 (MJPEG mp4s
  decode natively; see data/video.py). Frames pair up in sorted order.
  A request WITHOUT "ref" takes the no-reference path (requires starting
  the service with --nr-ckpt, a reference-layout NR ``.pth``;
  train-nr.py:299-375 test-loop semantics).
Response:        {"id", "frames": N, "dists": mean, "dists_frames": [...]}
  plus ``"adists"``/``"adists_frames"`` with --metric both|adists, or
  {"id", "frames", "nr", "nr_frames"} for no-reference requests, or
  {"id", "error": msg} for malformed requests (the service stays up).

--data-parallel splits DISTS and ADISTS request batches over every
visible GPU (a ``parallel.mesh`` data mesh, batches rounded up to a
multiple of the device count); NR requests run on the first device.
--spatial N additionally splits frame HEIGHT N ways for full-resolution
scoring (``--full-size``), DISTS and ADISTS (``parallel/spatial.py``:
halo-exchanged pyramid, per-slab moments, channel-blocked ADISTS
statistics); frames need H % (16·N) == 0 and W % 16 == 0.

Example:
  python -m nerf_qa_torch.tools.serve --stdio --metric dists <<'EOF'
  {"id": 1, "dist": "render_dir", "ref": "gt_dir"}
  EOF
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import threading
import time

import numpy as np
import torch

from nerf_qa_torch.compat import pretrained
from nerf_qa_torch.config import ADISTSConfig, DISTSConfig, resolve_device
from nerf_qa_torch.eval.video_scorer import FrameScorer, _prep
from nerf_qa_torch.parallel import mesh as meshlib
from nerf_qa_torch.parallel.spatial import spatial_adists_forward
from nerf_qa_torch.tools.score import (
    NRScorer,
    _load_frames,
    adists_batch,
    load_nr_model,
)


def _host(scores) -> np.ndarray:
    """Per-frame scores (a tensor on any device, or an array) as float32
    numpy; the copy waits for the device."""
    if isinstance(scores, torch.Tensor):
        return scores.float().cpu().numpy()
    return np.asarray(scores, np.float32)


class FrameBatcher:
    """Cross-request dynamic batching for one scoring path.

    Requests enqueue per-frame input arrays and block; a single
    dispatcher thread drains the queue into fixed-shape batches of
    exactly ``batch_size`` frames (splitting large requests, coalescing
    concurrent small ones, padding by repeating the last row only when
    the queue runs dry), runs one device step per batch under the shared
    ``device_lock`` with autograd off (grad mode is per thread, so the
    caller's ``no_grad`` does not reach this one), copies the scores to
    the host inside the lock, and scatters them back. ``no_grad`` rather
    than ``inference_mode``: a step fills per-process caches
    (``ops.windowed._band_matrix``), and an inference tensor there would
    break a later autograd use of it in the same process. No
    batching window is imposed: an idle device dispatches a lone request
    immediately (latency-first), while a busy device naturally
    accumulates arrivals into full batches (throughput under load).
    ``device_s`` sums the steps' time inside the lock.

    Inputs of different frame shapes (--full-size mode) never mix: the
    queue is keyed by the non-batch shape tuple.
    """

    def __init__(self, step_fn, batch_size: int, device_lock,
                 name: str = "path"):
        self.step_fn = step_fn
        self.batch_size = int(batch_size)
        self.device_lock = device_lock
        self.name = name
        self._cond = threading.Condition()
        self._queues: dict[tuple, collections.deque] = {}
        self.device_steps = 0
        self.frames_stepped = 0  # real (unpadded) frames
        self.device_s = 0.0
        self._stopped = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"batcher-{name}"
        )
        self._thread.start()

    def queue_depth(self) -> int:
        with self._cond:
            return sum(e["n"] - e["taken"]
                       for q in self._queues.values() for e in q)

    def score(self, *arrays: np.ndarray) -> np.ndarray:
        """Blockingly score N frames (equal-length input arrays);
        returns (N,) float32 per-frame scores."""
        n = int(arrays[0].shape[0])
        entry = {
            "arrays": arrays, "n": n, "taken": 0,
            "out": np.empty((n,), np.float32), "filled": 0,
            "event": threading.Event(), "error": None,
        }
        key = tuple(a.shape[1:] for a in arrays)
        with self._cond:
            if self._stopped:
                raise RuntimeError(f"batcher {self.name} is stopped")
            self._queues.setdefault(key, collections.deque()).append(entry)
            self._cond.notify()
        entry["event"].wait()
        if entry["error"] is not None:
            raise entry["error"]
        return entry["out"]

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout=10)

    # -- dispatcher --------------------------------------------------------
    def _take_batch(self):
        """(entry, start, count) slices totalling <= batch_size frames of
        one shape key. Caller holds the condition."""
        key = next((k for k, q in self._queues.items() if q), None)
        if key is None:
            return []
        q = self._queues[key]
        takers, space = [], self.batch_size
        while q and space > 0:
            e = q[0]
            take = min(space, e["n"] - e["taken"])
            takers.append((e, e["taken"], take))
            e["taken"] += take
            space -= take
            if e["taken"] == e["n"]:
                q.popleft()
        return takers

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._stopped and not any(self._queues.values()):
                    self._cond.wait()
                if self._stopped and not any(self._queues.values()):
                    return
                takers = self._take_batch()
            if not takers:
                continue
            n_in = len(takers[0][0]["arrays"])
            batch = []
            real = sum(t for _, _, t in takers)
            for i in range(n_in):
                parts = [e["arrays"][i][s:s + t] for e, s, t in takers]
                b = parts[0] if len(parts) == 1 else np.concatenate(parts)
                if real < self.batch_size:
                    b = np.concatenate(
                        [b, np.repeat(b[-1:], self.batch_size - real, 0)]
                    )
                batch.append(b)
            err = None
            try:
                with self.device_lock, torch.no_grad():
                    t0 = time.perf_counter()
                    scores = _host(self.step_fn(*batch))[:real]
                    self.device_s += time.perf_counter() - t0
                self.device_steps += 1
                self.frames_stepped += real
            except Exception as e:  # poison only the affected requests
                err = e
            off = 0
            with self._cond:
                for e, s, t in takers:
                    if err is None:
                        e["out"][s:s + t] = scores[off:off + t]
                    else:
                        e["error"] = err
                    off += t
                    e["filled"] += t
                    if e["filled"] == e["n"] or err is not None:
                        e["event"].set()


class ScoringService:
    """Warm-pipeline scorer for (dist, ref) path requests, on one device or
    over a mesh of the local GPUs (--data-parallel, --spatial N)."""

    def __init__(self, args, model, dists_weights):
        dtype = "float32" if args.fp32 else "bfloat16"
        self.args = args
        mesh = None
        spatial = int(getattr(args, "spatial", 0) or 0)
        if spatial or getattr(args, "data_parallel", False):
            mesh = meshlib.create_mesh(meshlib.local_devices(),
                                       model_parallel=max(spatial, 1))
        if spatial and not args.full_size:
            raise SystemExit("--spatial is the full-resolution mode; pass "
                             "--full-size")
        self.mesh = mesh
        self.spatial = spatial
        self.device = (mesh.primary if mesh is not None
                       else resolve_device(getattr(args, "device", None)))
        self.batch_size = args.batch_size
        # the DISTS and ADISTS batches split over the data axis
        fr_bs = (self.batch_size if mesh is None else
                 meshlib.pad_to_multiple(self.batch_size, mesh.shape[meshlib.DATA_AXIS]))
        self.want_dists = args.metric in ("dists", "both")
        self.want_adists = args.metric in ("adists", "both")
        model = model.to(self.device).eval()
        # frames are resized on the host by _load_frames (tools/score
        # semantics); the device pipeline scores them as-is
        self.scorer = FrameScorer(
            model, dists_weights,
            DISTSConfig(compute_dtype=dtype, stats_impl="kernel"),
            resize_to=None, mesh=mesh, spatial=bool(spatial), device=self.device,
        ) if self.want_dists else None
        self.nr_scorer = None
        if getattr(args, "nr_ckpt", None):
            self.nr_scorer = NRScorer(load_nr_model(args), args.batch_size,
                                      self.device)
        acfg = ADISTSConfig(compute_dtype=dtype)
        # one device: every path's dispatcher serializes its steps here
        self._device_lock = threading.Lock()
        self._counter_lock = threading.Lock()
        self.batchers: dict[str, FrameBatcher] = {}
        if self.scorer is not None:
            self.batchers["dists"] = FrameBatcher(
                self.scorer.score_batch, fr_bs, self._device_lock, "dists")
        if self.want_adists:
            self.batchers["adists"] = FrameBatcher(
                self._adists_step(model, acfg), fr_bs, self._device_lock,
                "adists")
        if self.nr_scorer is not None:
            self.batchers["nr"] = FrameBatcher(
                self.nr_scorer.step_batch, self.nr_scorer.batch_size,
                self._device_lock, "nr")
        self.n_requests = 0
        self.n_frames = 0
        self._latencies = collections.deque(maxlen=1000)
        self.started = time.time()

    def _adists_step(self, model, acfg):
        """ADISTS of one batch (the distorted frame as ``x``): on the
        service's device, per data shard over the mesh, or H-sharded
        (``spatial_adists_forward``) with --spatial."""
        mesh = self.mesh
        if mesh is None:
            return lambda d, r: adists_batch(model, d, r, acfg)
        models = meshlib.replicate(mesh, model)
        if self.spatial:
            def spatial_step(d, r):
                x = _prep(meshlib.to_device(d, self.device), None)
                y = _prep(meshlib.to_device(r, self.device), None)
                return spatial_adists_forward(models, x, y, mesh, acfg, as_loss=False)
            return spatial_step

        def sharded_step(d, r):
            return torch.cat([
                adists_batch(models[dev], ds, rs, acfg).to(self.device)
                for dev, (ds, rs) in zip(mesh.data_devices,
                                         meshlib.shard_batch(mesh, (d, r)))])
        return sharded_step

    def close(self) -> None:
        """Stop every path's dispatcher thread."""
        for b in self.batchers.values():
            b.stop()

    # -- device work -----------------------------------------------------
    def warmup(self, hw: tuple[int, int] = (64, 64)) -> None:
        """Run every serving path once at the serving batch (kernel builds,
        cuDNN algorithm choice) before taking traffic, then reset the
        /healthz counters (warm-up is not traffic)."""
        d = np.zeros((self.batch_size, *hw, 3), np.float32)
        self._score_arrays(d, d)
        if self.nr_scorer is not None:
            # NR shapes do not depend on the input size (host resize to
            # 256/224), so one zero batch warms the whole path
            self.batchers["nr"].score(*self.nr_scorer.prep_frames(
                np.zeros((self.batch_size, 64, 64, 3), np.float32)))
        with self._counter_lock:
            self.n_requests = 0
            self.n_frames = 0
            self._latencies.clear()
        for b in self.batchers.values():
            b.device_steps = 0
            b.frames_stepped = 0
            b.device_s = 0.0

    def _count(self, n_frames: int, latency_s: float) -> None:
        with self._counter_lock:
            self.n_frames += n_frames
            self.n_requests += 1
            self._latencies.append(latency_s)

    def _score_arrays(self, dist: np.ndarray, ref: np.ndarray) -> dict:
        out: dict = {"frames": int(dist.shape[0])}
        t0 = time.perf_counter()
        if "dists" in self.batchers:
            s = self.batchers["dists"].score(dist, ref)
            out["dists"] = float(s.mean())
            out["dists_frames"] = [float(v) for v in s]
        if "adists" in self.batchers:
            s = self.batchers["adists"].score(dist, ref)
            out["adists"] = float(s.mean())
            out["adists_frames"] = [float(v) for v in s]
        self._count(int(dist.shape[0]), time.perf_counter() - t0)
        return out

    # -- request handling ------------------------------------------------
    def handle(self, req) -> dict:
        if not isinstance(req, dict):
            return {"id": None,
                    "error": f"request must be a JSON object, got "
                             f"{type(req).__name__}"}
        rid = req.get("id")
        try:
            if "ref" not in req:
                if self.nr_scorer is None:
                    raise ValueError(
                        "no-reference request but the service was started "
                        "without --nr-ckpt"
                    )
                frames = _load_frames(str(req["dist"]), resize=False,
                                      keep_aspect=False)
                t0 = time.perf_counter()
                s = self.batchers["nr"].score(
                    *self.nr_scorer.prep_frames(frames))
                self._count(len(s), time.perf_counter() - t0)
                return {"id": rid, "frames": len(s),
                        "nr": float(s.mean()),
                        "nr_frames": [float(v) for v in s]}
            dist = _load_frames(str(req["dist"]), resize=not self.args.full_size,
                                keep_aspect=self.args.keep_aspect)
            ref = _load_frames(str(req["ref"]), resize=not self.args.full_size,
                               keep_aspect=self.args.keep_aspect)
            if dist.shape[0] != ref.shape[0]:
                raise ValueError(
                    f"frame count mismatch: {dist.shape[0]} vs {ref.shape[0]}"
                )
            if dist.shape != ref.shape:
                raise ValueError(
                    f"shape mismatch: {dist.shape} vs {ref.shape}"
                )
            return {"id": rid, **self._score_arrays(dist, ref)}
        except Exception as e:  # malformed request; keep serving
            return {"id": rid, "error": f"{type(e).__name__}: {e}"}

    def stats(self) -> dict:
        up = time.time() - self.started
        with self._counter_lock:
            lat = sorted(self._latencies)
            n_req, n_fr = self.n_requests, self.n_frames
        device_s = sum(b.device_s for b in self.batchers.values())
        device_steps = sum(b.device_steps for b in self.batchers.values())

        def pct(p):
            if not lat:
                return None
            return round(lat[min(len(lat) - 1,
                                 int(p / 100.0 * len(lat)))] * 1e3, 2)

        return {
            "ok": True,
            "uptime_s": round(up, 1),
            "requests": n_req,
            "frames": n_fr,
            # device_steps < requests proves cross-request batching engaged
            "device_steps": device_steps,
            "queue_depth": sum(b.queue_depth()
                               for b in self.batchers.values()),
            "latency_ms_p50": pct(50),
            "latency_ms_p95": pct(95),
            "device_fps": round(n_fr / device_s, 2) if device_s else None,
        }


def serve_stdio(service: ScoringService, lines=None, out=None) -> int:
    lines = sys.stdin if lines is None else lines
    out = sys.stdout if out is None else out
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            resp = {"id": None, "error": f"JSONDecodeError: {e}"}
        else:
            resp = service.handle(req)
        out.write(json.dumps(resp) + "\n")
        out.flush()
    return 0


def make_http_server(service: ScoringService, port: int, host="127.0.0.1"):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, service.stats())
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/score":
                self._reply(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
            except (ValueError, OSError) as e:
                self._reply(400, {"error": f"bad request: {e}"})
                return
            if isinstance(req, list):
                self._reply(200, [service.handle(r) for r in req])
            else:
                self._reply(200, service.handle(req))

        def log_message(self, *a):  # quiet; stats live in /healthz
            pass

    class Server(ThreadingHTTPServer):
        # a burst of concurrent clients must not overflow the listen
        # backlog (socketserver's default of 5 drops the rest's connections
        # until their SYNs are sent again, a second or more later)
        request_queue_size = 128

    return Server((host, port), Handler)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="persistent scoring service")
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--stdio", action="store_true")
    mode.add_argument("--http", type=int, metavar="PORT",
                      help="serve HTTP on PORT (0: a free port)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--metric", default="dists",
                   choices=["dists", "adists", "both"])
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--fp32", action="store_true",
                   help="fp32 parity pipeline (default: bf16 serving)")
    p.add_argument("--full-size", action="store_true",
                   help="score at native resolution (batches bucketed by "
                        "input size)")
    p.add_argument("--keep-aspect", action="store_true")
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--data-parallel", action="store_true",
                   help="split DISTS/ADISTS scoring batches over all visible "
                        "GPUs (NR requests stay on the first)")
    p.add_argument("--spatial", type=int, default=0, metavar="N",
                   help="additionally split frame HEIGHT N ways "
                        "(parallel.spatial halo-exchange pyramid): the "
                        "full-resolution multi-device mode for DISTS and "
                        "ADISTS; requires --full-size, and frame H divisible "
                        "by 16*N, W by 16")
    # no-reference serving (requests without "ref"): a trained NR
    # checkpoint + the architecture flags it was trained with
    p.add_argument("--nr-ckpt", default=None,
                   help="reference-layout NR checkpoint (.pth) enabling "
                        "no-reference requests")
    p.add_argument("--nr-version", type=int, default=8)
    p.add_argument("--refine-up-depth", type=int, default=2)
    p.add_argument("--transformer-decoder-depth", type=int, default=2)
    p.add_argument("--vit-depth", type=int, default=12)
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' to run on "
                        "the host)")
    pretrained.add_backbone_args(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    model = pretrained.resolve_vgg_params(args.vgg_ckpt, seed=0)
    weights = pretrained.resolve_dists_weights(DISTSConfig(),
                                               args.dists_weights)
    service = ScoringService(args, model, weights)
    try:
        if not args.no_warmup and not args.full_size:
            t0 = time.perf_counter()
            service.warmup((256, 256))
            print(f"warmed up in {time.perf_counter() - t0:.1f}s",
                  file=sys.stderr)
        if args.stdio:
            return serve_stdio(service)
        server = make_http_server(service, args.http, args.host)
        print(f"serving on http://{args.host}:{server.server_address[1]}",
              file=sys.stderr, flush=True)
        server.serve_forever()
        return 0
    finally:
        service.close()


if __name__ == "__main__":
    raise SystemExit(main())
