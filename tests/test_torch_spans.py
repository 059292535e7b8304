"""The port's spans (``utils/profiling.span``) on the CPU: under
``torch.profiler`` one FR batch (``FrameScorer.score_batch``), one NR
forward and one NR training step at tiny sizes show every span, nested
as documented, with the documented integers; under the benchmark entries'
``trace_hooks()`` each ``pb.*`` span has its program twin with the same
integers; with no profiler recording a span builds nothing. The ChannelNorm
backward's span runs only on the card (``tests/test_torch_kernels.py``)."""
from __future__ import annotations

import json
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from nerf_qa_torch.parallel import mesh as meshlib
from nerf_qa_torch.utils import profiling
from portbench import harness

SEED = 12_345_678_901
FR_SMALL = {"batch": 2, "frame_hw": [32, 48], "pool_batches": 1, "reference_block": 2}
NR_SMALL = {"batch": 2, "render_hw": 32, "sem_hw": 28, "pool_batches": 1,
            "reference_block": 2}
TRAIN_SMALL = {"batch": 2, "render_hw": 32, "sem_hw": 28, "pool_batches": 4,
               "checked_steps": 1}
TWINS = {"pb.prep": "fr.prep", "pb.vgg": "dists.vgg", "pb.stats": "dists.stats",
         "pb.decoder": "nr.decoder", "pb.jbu": "nr.jbu", "pb.cn": "nr.cn"}


def _spans(fn, tmp_path, hooks=None) -> list[dict]:
    """The user spans of one call of ``fn`` under the profiler (inside
    ``hooks``), each with its name, integers, interval, thread and the
    name of its innermost enclosing span on that thread."""
    with hooks if hooks is not None else profiling._OFF:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"]
    out = []
    for e in events:
        name, *ints = e["name"].split(":")
        out.append({"name": name, "ints": [int(v) for v in ints], "start": e["ts"],
                    "end": e["ts"] + e["dur"], "tid": e["tid"]})
    for s in out:
        around = [o for o in out if o is not s and o["tid"] == s["tid"]
                  and o["start"] <= s["start"] and s["end"] <= o["end"]]
        s["parent"] = min(around, key=lambda o: o["end"] - o["start"])["name"] if around else None
    return out


def _parents(spans, name) -> Counter:
    return Counter(s["parent"] for s in spans if s["name"] == name)


@pytest.fixture(scope="module")
def fr_entry():
    return harness.make_entry("dists-256-b16", SEED, "cpu", FR_SMALL)


@pytest.fixture(scope="module")
def nr_entry():
    return harness.make_entry("nrv8-score-b16", SEED, "cpu", NR_SMALL)


@pytest.fixture(scope="module")
def train_entry():
    return harness.make_entry("nrv8-train-b4", SEED, "cpu", TRAIN_SMALL)


def _fr_call(entry):
    dist, ref = entry.pool[0]
    return lambda: entry.scorer.score_batch(dist, ref)


def _nr_call(entry):
    r256, r224 = entry.pool[0]
    return lambda: entry.scorer.step_batch(r256, r224)


def _train_call(entry):
    return lambda: entry.trainer.train_step(*entry.pool[1])


def test_span_is_one_shared_no_op_without_a_profiler():
    calls = []

    def spy():
        calls.append(1)
        return (1, 2)

    assert profiling.span("a", spy) is profiling.span("b") is profiling._OFF
    with profiling.span("a", spy):
        pass
    assert calls == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("a", spy):
            pass
    assert calls == [1]


@pytest.mark.parametrize("step", ["fr", "nr", "train"])
def test_steps_build_no_span_argument_without_a_profiler(step, fr_entry, nr_entry,
                                                         train_entry, monkeypatch):
    # every argument callable the step's spans hold is left uncalled
    calls = Counter()
    real = profiling.span

    def spy_span(name, args=None):
        if args is None:
            return real(name)

        def spy():
            calls[name] += 1
            return args()
        return real(name, spy)

    for mod in _span_users():
        monkeypatch.setattr(mod, "span", spy_span)
    entry = {"fr": fr_entry, "nr": nr_entry, "train": train_entry}[step]
    call = {"fr": _fr_call, "nr": _nr_call, "train": _train_call}[step](entry)
    call()
    assert calls == Counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        call()
    assert sum(calls.values()) > 0


def _span_users():
    from nerf_qa_torch.core import dists
    from nerf_qa_torch.eval import video_scorer
    from nerf_qa_torch.models.nr import featup, layers
    from nerf_qa_torch.ops import resize
    from nerf_qa_torch.ops.cuda import channelnorm

    return (dists, video_scorer, featup, layers, resize, channelnorm)


def test_fr_batch_spans(fr_entry, tmp_path):
    spans = _spans(_fr_call(fr_entry), tmp_path)
    names = Counter(s["name"] for s in spans)
    assert names == Counter({"fr.score": 1, "fr.h2d": 1, "fr.prep": 2, "dists.vgg": 1,
                             "dists.stats": 1})
    assert _parents(spans, "fr.score") == Counter({None: 1})
    for name in ("fr.h2d", "fr.prep", "dists.vgg", "dists.stats"):
        assert set(_parents(spans, name)) == {"fr.score"}, name
    h2d = next(s for s in spans if s["name"] == "fr.h2d")
    assert h2d["ints"] == [0, 0]  # nothing moves to a CPU device
    stats = next(s for s in spans if s["name"] == "dists.stats")
    n, (h, w) = FR_SMALL["batch"], FR_SMALL["frame_hw"]
    grid = [(h, w, 3), (h, w, 64), (h // 2, w // 2, 128), (h // 4, w // 4, 256),
            (h // 8, w // 8, 512), (h // 16, w // 16, 512)]
    assert stats["ints"] == [v for hh, ww, c in grid for v in (n, hh, ww, c, 2)]


def test_fr_resize_uploads_its_matrices(tmp_path):
    from nerf_qa_torch.eval.video_scorer import _prep

    frames = torch.zeros((1, 40, 56, 3), dtype=torch.uint8)
    spans = _spans(lambda: _prep(frames, (32, 24), fast=True), tmp_path)
    uploads = [s for s in spans if s["name"] == "ops.upload"]
    # bf16 (32, 40) and (24, 56) matrices, built and copied inside fr.prep
    assert [s["ints"] for s in uploads] == [[32 * 40 * 2], [24 * 56 * 2]]
    assert set(_parents(spans, "ops.upload")) == {"fr.prep"}


def _jbu_grid(sem):
    g = sem // 14
    return [g * 2**k for k in range(4)]


def _upload_bytes(sem):
    """The JBU stack's uploads: per stage the pool matrices (2h, sem) for H
    and W, the bicubic matrices (2h, h) and the 7x7 Gaussian."""
    out = []
    for h in _jbu_grid(sem):
        out += [4 * 2 * h * sem] * 2 + [4 * 2 * h * h] * 2 + [4 * 49]
    return sorted(out)


def _check_nr_layers(spans, n, sem, itemsize, encoder):
    names = Counter(s["name"] for s in spans)
    assert names["nr.vit"] == 1 and names["nr.jbu"] == 4 and names["nr.decoder"] == 1
    assert names["nr.cn"] == 18 and names["ops.upload"] == 20
    assert set(_parents(spans, "nr.vit")) == {encoder}
    assert set(_parents(spans, "nr.jbu")) == {encoder}
    assert set(_parents(spans, "dists.vgg")) == {encoder}
    # the pool matrices are built in the stack, the rest inside each stage
    assert _parents(spans, "ops.upload") == Counter({encoder: 8, "nr.jbu": 12})
    assert set(_parents(spans, "nr.cn")) == {"nr.decoder"}
    jbu = [s["ints"] for s in spans if s["name"] == "nr.jbu"]
    assert jbu == [[n, 2 * h, 2 * h, 384, 4] for h in _jbu_grid(sem)]
    assert sorted(s["ints"][0] for s in spans if s["name"] == "ops.upload") == \
        _upload_bytes(sem)
    cn = [s["ints"] for s in spans if s["name"] == "nr.cn"]
    assert all(len(a) == 4 and a[1] > 0 and a[0] % n == 0 and a[2] in (0, 1)
               and a[3] == itemsize for a in cn)
    assert {a[2] for a in cn} == {0, 1}


def test_nr_forward_spans(nr_entry, tmp_path):
    spans = _spans(_nr_call(nr_entry), tmp_path)
    assert _parents(spans, "nr.forward") == Counter({None: 1})
    _check_nr_layers(spans, NR_SMALL["batch"], NR_SMALL["sem_hw"], 4, "nr.forward")
    assert set(_parents(spans, "nr.decoder")) == {"nr.forward"}
    assert set(_parents(spans, "dists.stats")) == {"nr.forward"}


def test_nr_train_step_spans(train_entry, tmp_path):
    spans = _spans(_train_call(train_entry), tmp_path)
    assert _parents(spans, "nr.train_step") == Counter({None: 1})
    for name in ("nr.encode", "nr.decoder_fwd", "nr.losses", "nr.backward",
                 "nr.optimizer"):
        assert _parents(spans, name) == Counter({"nr.train_step": 1}), name
    # the bf16 decoder of train_nr
    _check_nr_layers(spans, TRAIN_SMALL["batch"], TRAIN_SMALL["sem_hw"], 2, "nr.encode")
    assert set(_parents(spans, "nr.decoder")) == {"nr.decoder_fwd"}
    # the ground truth's score in the encoder, the score and pref2ref in
    # the losses
    assert _parents(spans, "dists.stats") == Counter({"nr.encode": 1, "nr.losses": 2})
    assert "nr.forward" not in {s["name"] for s in spans}


def _twins(spans):
    program = [s for s in spans if not s["name"].startswith("pb.")]
    out = []
    for s in spans:
        if s["name"] in TWINS:
            twin = [p for p in program if p["name"] == TWINS[s["name"]]
                    and p["ints"] == s["ints"] and p["tid"] == s["tid"]
                    and s["start"] <= p["start"] and p["end"] <= s["end"]]
            out.append((s["name"], len(twin)))
    return out


def test_fr_hooks_have_program_twins(fr_entry, tmp_path):
    hooks = harness.entry_module("fr_score").Entry.trace_hooks(
        SimpleNamespace(scorer=fr_entry.scorer))
    pairs = _twins(_spans(_fr_call(fr_entry), tmp_path, hooks))
    assert Counter(name for name, _ in pairs) == Counter(
        {"pb.prep": 2, "pb.vgg": 1, "pb.stats": 1})
    assert all(k == 1 for _, k in pairs), pairs


@pytest.mark.parametrize("step", ["nr", "train"])
def test_nr_hooks_have_program_twins(step, nr_entry, train_entry, tmp_path):
    entry = nr_entry if step == "nr" else train_entry
    model = entry.scorer.model if step == "nr" else entry.trainer.model
    call = _nr_call(entry) if step == "nr" else _train_call(entry)
    hooks = harness.entry_module("nr_score").nr_spans(model)
    pairs = _twins(_spans(call, tmp_path, hooks))
    stats = 1 if step == "nr" else 3
    assert Counter(name for name, _ in pairs) == Counter(
        {"pb.cn": 18, "pb.jbu": 4, "pb.vgg": 1, "pb.decoder": 1, "pb.stats": stats})
    assert all(k == 1 for _, k in pairs), pairs


@pytest.mark.parametrize("case,want", [
    ("numpy", (2 * 3 * 4 * 4, 1)),
    ("cpu_tensor", (2 * 3 * 4 * 4, 1)),
    ("mixed_none", (3 * 4 * 4 + 3 * 4, 1)),
    ("on_device", (0, 0)),
    ("cpu_target", (0, 0)),
])
def test_host_copy_counts_what_moves_from_the_host(case, want):
    a = np.zeros((3, 4), np.float32)
    t = torch.zeros((3, 4), dtype=torch.float32)
    meta = torch.empty((3, 4), device="meta")
    tree, device = {
        "numpy": ((a, a), "cuda"),
        "cpu_tensor": ((t, t), "cuda"),
        "mixed_none": ((a, None, {"u": t.to(torch.uint8)}), "cuda"),
        "on_device": ((meta, meta), "cuda"),
        "cpu_target": ((a, t), "cpu"),
    }[case]
    assert meshlib.host_copy(tree, torch.device(device)) == want
