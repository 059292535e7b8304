"""NR training around the model, in the port against the JAX package, on the
CPU: the synthetic tree, the scene-balanced sampler, the NR dataset and
loader, the Adam update and its state bridge, the schedules and the
holdout split; then the port's training CLI on a synthetic tree at 32² /
28² (a 1-block ViT, decoder depths 0 / 1): it trains, checkpoints,
resumes bit for bit, starts from a checkpoint or a .pth, and its
checkpoint scores through ``tools/score.py --nr``; and each option that
once exited as unported runs (the score-map objective, the token cache,
remat, the NeRF-QA benchmark pass, v6), while an orbax ``--init-from``
exits naming the ROADMAP's "Not to port" note."""
import json
import os
import shutil

import jax
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from nerf_qa_torch.compat import from_jax
from nerf_qa_torch.compat import pretrained as tpre
from nerf_qa_torch.compat.checkpoint import latest_step, restore_checkpoint
from nerf_qa_torch.config import DISTSConfig as TDConfig
from nerf_qa_torch.config import NRModelConfig as TConfig
from nerf_qa_torch.config import TrainConfig as TTrainConfig
from nerf_qa_torch.data import datasets as tdatasets
from nerf_qa_torch.data import factories as tfactories
from nerf_qa_torch.data import pipeline as tpipeline
from nerf_qa_torch.data import samplers as tsamplers
from nerf_qa_torch.models.nr.decoder import NRDecoder
from nerf_qa_torch.models.nr.layers import init_lecun_normal_
from nerf_qa_torch.models.nr.model import NRModel
from nerf_qa_torch.tools import make_synthetic_dataset as tsynth
from nerf_qa_torch.tools import score as tscore
from nerf_qa_torch.tools import train_nr as ttrain_cli
from nerf_qa_torch.train import nr_train as ttrain
from nerf_qa_torch.train import schedules as tsched
from nerf_qa_tpu.compat.torch_nr import convert_nr_decoder
from nerf_qa_tpu.config import TrainConfig as JTrainConfig
from nerf_qa_tpu.data import datasets as jdatasets
from nerf_qa_tpu.data import factories as jfactories
from nerf_qa_tpu.data import samplers as jsamplers
from nerf_qa_tpu.tools import make_synthetic_dataset as jsynth
from nerf_qa_tpu.train import nr_train as jtrain
from nerf_qa_tpu.train.schedules import make_schedule as jmake_schedule
from tests.torch_parity import nr_config, one_torch_thread  # noqa: F401

RENDER, SEM = 32, 28  # 32 / 16 == 28 / 14 == 2
ARCH = ["--vit-depth", "1", "--refine-up-depth", "1",
        "--transformer-decoder-depth", "0", "--dropout-rate", "0.0",
        "--render-size", str(RENDER), "--sem-size", str(SEM),
        "--compute-dtype", "float32", "--decoder-dtype", "float32",
        "--batch-size", "2", "--num-workers", "0", "--device", "cpu",
        "--aug-rot-deg", "0", "--aug-crop-scale", "1.0"]


@pytest.fixture(scope="module")
def nr_tree(tmp_path_factory):
    """The synthetic NR tree with score-map PNGs (L mode, as prep_nr writes
    them) and their log-range columns, written from a seed."""
    from PIL import Image

    root = str(tmp_path_factory.mktemp("nr"))
    csv = tsynth.make_nr_tree(root, scenes=("chair", "drums"), methods=("nerfacto",),
                              frames=2, hw=(48, 48))
    rows = ttrain_cli.read_rows(csv)
    rng = np.random.default_rng(9)
    for row in rows:
        out = os.path.join(root, os.path.dirname(row["render_dir"]), "score-map")
        os.makedirs(out)
        for name in tdatasets.parse_list_column(row["basenames"]):
            Image.fromarray((rng.random((40, 40)) * 255).astype(np.uint8), "L").save(
                os.path.join(out, name))
        row["score_map_log_min"] = str([round(float(v), 6) for v in 1 + rng.random(2)])
        row["score_map_log_max"] = str([round(float(v), 6) for v in 2.5 + rng.random(2)])
    pd.DataFrame(rows).to_csv(csv, index=False)
    return root, csv


def _both_datasets(nr_tree, is_train, seed=5, mode="gt"):
    root, csv = nr_tree
    kw = dict(is_train=is_train, render_size=RENDER, sem_size=SEM)
    j = jdatasets.NerfNRQADataset(pd.read_csv(csv), root, mode=mode,
                                  rng=np.random.default_rng(seed), **kw)
    t = tdatasets.NerfNRQADataset(ttrain_cli.read_rows(csv), root, mode=mode,
                                  rng=np.random.default_rng(seed), **kw)
    return j, t


def _assert_items_equal(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_items_equal(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_items_equal(a, b)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# -- data ---------------------------------------------------------------------

def test_make_nr_tree_matches_jax(tmp_path):
    kw = dict(scenes=("chair", "room"), methods=("nerfacto", "instant-ngp"),
              frames=2, hw=(24, 32), seed=3)
    got = tsynth.make_nr_tree(str(tmp_path / "port"), **kw)
    want = jsynth.make_nr_tree(str(tmp_path / "jax"), **kw)
    pd.testing.assert_frame_equal(pd.read_csv(got), pd.read_csv(want))
    for rel in ("chair/gt/000.png", "room/instant-ngp/color/001.png"):
        assert ((tmp_path / "port" / rel).read_bytes()
                == (tmp_path / "jax" / rel).read_bytes()), rel


def test_scene_balanced_sampler_matches_jax():
    scenes = {"a": [0, 1, 2], "b": [3, 4], "c": [5, 6, 7, 8]}
    t, j = tsamplers.SceneBalancedSampler(scenes, 4), jsamplers.SceneBalancedSampler(scenes, 4)
    assert len(t) == len(j) == 6
    for epoch in (0, 1, 7):
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        assert list(t) == list(j)


@pytest.mark.parametrize("is_train,mode", [
    (False, "gt"), (True, "gt"), (False, "render"), (True, "render"),
    (False, "score-map"), (True, "score-map")],
    ids=["False", "True", "False-render", "True-render", "False-score-map",
         "True-score-map"])
def test_nr_dataset_matches_jax(nr_tree, is_train, mode):
    # the same frames, rotation, crops and resizes from the same seed, in
    # the same order: equal arrays ('render', the JAX class's default,
    # reads as 'gt'; 'score-map' gives the decoded map in place of the
    # DISTS targets)
    j, t = _both_datasets(nr_tree, is_train, mode=mode)
    assert len(t) == len(j) == 4
    assert t.get_scene_indices() == j.get_scene_indices()
    for idx in (0, 3, 1, 2, 0):
        item = t[idx]
        assert len(item) == (5 if mode == "score-map" else 6)
        _assert_items_equal(item, j[idx])


def test_nr_loader_matches_jax_and_prefetches(nr_tree):
    # the port's loader (torch DataLoader, two worker processes) gives the
    # JAX package's batches from the same seed; the CPU leg of
    # device_prefetch gives the same values as tensors
    root, csv = nr_tree
    kw = dict(mode="gt", is_train=False, batch_size=3, num_workers=2, seed=2,
              render_size=RENDER, sem_size=SEM)
    want = list(jfactories.create_nr_dataloader(pd.read_csv(csv), root, **kw))
    loader = tfactories.create_nr_dataloader(ttrain_cli.read_rows(csv), root, **kw)
    got = list(loader)
    assert len(got) == len(want) == len(loader) == 2
    _assert_items_equal(got, want)
    moved = list(tpipeline.device_prefetch(got, device="cpu"))
    assert isinstance(moved[0][1]["256x256"], torch.Tensor)
    _assert_items_equal([jax.tree_util.tree_map(np.asarray, b) for b in moved], want)


def test_nr_loader_workers_draw_new_augmentations_each_epoch(nr_tree):
    # with worker processes each epoch reseeds the workers' augmentation
    # streams from the loader's seeded generator: a fresh loader with the
    # same seed repeats the run, and a second pass over the same sampler
    # order draws other rotations and crops
    root, csv = nr_tree

    def two_passes():
        loader = tfactories.create_nr_dataloader(
            ttrain_cli.read_rows(csv), root, is_train=True, batch_size=2,
            num_workers=2, seed=4, render_size=RENDER, sem_size=SEM)
        return [np.concatenate([b[0] for b in loader]) for _ in range(2)]

    first, again = two_passes(), two_passes()
    np.testing.assert_array_equal(first[0], again[0])
    np.testing.assert_array_equal(first[1], again[1])
    assert not np.array_equal(first[0], first[1])


# -- optimizer, schedules, split ----------------------------------------------

def test_adam_update_and_state_bridge_match_optax():
    # one torch Adam step on the gradients optax gets equals optax's adam;
    # then optax's state, bridged into a fresh torch Adam, gives JAX's
    # second step. atol 1e-6 on parameters of size ~0.1-1 (fp32 rounding
    # of p + update, updates of size lr = 1e-3). The JAX params come from
    # a seeded port decoder (refine depth 1) through the JAX package's
    # importer.
    cfg = nr_config(TConfig).replace(refine_up_depth=1)
    dec = init_lecun_normal_(NRDecoder(cfg, qkv_bias=True, layer_scale=True),
                             torch.Generator().manual_seed(0))
    p0 = jax.tree_util.tree_map(np.asarray, convert_nr_decoder(dec.state_dict(),
                                                               upsample_stages=4))
    rng = np.random.default_rng(7)
    g1, g2 = (jax.tree_util.tree_map(
        lambda a: rng.normal(0, 1e-2, np.shape(a)).astype(np.float32), p0)
        for _ in range(2))
    opt = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
    step = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(
        *opt.update(g, s, p)))
    p1, s1 = step(g1, opt.init(p0), p0)
    p2, _ = step(g2, s1, p1)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731

    def port_step(p, g, state=None):
        like = from_jax.nr_decoder_state_dict_from_jax(p, qkv_bias=True, layer_scale=True)
        dec = NRDecoder.from_state_dict(like, cfg)
        adam = torch.optim.Adam(dec.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
        if state is not None:
            adam.load_state_dict(from_jax.adam_state_dict_from_jax(
                state.count, to_np(state.mu), to_np(state.nu), dec, adam))
        grads = from_jax.nr_decoder_tensors_from_jax(g, like)
        for name, param in dec.named_parameters():
            param.grad = grads[name]
        adam.step()
        return dec.state_dict(), like

    for p, g, state, want in ((p0, g1, None, p1), (to_np(p1), g2, s1[0], p2)):
        got, like = port_step(p, g, state)
        want = from_jax.nr_decoder_tensors_from_jax(to_np(want), like)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-6, msg=k)


@pytest.mark.parametrize("schedule", ["exp", "cosine", "constant"])
def test_schedules_match_jax(schedule):
    # the JAX schedules evaluate in fp32: rtol 1e-6, atol 1e-12 at the
    # cosine's end
    kw = dict(lr=3e-4, epochs=4, schedule=schedule, gamma=0.9, warmup_epochs=1)
    want = jmake_schedule(JTrainConfig(**kw), 5)
    got = tsched.make_schedule(TTrainConfig(**kw), 5)
    steps = range(25)
    np.testing.assert_allclose([got(s) for s in steps],
                               [float(want(s)) for s in steps], rtol=1e-6, atol=1e-12)


def test_scene_holdout_split_matches_jax():
    scenes = np.array(["a", "a", "b", "c", "c", "d"])
    methods = np.array(["x", "bad", "x", "x", "bad", "x"])
    for kw in ({"methods": methods, "blacklist_methods": ["bad"]}, {}):
        got = ttrain.scene_holdout_split(scenes, ["b", "d"], **kw)
        want = jtrain.scene_holdout_split(scenes, ["b", "d"], **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    train, val = ttrain.scene_holdout_split(scenes, ["b", "d"], methods, ["bad"])
    assert list(val) == [False, False, True, False, False, True]
    assert list(train) == [True, False, False, True, False, False]


# -- the CLI --------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_epochs(nr_tree, tmp_path_factory):
    """Two epochs straight, a checkpoint after each."""
    root, csv = nr_tree
    out = str(tmp_path_factory.mktemp("run2"))
    assert ttrain_cli.main(["--data-dir", root, "--scores-csv", csv, "--output-dir", out,
                            "--epochs", "2", "--checkpoint-every", "1", *ARCH]) == 0
    return out


def test_cli_trains_and_checkpoints(two_epochs):
    ckpt = os.path.join(two_epochs, "ckpt")
    assert latest_step(ckpt) == 2
    with open(os.path.join(ckpt, "FORMAT")) as f:
        assert f.read().strip() == "2"
    step, state = restore_checkpoint(ckpt)
    assert step == 2 and state["epoch"] == 2 and state["step"] == 4  # 2 steps an epoch
    assert set(state) == {"decoder", "optimizer", "step", "generator",
                          "dists_alpha_beta", "epoch"}
    assert all(torch.isfinite(v).all() for v in state["decoder"].values())
    with open(os.path.join(two_epochs, "metrics.jsonl")) as f:
        logs = [json.loads(line) for line in f]
    assert [r["step"] for r in logs] == [0, 1]
    assert all(np.isfinite(r["Train Metrics Dict/combined"]) for r in logs)


def test_cli_resumes_bit_for_bit(nr_tree, two_epochs, tmp_path):
    # epoch 1 from the straight run's first checkpoint, resumed: the same
    # decoder and optimizer state as the straight run's second epoch (no
    # dropout, no augmentation: every step is deterministic on the CPU)
    root, csv = nr_tree
    out = tmp_path / "resumed"
    shutil.copytree(os.path.join(two_epochs, "ckpt", "step_00000001"),
                    out / "ckpt" / "step_00000001")
    shutil.copy(os.path.join(two_epochs, "ckpt", "FORMAT"), out / "ckpt" / "FORMAT")
    assert ttrain_cli.main(["--data-dir", root, "--scores-csv", csv, "--output-dir",
                            str(out), "--epochs", "2", "--resume", *ARCH]) == 0
    _, got = restore_checkpoint(str(out / "ckpt"))
    _, want = restore_checkpoint(os.path.join(two_epochs, "ckpt"))
    assert got["step"] == want["step"] == 4
    for k, v in want["decoder"].items():
        torch.testing.assert_close(got["decoder"][k], v, rtol=0, atol=0, msg=k)
    for i, s in want["optimizer"]["state"].items():
        torch.testing.assert_close(got["optimizer"]["state"][i]["exp_avg_sq"],
                                   s["exp_avg_sq"], rtol=0, atol=0)


def test_cli_init_from_checkpoint_and_pth(nr_tree, two_epochs, tmp_path, capsys):
    # --init-from a port checkpoint directory and a reference-layout .pth
    # with α/β: the decoder (and α/β) the run starts from, zero epochs
    root, csv = nr_tree
    _, src = restore_checkpoint(os.path.join(two_epochs, "ckpt"))
    rng = np.random.default_rng(1)
    alpha = rng.uniform(0.05, 0.15, 1475).astype(np.float32)
    beta = rng.uniform(0.05, 0.15, 1475).astype(np.float32)
    pth = dict(src["decoder"], **{"encoder.dists.alpha": torch.from_numpy(alpha),
                                  "encoder.dists.beta": torch.from_numpy(beta)})
    torch.save(pth, tmp_path / "model.pth")
    for init, ab in ((os.path.join(two_epochs, "ckpt"), src["dists_alpha_beta"]),
                     (str(tmp_path / "model.pth"), {"alpha": alpha, "beta": beta})):
        out = str(tmp_path / f"run_{len(os.listdir(tmp_path))}")
        assert ttrain_cli.main(["--data-dir", root, "--scores-csv", csv, "--output-dir",
                                out, "--epochs", "0", "--init-from", init, *ARCH]) == 0
        assert "initialized decoder params" in capsys.readouterr().out
        _, state = restore_checkpoint(os.path.join(out, "ckpt"))
        for k, v in src["decoder"].items():
            torch.testing.assert_close(state["decoder"][k], v, rtol=0, atol=0, msg=k)
        for k in ("alpha", "beta"):
            np.testing.assert_array_equal(state["dists_alpha_beta"][k].numpy(),
                                          np.asarray(ab[k]).reshape(-1))


def test_cli_checkpoint_scores_with_score_nr(nr_tree, two_epochs, tmp_path,
                                             monkeypatch, capsys):
    # the final checkpoint directory through tools/score.py --nr --fp32,
    # against the same model built from the checkpoint and called
    # directly: atol 1e-5 (the CSV holds 6 decimals)
    root, _ = nr_tree
    monkeypatch.setattr(tscore, "NR_SIZES", (RENDER, SEM))
    for env in (tpre.ENV_VGG, tpre.ENV_VIT, tpre.ENV_JBU, tpre.ENV_DISTS):
        monkeypatch.delenv(env, raising=False)
    ckpt = os.path.join(two_epochs, "ckpt")
    frames_dir = os.path.join(root, "chair", "nerfacto", "color")
    out_csv = tmp_path / "nr.csv"
    assert tscore.main(["--nr", "--nr-ckpt", ckpt, "--dist", frames_dir,
                        "--vit-depth", "1", "--transformer-decoder-depth", "0",
                        "--refine-up-depth", "1", "--fp32", "--batch-size", "2",
                        "--device", "cpu", "--json", "--out-csv", str(out_csv)]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = np.loadtxt(out_csv, delimiter=",", skiprows=1, ndmin=2)[:, 1]
    assert summary["nr"]["frames"] == 2

    decoder_sd, alpha_beta = tpre.load_nr_torch_file(ckpt)
    cfg = TConfig(transformer_decoder_depth=0, refine_up_depth=1)
    vit = tpre.resolve_vit_params(depth=1, grid_size=SEM // 14)
    from nerf_qa_torch.core.dists import weights_from_arrays

    model = NRModel(tpre.resolve_vgg_params(), weights_from_arrays(*alpha_beta, cfg.dists),
                    cfg, vit=vit, jbu=tpre.resolve_jbu_params(),
                    decoder=NRDecoder.from_state_dict(decoder_sd, cfg),
                    render_size=RENDER, sem_size=SEM)
    scorer = tscore.NRScorer(model, batch_size=2, device="cpu")
    frames = np.stack([tdatasets.load_image_rgb(os.path.join(frames_dir, f))
                       for f in sorted(os.listdir(frames_dir))])
    r256, r224 = scorer.prep_frames(frames)
    with torch.no_grad():
        want = model(torch.from_numpy(r256), torch.from_numpy(r224)).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("flags", [
    ["--mode", "score-map"], ["--feature-cache", "cache"], ["--remat"],
    ["--test-scores-csv", "test.csv"], ["--version", "6"], ["--init-from", "orbax"],
])
def test_cli_unported_flags_exit_naming_roadmap(nr_tree, tmp_path, flags):
    # five of these options exited as unported until they were ported: each
    # now trains an epoch and shows its effect. An orbax checkpoint still
    # exits: reading one needs JAX (ROADMAP Queue 1, "Not to port")
    root, csv = nr_tree
    out = str(tmp_path / "out")
    argv = ["--data-dir", root, "--scores-csv", csv, "--output-dir", out, "--epochs", "1",
            *ARCH]
    if flags[-1] == "orbax":  # an orbax checkpoint is a directory of other files
        (tmp_path / "orbax" / "step_00000001").mkdir(parents=True)
        with pytest.raises(SystemExit, match="Not to port"):
            ttrain_cli.main(argv + ["--init-from", str(tmp_path / "orbax")])
        return
    if flags[0] == "--feature-cache":
        from nerf_qa_torch.tools import cache_nr_features

        flags = ["--feature-cache", str(tmp_path / "cache")]
        assert cache_nr_features.main(["--data-dir", root, "--scores-csv", csv,
                                       "--cache-dir", flags[1], "--vit-depth", "1",
                                       "--sem-size", str(SEM), "--num-workers", "0",
                                       "--device", "cpu"]) == 0
    if flags[0] == "--test-scores-csv":
        bench = tmp_path / "bench"
        with open(bench.with_suffix(".csv"), "w") as f:
            f.write("reference_filename,distorted_filename,MOS,DMOS\n")
            for i, (scene, ref) in enumerate((("chair", "lego"), ("drums", "ship"),
                                              ("chair", "truck"))):
                shutil.copytree(os.path.join(root, scene, "nerfacto", "color"),
                                bench / f"v{i}")
                f.write(f"{ref}_reference.mp4,v{i}.mp4,{1 + i},{5 - 0.5 * i}\n")
        flags = ["--test-scores-csv", str(bench.with_suffix(".csv")), "--test-data-dir",
                 str(bench), "--test-every", "1"]
    assert ttrain_cli.main(argv + flags) == 0
    with open(os.path.join(out, "metrics.jsonl")) as f:
        logs = [json.loads(line) for line in f]
    keys = set().union(*logs)
    _, state = restore_checkpoint(os.path.join(out, "ckpt"))
    assert np.isfinite(logs[0]["Train Metrics Dict/combined"])
    if flags[0] == "--mode":
        assert "Train Metrics Dict/score_map_l1" in keys
    elif flags[0] == "--test-scores-csv":
        assert {"Test Metrics Dict/mos/plcc", "Test Metrics Dict/dmos/srcc"} <= keys
    elif flags[0] == "--version":
        assert "Train Metrics Dict/dists_std_l1" in keys
        assert any(k.endswith("running_var") for k in state["decoder"])
    else:  # --feature-cache, --remat: the gt objective's losses
        assert "Train Metrics Dict/dists_pref2ref" in keys
    shutil.rmtree(out)  # a checkpoint with Adam's state is ~0.5 GB


def test_cli_needs_a_gpu_unless_asked(nr_tree, tmp_path, monkeypatch):
    root, csv = nr_tree
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in ARCH if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain_cli.main(["--data-dir", root, "--scores-csv", csv, "--output-dir",
                         str(tmp_path / "out"), *argv])
