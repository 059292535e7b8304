"""The port's FR trainer (train/fr_train.py) against the JAX package's on
the CPU: one same-seed step on cached statistics and on images (loss,
predictions, head and α/β gradients, params after the update), with the
weight projection, the entropy term, two learning-rate groups and
gradient accumulation against optax.MultiSteps; the stats cache,
per-video scores and the k-fold splits. The JAX params come across
through ``compat.from_jax.fr_params_from_jax``, the VGG weights from
``init_vgg16_params(seed=0)``."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_qa_torch.compat.from_jax import fr_params_from_jax
from nerf_qa_torch.config import DISTSConfig as TDConfig
from nerf_qa_torch.config import FRModelConfig as TConfig
from nerf_qa_torch.config import TrainConfig as TTrain
from nerf_qa_torch.train import fr_train as tft
from nerf_qa_tpu.config import DISTSConfig as JDConfig
from nerf_qa_tpu.config import FRModelConfig as JConfig
from nerf_qa_tpu.config import TrainConfig as JTrain
from nerf_qa_tpu.train import fr_train as jft
from tests.torch_parity import jax_params, np_params, one_torch_thread, torch_model  # noqa: F401

N, HW = 4, 32
# the cached step on identical statistics and identical params (the port's
# are reset to JAX's after each step, so every step is compared from the
# same point): fp32 elementwise math and one Adam update in two frameworks
CACHED_LOSS_ATOL = 1e-6
# the predictions: fp32 scores through a logistic head of slope ~25
CACHED_PRED_ATOL = 1e-5
# each gradient within this share of the largest of its group (head, or
# α and β): an α/β gradient is (S_c − score)/Σ(α, β), so small channels
# are differences of large terms, and the logistic's b4 gradient sums
# (s − b3)/b4² terms of both signs (measured: 1.7e-5 of the head's largest)
CACHED_GRAD_SHARE = 1e-4
# params after the update: 1 % of the first step's lr (5e-4). Adam moves a
# channel by lr·m̂/(√v̂ + eps); where |g| is within ~100x of eps (1e-8) the
# frameworks' rounding of that quotient differs (measured: 1.03e-6 on one
# β channel with g = -9.5e-7, identical in both)
CACHED_PARAM_ATOL = 5e-6
# three chained steps (no reset): step-one differences of up to
# CACHED_PARAM_ATOL move the next scores through a head of slope ~25
EPOCH_LOSS_ATOL = 2e-5
EPOCH_PARAM_ATOL = CACHED_PARAM_ATOL  # measured 6.7e-7
# the image step through each package's own pyramid and statistics: the
# score bar of tests/test_torch_dists.py (1e-4), the α/β gradient bar of
# its end-to-end test (atol 1e-4: the covariance's cancellation on deep
# stages) times the linear head's |slope| (~16 on these targets: the L1
# loss's gradient is sign(pred − t)·slope·∂score), and the update those
# gradients give: Adam's first step is lr_0·g/(|g| + eps), eps = 1e-8, so
# where the two gradients agree in sign and both exceed 100·eps the
# updates agree within 1 % of lr_0 (CACHED_PARAM_ATOL); elsewhere a
# channel may land up to 2·lr_0 away. The agreeing channels must be at
# least AGREE_SHARE of α and of β (measured: all 1,475 of each, every
# update within 4.2e-9)
IMAGE_LOSS_ATOL = 1e-4
IMAGE_GRAD_ATOL = 1e-4
FIRST_LR = 5e-4  # the exp schedule's warm-up at step 0: lr·1/2
AGREE_MIN_GRAD = 1e-6
AGREE_SHARE = 0.95

CONFIGS = {
    "plain": {},
    "project": {"project_weights": True},
    # with the projection, as the JAX package's cached-stats test: without
    # it an α that an update takes below 0 gives log(<0) = NaN on both sides
    "entropy": {"entropy_loss_coeff": 0.05, "project_weights": True},
    "head_lr_scale": {"head_lr_scale": 10.0},
    "grad_accum": {"grad_accum_steps": 2},
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    ref = rng.random((2 * N, HW, HW, 3), dtype=np.float32)
    dist = np.clip(ref + rng.normal(0, 0.1, ref.shape), 0, 1).astype(np.float32)
    targets = rng.uniform(1, 5, 2 * N).astype(np.float32)
    return dist, ref, targets


def _trainers(jax_params, torch_model, regression_type="logistic",
              jax_impl="xla", port_impl="eager", n_stats=0, n_scene_types=0, **kw):
    head_lr_scale = kw.pop("head_lr_scale", 1.0)
    heads = dict(n_stats=n_stats, n_scene_types=n_scene_types)
    train = dict(lr=1e-3, schedule="exp", gamma=0.5, batch_size=N, **kw)
    jt = jft.FRTrainer(jax_params, JConfig(regression_type=regression_type,
                                           dists=JDConfig(stats_impl=jax_impl)),
                       JTrain(**train), steps_per_epoch=2, head_lr_scale=head_lr_scale,
                       **heads)
    tt = tft.FRTrainer(copy.deepcopy(torch_model),
                       TConfig(regression_type=regression_type,
                               dists=TDConfig(stats_impl=port_impl)),
                       TTrain(**train), steps_per_epoch=2,
                       head_lr_scale=head_lr_scale, device="cpu", **heads)
    return jt, tt


# head-init data on a logistic curve (b1 ~ 5, b2 ~ 1): a fit to a line
# gives |b2| in the hundreds, and its cancellation, not the port, would set
# the fp32 gaps
INIT_X = np.linspace(0.02, 0.3, 8)
INIT_Y = 1.0 + 4.0 / (1.0 + np.exp((INIT_X - 0.15) / 0.04))


def _init(jt, tt, x=INIT_X, y=INIT_Y):
    jp, jo = jt.init(x, y)
    tp, to = tt.init(x, y)
    for k, v in jp["head"].items():  # the port's own init agrees
        np.testing.assert_allclose(tp["head"][k].detach().numpy(), np.asarray(v),
                                   rtol=1e-6)
    return jp, jo, tt.to_device(fr_params_from_jax(_np(jp))), tt.optimizer.init(
        tt.to_device(fr_params_from_jax(_np(jp))))


def _port_params(tp, to):
    """The port params that ``to``'s Adam updates (a fresh init above
    binds the optimizer to its own copy)."""
    groups = [g["params"] for g in to.opt.param_groups]
    head = dict(zip(tp["head"], groups[0]))
    return {"head": head, "dists": type(tp["dists"])(*groups[1])}


def _record_grads(tt):
    """Patch the trainer's optimizer to keep each call's incoming grads."""
    seen = []
    real = tt.optimizer.update

    def update(state):
        seen.append([None if p.grad is None else p.grad.clone()
                     for g in state.opt.param_groups for p in g["params"]])
        return real(state)

    tt.optimizer.update = update
    return seen


def _jax_grads(jt, jp, stats_5nc, targets):
    n = targets.shape[0]
    return _np(jax.grad(lambda p: jt.loss_fn_cached(
        p, jnp.asarray(stats_5nc), jnp.asarray(targets), jnp.ones(n),
        jnp.zeros((n, 1)), jnp.full((n,), -1, jnp.int32))[0])(jp))


def _flat(params):
    return ([np.asarray(v) for v in params["head"].values()]
            + [np.asarray(params["dists"].alpha), np.asarray(params["dists"].beta)])


def _port_flat(params):
    return ([v.detach().numpy() for v in params["head"].values()]
            + [params["dists"].alpha.detach().numpy(),
               params["dists"].beta.detach().numpy()])


def _check_grads(got, want_tree, share):
    """Each gradient within ``share`` of the largest of its group."""
    want = _flat(want_tree)
    n_head = len(want) - 2
    for lo, hi in ((0, n_head), (n_head, len(want))):
        scale = max(float(np.abs(w).max()) for w in want[lo:hi])
        for g, w in zip(got[lo:hi], want[lo:hi]):
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=share * scale)


def _reset_to(tp, jp):
    """Copy JAX's params into the port's leaves, in place (the Adam state
    keeps its own moments)."""
    with torch.no_grad():
        for got, want in zip([*tp["head"].values(), *tp["dists"]], _flat(jp)):
            got.copy_(torch.from_numpy(np.array(want)))


@pytest.fixture(scope="module")
def jax_stats(jax_params, batch):
    dist, ref, _ = batch
    jt, _ = _trainers(jax_params, torch.nn.Identity())
    return np.asarray(jt._pair_stats_step(jnp.asarray(dist), jnp.asarray(ref))
                      ).transpose(1, 0, 2)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cached_steps_match_jax(jax_params, torch_model, batch, jax_stats, name):
    # identical (N, 5, 1475) statistics into both: two steps (four with
    # accumulation), loss / predictions / gradients / params after each
    _, _, targets = batch
    jt, tt = _trainers(jax_params, torch_model, **CONFIGS[name])
    jp, jo, tp, to = _init(jt, tt)
    tp = _port_params(tp, to)
    seen = _record_grads(tt)
    steps = 4 if name == "grad_accum" else 2
    for i in range(steps):
        idx = slice((i % 2) * N, (i % 2 + 1) * N)
        want_g = _jax_grads(jt, jp, jax_stats[idx].transpose(1, 0, 2), targets[idx])
        jp, jo, jloss, jaux = jt.train_step_cached(jp, jo, jax_stats[idx], targets[idx])
        tp, to, tloss, taux = tt.train_step_cached(tp, to, jax_stats[idx], targets[idx])
        assert abs(float(tloss) - float(jloss)) <= CACHED_LOSS_ATOL
        np.testing.assert_allclose(taux[0].numpy(), np.asarray(jaux[0]),
                                   atol=CACHED_PRED_ATOL)
        _check_grads(seen[-1], want_g, CACHED_GRAD_SHARE)
        for got, want in zip(_port_flat(tp), _flat(jp)):
            np.testing.assert_allclose(got, want, rtol=0, atol=CACHED_PARAM_ATOL)
        _reset_to(tp, jp)
    if name == "grad_accum":
        assert to.count == 2 and to.mini_step == 0
    if name == "project":
        assert abs(float(tp["dists"].alpha.sum() + tp["dists"].beta.sum()) - 1) < 1e-5


def test_cached_step_with_stats_and_scene_type_heads_matches_jax(
        jax_params, torch_model, batch, jax_stats):
    # the head extensions through the trainer: per-video stats features and
    # scene-type ids (one -1: no conditioning for that sample)
    _, _, targets = batch
    jt, tt = _trainers(jax_params, torch_model, n_stats=2, n_scene_types=3)
    jp, jo, tp, to = _init(jt, tt)
    tp = _port_params(tp, to)
    assert {"stats_weight", "scene_scale", "scene_bias"} <= set(tp["head"])
    seen = _record_grads(tt)
    rng = np.random.default_rng(8)
    vstats = rng.normal(size=(N, 2)).astype(np.float32)
    types = np.array([0, 2, -1, 1], np.int32)
    for _ in range(2):
        jp, jo, jloss, _ = jt.train_step_cached(jp, jo, jax_stats[:N], targets[:N],
                                                stats=vstats, scene_types=types)
        tp, to, tloss, _ = tt.train_step_cached(tp, to, jax_stats[:N], targets[:N],
                                                stats=vstats, scene_types=types)
        assert abs(float(tloss) - float(jloss)) <= CACHED_LOSS_ATOL
        assert float(seen[-1][list(tp["head"]).index("stats_weight")].abs().max()) > 0
        for got, want in zip(_port_flat(tp), _flat(jp)):
            np.testing.assert_allclose(got, want, rtol=0, atol=CACHED_PARAM_ATOL)
        _reset_to(tp, jp)


@pytest.mark.parametrize("impls", [("xla", "eager"), ("pallas", "kernel")])
def test_image_step_matches_jax(jax_params, torch_model, batch, impls):
    # one step on images through each package's own pyramid and
    # statistics; JAX 'pallas' runs in interpret mode on the CPU
    dist, ref, targets = batch
    jt, tt = _trainers(jax_params, torch_model, regression_type="linear",
                       jax_impl=impls[0], port_impl=impls[1])
    jp, jo, tp, to = _init(jt, tt)
    tp = _port_params(tp, to)
    seen = _record_grads(tt)
    stats = np.asarray(jt._pair_stats_step(jnp.asarray(dist[:N]), jnp.asarray(ref[:N])))
    want_g = _jax_grads(jt, jp, stats, targets[:N])
    jp1, _, jloss, jaux = jt.train_step(jp, jo, dist[:N], ref[:N], targets[:N])
    tp1, _, tloss, taux = tt.train_step(tp, to, dist[:N], ref[:N], targets[:N])
    slope = abs(float(jp["head"]["weight"][0]))
    assert abs(float(tloss) - float(jloss)) <= IMAGE_LOSS_ATOL * slope
    np.testing.assert_allclose(taux[0].numpy(), np.asarray(jaux[0]),
                               atol=IMAGE_LOSS_ATOL * slope)
    np.testing.assert_allclose(taux[1].numpy(), np.asarray(jaux[1]), atol=IMAGE_LOSS_ATOL)
    grad_atol = IMAGE_GRAD_ATOL * slope
    for got, want in zip(seen[-1], _flat(want_g)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=grad_atol)
    for got, want, tg, jg in zip(_port_flat(tp1), _flat(jp1), seen[-1], _flat(want_g)):
        tg = tg.numpy()
        agree = ((np.sign(tg) == np.sign(jg))
                 & (np.minimum(np.abs(tg), np.abs(jg)) > AGREE_MIN_GRAD))
        gap = np.abs(got - want)
        assert gap[agree].max(initial=0) <= CACHED_PARAM_ATOL
        assert gap.max() <= 2 * FIRST_LR + CACHED_PARAM_ATOL
        if got.size > 1:  # α, β
            assert agree.mean() >= AGREE_SHARE, agree.mean()


def test_stats_cache_and_video_scores_match_jax(jax_params, torch_model, batch):
    dist, ref, targets = batch
    vids = np.array([0, 0, 1, 1, 2, 2, 3, 3])
    batches = [(dist[:5], ref[:5], targets[:5], vids[:5]),
               (dist[5:], ref[5:], targets[5:], vids[5:])]
    jt, tt = _trainers(jax_params, torch_model)
    want = jt.build_stats_cache(iter(batches))
    got = tt.build_stats_cache(iter(batches))
    assert got["stats"].shape == (8, 5, 1475) and got["stats"].dtype == np.float32
    np.testing.assert_array_equal(got["video_ids"], want["video_ids"])
    np.testing.assert_array_equal(got["targets"], want["targets"])
    # the moments of each package's own pyramid: fp32 features and sums
    np.testing.assert_allclose(got["stats"], want["stats"], rtol=1e-4, atol=1e-6)
    jp, _, tp, _ = _init(jt, tt)
    want_v = jt.score_dataloader(jp, iter(batches))
    got_v = tt.score_dataloader(tp, iter(batches))
    assert got_v["pred_score"].keys() == want_v["pred_score"].keys() == {0, 1, 2, 3}
    for key in ("pred_score", "dists_score"):
        for v in want_v[key]:
            assert abs(got_v[key][v] - want_v[key][v]) <= IMAGE_LOSS_ATOL, (key, v)
    want_d = jt.compute_dists_scores(iter(batches))
    got_d = tt.compute_dists_scores(iter(batches))
    for v in want_d:
        assert abs(got_d[v] - want_d[v]) <= IMAGE_LOSS_ATOL


def test_cached_epoch_follows_the_order(jax_params, torch_model, batch, jax_stats):
    _, _, targets = batch
    cache = {"stats": jax_stats, "targets": targets, "video_ids": np.arange(8) // 2}
    order = np.array([5, 2, 0, 7, 1, 3, 6, 4])
    jt, tt = _trainers(jax_params, torch_model)
    jp, jo, tp, to = _init(jt, tt)
    tp = _port_params(tp, to)
    jp, jo, jloss = jt.train_epoch_cached(jp, jo, cache, order, batch_size=3)
    tp, to, tloss = tt.train_epoch_cached(tp, to, cache, order, batch_size=3)
    assert abs(tloss - jloss) <= EPOCH_LOSS_ATOL and to.count == 3
    for got, want in zip(_port_flat(tp), _flat(jp)):
        np.testing.assert_allclose(got, want, rtol=0, atol=EPOCH_PARAM_ATOL)


def test_image_epoch_and_its_log_match_jax(jax_params, torch_model, batch):
    # train_epoch over (dist, ref, target, video, scene) batches, each step
    # logged per frame; the mean loss and the logger's summary against JAX
    from nerf_qa_torch.logging.metrics import MetricCollectionLogger as TLogger
    from nerf_qa_tpu.logging.metrics import MetricCollectionLogger as JLogger

    dist, ref, targets = batch
    vids = np.arange(2 * N) // 2
    scenes = np.array(["lego", "lego", "truck", "truck"] * 2)
    batches = [(dist[i:i + N], ref[i:i + N], targets[i:i + N], vids[i:i + N],
                scenes[i:i + N]) for i in (0, N)]
    jt, tt = _trainers(jax_params, torch_model, regression_type="linear")
    jp, jo, tp, to = _init(jt, tt)
    tp = _port_params(tp, to)
    jlog, tlog = JLogger("Train Metrics Dict"), TLogger("Train Metrics Dict")
    _, _, jloss = jt.train_epoch(jp, jo, iter(batches), logger=jlog)
    _, _, tloss = tt.train_epoch(tp, to, iter(batches), logger=tlog)
    slope = abs(float(jp["head"]["weight"][0]))
    assert abs(tloss - jloss) <= IMAGE_LOSS_ATOL * slope and to.count == 2
    want, got = jlog.log_summary(1), tlog.log_summary(1)
    assert got.keys() == want.keys()
    for k in ("Train Metrics Dict/mos", "Train Metrics Dict/video/3/mos"):
        assert got[k] == pytest.approx(want[k], rel=1e-6)


@pytest.mark.parametrize("n_splits", [2, 3, 4])
def test_group_kfold_splits_identical(n_splits):
    groups = np.random.default_rng(n_splits).choice(list("abcdefg"), size=40)
    for (gtr, gte), (wtr, wte) in zip(tft.group_kfold_splits(groups, n_splits),
                                      jft.group_kfold_splits(groups, n_splits),
                                      strict=True):
        np.testing.assert_array_equal(gtr, wtr)
        np.testing.assert_array_equal(gte, wte)


def test_schedule_free_adamw_matches_optax(jax_params, torch_model, batch, jax_stats):
    # --optimizer sadamw: optax.contrib.schedule_free_adamw in the JAX
    # trainer, ScheduleFreeAdamW here; three chained cached steps (the z
    # sequence and the params must stay consistent, so no reset)
    _, _, targets = batch
    jt, tt = _trainers(jax_params, torch_model, optimizer="sadamw")
    jp, jo, tp, to = _init(jt, tt)
    tp = _port_params(tp, to)
    start = [a.copy() for a in _port_flat(tp)]
    for i in range(3):
        idx = slice((i % 2) * N, (i % 2 + 1) * N)
        jp, jo, jloss, _ = jt.train_step_cached(jp, jo, jax_stats[idx], targets[idx])
        tp, to, tloss, _ = tt.train_step_cached(tp, to, jax_stats[idx], targets[idx])
        assert abs(float(tloss) - float(jloss)) <= EPOCH_LOSS_ATOL
        for got, want in zip(_port_flat(tp), _flat(jp)):
            np.testing.assert_allclose(got, want, rtol=0, atol=EPOCH_PARAM_ATOL)
    assert isinstance(to.opt, tft.ScheduleFreeAdamW) and to.opt.count == 3
    moved = max(float(np.abs(a - b).max()) for a, b in zip(_port_flat(tp), start))
    assert moved > 100 * EPOCH_PARAM_ATOL, moved
