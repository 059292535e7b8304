"""The port's FR model (models/fr.py) against the JAX package's on the CPU:
the head init of each regression type (scipy curve_fit / lstsq on the same
float64 inputs), the heads, the stats and scene-type heads, the entropy
loss, ``forward`` / ``forward_from_stats`` through each package's own
pyramid, and the JAX -> port param bridge. Weights come from
``init_vgg16_params(seed=0)`` through ``compat.from_jax``; inputs from
numpy seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_qa_torch.compat.from_jax import fr_params_from_jax
from nerf_qa_torch.config import DISTSConfig as TDConfig
from nerf_qa_torch.config import FRModelConfig as TConfig
from nerf_qa_torch.models import fr as tfr
from nerf_qa_tpu.config import DISTSConfig as JDConfig
from nerf_qa_tpu.config import FRModelConfig as JConfig
from nerf_qa_tpu.core import dists as jdists
from nerf_qa_tpu.models import fr as jfr
from tests.torch_parity import jax_params, np_params, one_torch_thread, torch_model  # noqa: F401

# the same float64 fit on both sides, stored as float32
INIT_RTOL = 1e-6
# fp32 elementwise heads in two frameworks
HEAD_RTOL, HEAD_ATOL = 1e-6, 1e-6
# DISTS through each package's own pyramid and statistics (the BASELINE
# score bar; tests/test_torch_dists.py), carried through a head of slope ~10
SCORE_ATOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(regression_type, score_type="MOS", **dkw):
    return (JConfig(regression_type=regression_type, subjective_score_type=score_type,
                    dists=JDConfig(**dkw)),
            TConfig(regression_type=regression_type, subjective_score_type=score_type,
                    dists=TDConfig(**dkw)))


def _scores(n=12, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.05, 0.4, n))
    y = 5.0 - 10.0 * x + rng.normal(0, 0.1, n)
    return x, y


@pytest.mark.parametrize("regression_type,score_type", [
    ("logistic", "MOS"), ("logistic", "DMOS"), ("sqrt", "MOS"), ("linear", "MOS")])
def test_head_init_matches_jax(regression_type, score_type):
    x, y = _scores()
    if score_type == "DMOS":
        y = 6.0 - y
    jc, tc = _cfgs(regression_type, score_type)
    want = _np(jfr.init_head_params(x, y, jc))
    got = tfr.init_head_params(x, y, tc)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == (1,)
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=INIT_RTOL)


def test_logistic_init_near_constant_predictor_hits_the_b4_floor():
    x = np.full(10, 0.2) + np.linspace(0, 1e-9, 10)
    y = np.linspace(1.0, 5.0, 10)
    jc, tc = _cfgs("logistic")
    want = _np(jfr.init_head_params(x, y, jc))
    got = tfr.init_head_params(x, y, tc)
    floor = 1e-3 * (np.std(x) + abs(np.median(x)))
    assert abs(float(got["b4"][0])) >= floor * (1 - 1e-6)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=INIT_RTOL)


def _head(regression_type):
    rng = np.random.default_rng(1)
    if regression_type == "logistic":
        return {"b1": np.float32([4.8]), "b2": np.float32([1.2]),
                "b3": np.float32([0.2]), "b4": np.float32([-0.05])}
    return {"weight": np.float32([rng.normal()]), "bias": np.float32([rng.normal()])}


@pytest.mark.parametrize("regression_type,score_type", [
    ("logistic", "MOS"), ("logistic", "DMOS"), ("sqrt", "MOS"), ("linear", "MOS")])
def test_apply_head_matches_jax(regression_type, score_type):
    s = np.random.default_rng(2).uniform(0.01, 0.5, 16).astype(np.float32)
    head = _head(regression_type)
    jc, tc = _cfgs(regression_type, score_type)
    want = np.asarray(jfr.apply_head({k: jnp.asarray(v) for k, v in head.items()},
                                     jnp.asarray(s), jc))
    got = tfr.apply_head({k: torch.from_numpy(v) for k, v in head.items()},
                         torch.from_numpy(s), tc)
    np.testing.assert_allclose(got.numpy(), want, rtol=HEAD_RTOL, atol=HEAD_ATOL)


def test_saturated_logistic_head_has_finite_gradients():
    # |b4| tiny: z reaches ±1e6; the sigmoid form saturates without inf
    head = {k: torch.from_numpy(v).requires_grad_(True)
            for k, v in _head("logistic").items()}
    head["b4"] = torch.tensor([1e-7], requires_grad=True)
    s = torch.linspace(0.0, 0.4, 9)
    pred = tfr.apply_head(head, s, TConfig(regression_type="logistic"))
    pred.sum().backward()
    assert torch.isfinite(pred).all()
    for v in head.values():
        assert torch.isfinite(v.grad).all()


def test_stats_and_scene_type_heads_match_jax():
    rng = np.random.default_rng(3)
    s = rng.uniform(0.01, 0.5, 6).astype(np.float32)
    stats = rng.normal(size=(6, 3)).astype(np.float32)
    types = np.array([0, 1, 2, -1, 1, -1], np.int32)
    head = dict(_head("linear"), stats_weight=rng.normal(size=3).astype(np.float32),
                scene_scale=rng.uniform(0.5, 2, 3).astype(np.float32),
                scene_bias=rng.normal(size=3).astype(np.float32))
    jc, tc = _cfgs("linear")
    jh = {k: jnp.asarray(v) for k, v in head.items()}
    th = {k: torch.from_numpy(v) for k, v in head.items()}
    want = jfr.apply_scene_type(jh, jfr.apply_head_with_stats(jh, jnp.asarray(s),
                                                              jnp.asarray(stats), jc),
                                jnp.asarray(types))
    got = tfr.apply_scene_type(th, tfr.apply_head_with_stats(th, torch.from_numpy(s),
                                                             torch.from_numpy(stats), tc),
                               torch.from_numpy(types))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=HEAD_RTOL,
                               atol=HEAD_ATOL)
    # the -1 sentinel leaves the plain head's output untouched
    plain = tfr.apply_head_with_stats(th, torch.from_numpy(s), torch.from_numpy(stats), tc)
    np.testing.assert_array_equal(got.numpy()[types < 0], plain.numpy()[types < 0])
    # fresh heads are zero / identity
    fresh = dict(tfr.init_stats_head(3), **tfr.init_scene_type_head(3))
    np.testing.assert_array_equal(fresh["stats_weight"].numpy(), 0)
    np.testing.assert_array_equal(fresh["scene_scale"].numpy(), 1)


@pytest.mark.parametrize("variant,weight_norm", [
    ("main", ""), ("original", "relu"), ("softmax", "")])
def test_entropy_loss_matches_jax(variant, weight_norm):
    jc, tc = _cfgs("linear", variant=variant, weight_norm=weight_norm)
    original = jdists.load_pretrained_weights(jc.dists)
    rng = np.random.default_rng(4)
    learned = jdists.DISTSWeights(
        jnp.asarray(np.asarray(original.alpha) + rng.normal(0, 0.01, 1475).astype(np.float32)),
        jnp.asarray(np.asarray(original.beta) + rng.normal(0, 0.01, 1475).astype(np.float32)))
    jp = {"head": {}, "dists": learned}
    want = float(jfr.entropy_loss(jp, original, jc))
    tp = fr_params_from_jax(_np(jp))
    got = float(tfr.entropy_loss(tp, fr_params_from_jax(
        {"head": {}, "dists": _np(original)})["dists"], tc))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(5)
    ref = rng.random((3, 48, 64, 3), dtype=np.float32)
    dist = np.clip(ref + rng.normal(0, 0.1, ref.shape), 0, 1).astype(np.float32)
    return dist, ref


@pytest.fixture(scope="module")
def jax_fr_params():
    x, y = _scores()
    return jfr.init_params(x, y, JConfig(regression_type="logistic"),
                           n_stats=2, n_scene_types=3)


def test_fr_params_bridge_carries_every_leaf(jax_fr_params):
    got = fr_params_from_jax(_np(jax_fr_params))
    assert set(got["head"]) == set(jax_fr_params["head"])
    for k, v in jax_fr_params["head"].items():
        np.testing.assert_array_equal(got["head"][k].numpy(), np.asarray(v))
    np.testing.assert_array_equal(got["dists"].alpha.numpy(),
                                  np.asarray(jax_fr_params["dists"].alpha))
    np.testing.assert_array_equal(got["dists"].beta.numpy(),
                                  np.asarray(jax_fr_params["dists"].beta))
    labels = tfr.param_labels(got)
    assert len(labels["head"]) == len(got["head"]) and len(labels["dists"]) == 2


@pytest.mark.parametrize("jax_impl,port_impl", [("xla", "eager"), ("pallas", "kernel")])
def test_forward_and_forward_from_stats_match_jax(jax_params, torch_model, pairs,
                                                  jax_fr_params, jax_impl, port_impl):
    dist, ref = pairs
    jc, _ = _cfgs("logistic", stats_impl=jax_impl)
    tc = TConfig(regression_type="logistic", dists=TDConfig(stats_impl=port_impl))
    stats = np.random.default_rng(6).normal(size=(3, 2)).astype(np.float32)
    types = np.array([2, -1, 0], np.int32)
    want_pred, want_s = jfr.forward(jax_fr_params, jax_params, jnp.asarray(dist),
                                    jnp.asarray(ref), jc, jnp.asarray(stats),
                                    jnp.asarray(types))
    tp = fr_params_from_jax(_np(jax_fr_params))
    args = (torch.from_numpy(stats), torch.from_numpy(types))
    pred, s = tfr.forward(tp, torch_model, torch.from_numpy(dist),
                          torch.from_numpy(ref), tc, *args)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), atol=SCORE_ATOL)
    np.testing.assert_allclose(pred.numpy(), np.asarray(want_pred), atol=SCORE_ATOL * 10)
    # the cached route is the same function of the same statistics
    st = tfr.pair_stats(torch_model, torch.from_numpy(dist), torch.from_numpy(ref), tc)
    assert tuple(st.shape) == (5, 3, 1475)
    pred_c, s_c = tfr.forward_from_stats(tp, st, tc, *args)
    torch.testing.assert_close(s_c, s, rtol=0, atol=1e-6)
    torch.testing.assert_close(pred_c, pred, rtol=0, atol=1e-5)
