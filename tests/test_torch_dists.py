"""The port's DISTS (core/dists.py) against the JAX package on the CPU:
scores in fp32 and bf16, both stats paths, the α/β gradient, the weight
variants and projection. Inputs and weights come from numpy seeds and
``init_vgg16_params(seed=0)`` through ``compat.from_jax``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_qa_torch.compat.from_jax import dists_weights_from_jax
from nerf_qa_torch.config import DISTSConfig as TConfig
from nerf_qa_torch.core import dists as tdists
from nerf_qa_tpu.config import DISTSConfig as JConfig
from nerf_qa_tpu.core import dists as jdists
from nerf_qa_tpu.core.vgg import vgg16_pyramid
from tests.torch_parity import jax_params, np_params, one_torch_thread, torch_model  # noqa: F401


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(42)
    x = rng.random((2, 64, 96, 3), dtype=np.float32)
    y = np.clip(x + rng.normal(0, 0.08, x.shape).astype(np.float32), 0, 1)
    return x, y


@pytest.fixture(scope="module")
def jax_fp32_score(jax_params, images):
    x, y = images
    w = jdists.load_pretrained_weights()
    return np.asarray(jdists.forward(jax_params, w, jnp.asarray(x), jnp.asarray(y)))


def _t(a):
    return torch.from_numpy(np.array(a))


def jvgg_feats(jax_params, x):
    return vgg16_pyramid(jax_params, jnp.asarray(x))


@pytest.mark.parametrize("stats_impl", ["eager", "kernel"])
def test_fp32_score_matches_jax(torch_model, images, jax_fp32_score, stats_impl):
    # fp32 end to end, both stats paths: atol 1e-4 (the BASELINE parity bar)
    x, y = images
    w = tdists.load_pretrained_weights()
    got = tdists.forward(torch_model, w, _t(x), _t(y),
                         TConfig(stats_impl=stats_impl))
    assert tuple(got.shape) == (2,)
    np.testing.assert_allclose(got.numpy(), jax_fp32_score, atol=1e-4)


@pytest.mark.parametrize("stats_impl", ["eager", "kernel"])
def test_identical_pair_scores_zero(torch_model, images, stats_impl):
    x, _ = images
    w = tdists.load_pretrained_weights()
    got = tdists.forward(torch_model, w, _t(x), _t(x),
                         TConfig(stats_impl=stats_impl))
    np.testing.assert_allclose(got.numpy(), 0.0, atol=1e-5)


def test_bf16_score_matches_jax_bf16(jax_params, torch_model, images):
    # bf16 rounds at other places in the two frameworks (conv outputs,
    # bias, the pooled map): atol 5e-3
    x, y = images
    jw = jdists.load_pretrained_weights()
    want = np.asarray(jdists.forward(jax_params, jw, jnp.asarray(x), jnp.asarray(y),
                                     JConfig(compute_dtype="bfloat16")))
    got = tdists.forward(torch_model, tdists.load_pretrained_weights(), _t(x),
                         _t(y), TConfig(compute_dtype="bfloat16"))
    gap = float(np.abs(got.numpy() - want).max())
    print(f"bf16 score gap port vs JAX: {gap:.3e}")
    assert gap <= 5e-3


def test_stats_paths_agree_on_features(torch_model, images):
    x, y = images
    f0 = torch_model(_t(x))
    f1 = torch_model(_t(y))
    eager = tdists.pyramid_stats(f0, f1, TConfig(stats_impl="eager"))
    kern = tdists.pyramid_stats(f0, f1, TConfig(stats_impl="kernel"))
    assert tuple(eager.shape) == (5, 2, tdists.TOTAL_CHANNELS)
    torch.testing.assert_close(kern, eager, rtol=2e-5, atol=1e-6)


def test_unknown_stats_impl_raises(torch_model, images):
    x, y = images
    with pytest.raises(ValueError, match="stats_impl"):
        tdists.forward(torch_model, tdists.load_pretrained_weights(), _t(x),
                       _t(y), TConfig(stats_impl="pallas"))


def _trainable(w):
    return tdists.DISTSWeights(w.alpha.clone().requires_grad_(True),
                               w.beta.clone().requires_grad_(True))


@pytest.mark.parametrize("variant", ["main", "softmax"])
def test_alpha_beta_gradient_matches_jax(jax_params, images, variant):
    # autograd through score_from_stats vs jax.grad on the same statistics
    # (the JAX pyramid's, as numpy): rtol 1e-4, atol 1e-7
    x, y = images
    cfg_j, cfg_t = JConfig(variant=variant), TConfig(variant=variant)
    stats = jdists.pyramid_stats(jvgg_feats(jax_params, x),
                                 jvgg_feats(jax_params, y))
    jw = jdists.load_pretrained_weights(cfg_j)
    g = jax.grad(lambda w: jdists.score_from_stats(stats, w, cfg_j).mean())(jw)
    tw = _trainable(tdists.load_pretrained_weights(cfg_t))
    tdists.score_from_stats(_t(stats), tw, cfg_t).mean().backward()
    np.testing.assert_allclose(tw.alpha.grad.numpy(), np.asarray(g.alpha),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(tw.beta.grad.numpy(), np.asarray(g.beta),
                               rtol=1e-4, atol=1e-7)


def test_alpha_beta_gradient_end_to_end(jax_params, torch_model, images):
    # through each package's own pyramid and statistics. atol 1e-4: the
    # reference covariance E[xy] - x̄ȳ cancels ~20x on deep stages, so fp32
    # reduction order alone moves a channel's S2, and its gradient, by
    # ~2e-5 (measured on these inputs); the score itself holds at 1e-4.
    x, y = images
    jw = jdists.load_pretrained_weights()
    g = jax.grad(lambda w: jdists.forward(jax_params, w, jnp.asarray(x),
                                          jnp.asarray(y), batch_average=True))(jw)
    tw = _trainable(tdists.load_pretrained_weights())
    tdists.forward(torch_model, tw, _t(x), _t(y), batch_average=True).backward()
    np.testing.assert_allclose(tw.alpha.grad.numpy(), np.asarray(g.alpha),
                               atol=1e-4)
    np.testing.assert_allclose(tw.beta.grad.numpy(), np.asarray(g.beta),
                               atol=1e-4)
    assert np.abs(tw.alpha.grad.numpy()).max() > 0


def test_kernel_stats_refuse_feature_gradients(torch_model, images):
    x, y = images
    xt = _t(x).clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        tdists.forward(torch_model, tdists.load_pretrained_weights(), xt, _t(y),
                       TConfig(stats_impl="kernel"), stop_feature_grad=False)


def test_batch_average_and_forward_once(torch_model, images):
    x, y = images
    w = tdists.load_pretrained_weights()
    per = tdists.forward(torch_model, w, _t(x), _t(y))
    avg = tdists.forward(torch_model, w, _t(x), _t(y), batch_average=True)
    np.testing.assert_allclose(avg.item(), per.mean().item(), rtol=1e-6)
    feats = tdists.forward_once(torch_model, _t(x))
    assert [f.shape[-1] for f in feats] == [3, 64, 128, 256, 512, 512]


def test_shape_mismatch_raises(torch_model):
    with pytest.raises(ValueError):
        tdists.forward(torch_model, tdists.load_pretrained_weights(),
                       torch.zeros(1, 8, 8, 3), torch.zeros(1, 8, 16, 3))


def test_init_random_weights_same_numbers_as_jax():
    t = tdists.init_random_weights(seed=3)
    j = jdists.init_random_weights(seed=3)
    np.testing.assert_array_equal(t.alpha.numpy(), np.asarray(j.alpha))
    np.testing.assert_array_equal(t.beta.numpy(), np.asarray(j.beta))


@pytest.mark.parametrize("variant,extra", [
    ("main", {}), ("softmax", {}),
    ("original", {"weight_lower_bound": 0.01, "alpha_beta_ratio": 0.5}),
])
def test_load_pretrained_weights_variants_match_jax(variant, extra):
    t = tdists.load_pretrained_weights(TConfig(variant=variant, **extra))
    j = jdists.load_pretrained_weights(JConfig(variant=variant, **extra))
    np.testing.assert_array_equal(t.alpha.numpy(), np.asarray(j.alpha))
    np.testing.assert_array_equal(t.beta.numpy(), np.asarray(j.beta))


@pytest.mark.parametrize("cfg", [
    dict(variant="main"), dict(variant="softmax"),
    dict(variant="original", weight_norm="relu+w_sum_detach"),
    dict(variant="main", detach_beta=True),
])
def test_normalized_alpha_beta_matches_jax(cfg):
    rng = np.random.default_rng(9)
    a = rng.normal(0.1, 0.05, 1475).astype(np.float32)
    b = rng.normal(0.1, 0.05, 1475).astype(np.float32)
    ta, tb = tdists.normalized_alpha_beta(tdists.DISTSWeights(_t(a), _t(b)),
                                          TConfig(**cfg))
    ja, jb = jdists.normalized_alpha_beta(jdists.DISTSWeights(jnp.asarray(a),
                                                              jnp.asarray(b)),
                                          JConfig(**cfg))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-9)


def test_project_weights_matches_reference_semantics():
    # as tests/test_dists_parity.py:128-142
    w = tdists.DISTSWeights(
        torch.from_numpy(np.linspace(-0.1, 0.1, 1475, dtype=np.float32)),
        torch.from_numpy(np.linspace(0.1, -0.1, 1475, dtype=np.float32)),
    )
    pw = tdists.project_weights(w, TConfig())
    a, b = pw.alpha.numpy(), pw.beta.numpy()
    assert (a[3:] >= 0).all() and (b[3:] >= 0).all()
    floor = np.concatenate([[0.02] * 3, [0.0] * 1472])
    raw_a = np.maximum(w.alpha.numpy(), floor)
    raw_b = np.maximum(w.beta.numpy(), floor)
    s = raw_a.sum() + raw_b.sum()
    np.testing.assert_allclose(a, raw_a / s, rtol=1e-6)
    np.testing.assert_allclose(b, raw_b / s, rtol=1e-6)
    np.testing.assert_allclose(a.sum() + b.sum(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("variant", ["main", "original"])
def test_project_weights_matches_jax(variant):
    cfg = dict(variant=variant, weight_lower_bound=0.001, alpha_beta_ratio=2.0)
    a = np.linspace(-0.1, 0.1, 1475, dtype=np.float32)
    b = np.linspace(0.1, -0.1, 1475, dtype=np.float32)
    t = tdists.project_weights(tdists.DISTSWeights(_t(a), _t(b)), TConfig(**cfg))
    j = jdists.project_weights(jdists.DISTSWeights(jnp.asarray(a), jnp.asarray(b)),
                               JConfig(**cfg))
    np.testing.assert_allclose(t.alpha.numpy(), np.asarray(j.alpha), rtol=1e-6)
    np.testing.assert_allclose(t.beta.numpy(), np.asarray(j.beta), rtol=1e-6)


def test_softmax_variant_consistency():
    # as tests/test_dists_parity.py:145-155
    cfg_main = TConfig(variant="main")
    cfg_soft = TConfig(variant="softmax")
    a_m, b_m = tdists.normalized_alpha_beta(
        tdists.load_pretrained_weights(cfg_main), cfg_main)
    a_s, b_s = tdists.normalized_alpha_beta(
        tdists.load_pretrained_weights(cfg_soft), cfg_soft)
    np.testing.assert_allclose(a_s.numpy(), a_m.numpy(), atol=2e-4)
    np.testing.assert_allclose(b_s.numpy(), b_m.numpy(), atol=2e-4)


def test_dists_weights_from_jax_round_trip():
    j = jdists.init_random_weights(seed=1)
    t = dists_weights_from_jax(np.asarray(j.alpha), np.asarray(j.beta))
    np.testing.assert_array_equal(t.alpha.numpy(), np.asarray(j.alpha))
    np.testing.assert_array_equal(t.beta.numpy(), np.asarray(j.beta))
