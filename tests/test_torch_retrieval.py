"""Retrieval and pseudo-FR scoring of the port (``nerf_qa_torch/eval/
retrieval.py``) against the JAX package's on the CPU, with the same VGG
weights (``init_vgg16_params(seed=0)`` carried across) and fp32 pyramids:
the descriptors and the index's rankings, the bilinear warp, the coarse
matcher's grid and certainty, the antialiased map resize in both
directions and the certainty-masked DISTS; the chained pseudo-FR score
against its own parts (its matcher runs a bf16 pyramid, as JAX's does).

Tolerance: fp32, rel 1e-4 / atol 1e-5 (descriptors, similarities, warps,
scores, certainties); the matcher's grid, in pixels, atol 1e-3: the local
soft-argmax divides correlations by a temperature of 0.01 and the grid is
scaled by the stage's stride of 4, which turns the correlations' ~1e-7
fp32 differences into larger ones of the coordinates (measured: 7.2e-5 px;
the certainty 7.7e-7)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_qa_torch.config import DISTSConfig
from nerf_qa_torch.core import dists as tdists
from nerf_qa_torch.eval import retrieval as tret
from nerf_qa_torch.ops.resize import resize_bilinear_aa
from nerf_qa_tpu.config import DISTSConfig as JDISTSConfig
from nerf_qa_tpu.core import dists as jdists
from nerf_qa_tpu.eval import retrieval as jret
from tests.torch_parity import jax_params, np_params, one_torch_thread, torch_model  # noqa: F401

RTOL = 1e-4
ATOL = 1e-5
GRID_ATOL = 1e-3


def scene(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(n):
        f = 4.0 + 2.5 * i
        out.append(np.stack([
            0.5 + 0.4 * np.sin(xx / f + i) * np.cos(yy / (f + 3.0)),
            0.5 + 0.4 * np.cos((xx - yy) / (f + 1.0)),
            rng.random((h, w)),
        ], axis=-1))
    return np.stack(out).astype(np.float32)


@pytest.fixture(scope="module")
def shifted_pair():
    """A reference and a render that is the reference shifted by (3, 5) px."""
    big = scene(2, 80, 96, seed=1)
    return big[:, 8:72, 8:88].copy(), big[:, 5:69, 3:83].copy()


def test_embed_and_retrieve_match_jax(jax_params, torch_model):  # noqa: F811
    corpus = scene(8, 48, 64, seed=2)
    j = jret.ImageRetrieval(jax_params, compute_dtype=jnp.float32)
    t = tret.ImageRetrieval(torch_model, compute_dtype=torch.float32)
    j.build_index(corpus, batch_size=4)
    t.build_index(corpus, batch_size=4)
    np.testing.assert_allclose(t.index, j.index, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(t.index, axis=1), 1.0, rtol=1e-6)
    ti, ts = t.retrieve(corpus, k=3)
    ji, js = j.retrieve(corpus, k=3)
    np.testing.assert_array_equal(ti[:, 0], np.arange(8))  # each finds itself
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=ATOL)
    with pytest.raises(RuntimeError, match="build_index"):
        tret.ImageRetrieval(torch_model).retrieve(corpus)


def test_warp_image_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.random((2, 20, 24, 3), dtype=np.float32)
    grid = rng.uniform(-2, 26, (2, 20, 24, 2)).astype(np.float32)
    got = tret.warp_image(torch.from_numpy(img), torch.from_numpy(grid)).numpy()
    want = np.asarray(jret.warp_image(jnp.asarray(img), jnp.asarray(grid)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    yy, xx = np.mgrid[0:20, 0:24].astype(np.float32)
    ident = np.broadcast_to(np.stack([yy, xx], -1), (2, 20, 24, 2)).copy()
    np.testing.assert_allclose(tret.warp_image(torch.from_numpy(img),
                                               torch.from_numpy(ident)).numpy(), img,
                               atol=1e-6)


@pytest.mark.parametrize("src,dst", [((8, 10), (64, 80)), ((64, 80), (16, 20)),
                                     ((16, 20), (13, 29))])
def test_map_resize_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(4).random((2, *src, 2), dtype=np.float32)
    got = resize_bilinear_aa(torch.from_numpy(x), *dst).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 2), "linear"))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_estimate_warp_matches_jax(jax_params, torch_model, shifted_pair):  # noqa: F811
    ref, render = shifted_pair
    tg, tc = tret.estimate_warp(torch_model, torch.from_numpy(render),
                                torch.from_numpy(ref), compute_dtype=torch.float32)
    jg, jc = jret.estimate_warp(jax_params, jnp.asarray(render), jnp.asarray(ref),
                                compute_dtype=jnp.float32)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=GRID_ATOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=RTOL, atol=ATOL)
    assert float(tc.min()) >= 0.0 and float(tc.max()) <= 1.0


def test_masked_dists_score_matches_jax(jax_params, torch_model, shifted_pair):  # noqa: F811
    ref, render = shifted_pair
    tw = tdists.load_pretrained_weights()
    jw = jdists.load_pretrained_weights()
    cert = np.random.default_rng(5).random(render.shape[:3], dtype=np.float32)
    got = tret.masked_dists_score(torch_model, tw, torch.from_numpy(render),
                                  torch.from_numpy(ref), torch.from_numpy(cert),
                                  DISTSConfig()).numpy()
    want = np.asarray(jret.masked_dists_score(
        jax_params, jw, jnp.asarray(render), jnp.asarray(ref), jnp.asarray(cert),
        JDISTSConfig(compute_dtype="float32")))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_pseudo_fr_score_chains_its_parts(torch_model, shifted_pair):  # noqa: F811
    """pseudo_fr_score is estimate_warp (its bf16 matcher, as in JAX) ->
    warp_image -> masked_dists_score, each held to JAX above in fp32; a
    bf16 matcher's grid moves with each backend's bf16 convs, so the chain
    is held to its parts, not to JAX's chain."""
    ref, render = (torch.from_numpy(a) for a in shifted_pair)
    w = tdists.load_pretrained_weights()
    grid, cert = tret.estimate_warp(torch_model, render, ref)
    warped = tret.warp_image(ref, grid)
    # no gate, then a gate at the median certainty (drops half the weight)
    for threshold in (0.0, float(cert.median())):
        got = tret.pseudo_fr_score(torch_model, w, render, ref, DISTSConfig(),
                                   certainty_threshold=threshold)
        gated = torch.where(cert >= threshold, cert, torch.zeros_like(cert))
        want = tret.masked_dists_score(torch_model, w, render, warped, gated,
                                       DISTSConfig())
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        assert np.isfinite(got.numpy()).all()
    assert 0.3 < float((gated == 0).float().mean()) < 0.7


def test_masked_stats_with_unit_certainty_are_the_plain_moments():
    rng = np.random.default_rng(6)
    fx = torch.from_numpy(rng.random((2, 9, 11, 5), dtype=np.float32))
    fy = torch.from_numpy(rng.random((2, 9, 11, 5), dtype=np.float32))
    got = tret.masked_stage_stats(fx, fy, torch.ones(2, 9, 11, 1))
    want = tdists.stage_stats_eager(fx, fy)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-6)
