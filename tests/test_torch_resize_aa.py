"""The port's antialiased bilinear resize (ops/resize.resize_bilinear_aa)
against the JAX package's on the CPU in fp32 (rtol 1e-5, atol 1e-6:
ROADMAP's bar), and FrameScorer(antialias=True) against the JAX scorer
(fp32 + eager, atol 1e-4 as tests/test_torch_scorer.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_qa_torch.config import DISTSConfig as TConfig
from nerf_qa_torch.core import dists as tdists
from nerf_qa_torch.eval import video_scorer as tvs
from nerf_qa_torch.ops.resize import resize_bilinear_aa
from nerf_qa_tpu.config import DISTSConfig as JConfig
from nerf_qa_tpu.core import dists as jdists
from nerf_qa_tpu.eval.video_scorer import FrameScorer as JFrameScorer
from nerf_qa_tpu.ops.resize import resize_bilinear_aa as jresize_aa
from tests.torch_parity import jax_params, np_params, one_torch_thread, torch_model  # noqa: F401


@pytest.mark.parametrize("n,h,w,oh,ow", [
    (1, 1080, 1920, 256, 256),  # the serving downsample
    (2, 90, 120, 64, 48),  # non-square, unequal ratios
    (2, 100, 37, 64, 23),  # non-integer ratios
    (2, 32, 40, 64, 80),  # upsampling: plain bilinear
    (2, 33, 17, 64, 9),  # up in H, down in W
    (2, 50, 50, 50, 50),  # identity
])
def test_resize_aa_matches_jax(n, h, w, oh, ow):
    x = np.random.default_rng(h * w).random((n, h, w, 3), dtype=np.float32)
    want = np.asarray(jresize_aa(jnp.asarray(x), oh, ow))
    got = resize_bilinear_aa(torch.from_numpy(x), oh, ow)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("batch_size", [2, 5])
def test_frame_scorer_antialias_matches_jax(jax_params, torch_model, batch_size):
    rng = np.random.default_rng(7)
    d = rng.integers(0, 256, (5, 120, 150, 3), dtype=np.uint8)
    r = rng.integers(0, 256, (5, 120, 150, 3), dtype=np.uint8)
    want = JFrameScorer(jax_params, jdists.load_pretrained_weights(), cfg=JConfig(),
                        resize_to=(64, 64), antialias=True).score_frames(
        d, r, batch_size=batch_size)
    scorer = tvs.FrameScorer(torch_model, tdists.load_pretrained_weights(), TConfig(),
                             resize_to=(64, 64), antialias=True, device="cpu")
    got = scorer.score_frames(d, r, batch_size=batch_size)
    np.testing.assert_allclose(got, want, atol=1e-4)
    # the antialiased resize scores differently from the plain one
    plain = tvs.FrameScorer(torch_model, tdists.load_pretrained_weights(), TConfig(),
                            resize_to=(64, 64), device="cpu").score_frames(
        d, r, batch_size=batch_size)
    assert float(np.abs(plain - got).max()) > 1e-3
