"""The port's spatial (H-sharded) DISTS and ADISTS (parallel/spatial.py)
on an eight-device CPU mesh (data 2 x model 4, the JAX tests' layout)
against the JAX package's single-device forwards and the port's own, on
bridged VGG weights at 64 x 32 (every level splits; ADISTS runs its
windowed branch at levels 0-1 and its global branch at 2-5). Bars: the
JAX spatial tests' (tests/test_spatial_sharding.py), DISTS rtol/atol
2e-5, ADISTS 1e-4. The spatial scorer mode of FrameScorer, the
unaligned-frame errors, the channel blocks of a three-channel stage
over four devices, and the kernels' calls per slab and per block
(their wrappers' plain versions run here; the card runs the kernels,
chip_smoke.py). The case against JAX's own spatial_dists_forward on its
virtual mesh compiles for ~30 s here and is slow-marked."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_qa_torch.config import ADISTSConfig as TAConfig
from nerf_qa_torch.config import DISTSConfig as TConfig
from nerf_qa_torch.core import adists as tadists
from nerf_qa_torch.core import dists as tdists
from nerf_qa_torch.eval.video_scorer import FrameScorer
from nerf_qa_torch.parallel import spatial
from nerf_qa_torch.parallel import mesh as tmesh
from nerf_qa_torch.parallel.mesh import create_mesh, replicate
from nerf_qa_tpu.config import ADISTSConfig as JAConfig
from nerf_qa_tpu.config import DISTSConfig as JConfig
from nerf_qa_tpu.core import adists as jadists
from nerf_qa_tpu.core import dists as jdists
from nerf_qa_tpu.eval.video_scorer import FrameScorer as JFrameScorer
from tests.torch_parity import jax_params, np_params, one_torch_thread, torch_model  # noqa: F401

DISTS_TOL = 2e-5
ADISTS_TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    x = rng.random((2, 64, 32, 3), dtype=np.float32)
    y = np.clip(x + rng.normal(0, 0.05, x.shape).astype(np.float32), 0, 1)
    return x, y


@pytest.fixture(scope="module")
def mesh():
    return create_mesh(["cpu"] * 8, model_parallel=4)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_spatial_dists_matches_jax_and_single_device(jax_params, torch_model, pair, mesh):
    x, y = pair
    want = np.asarray(jdists.forward(jax_params, jdists.load_pretrained_weights(),
                                     jnp.asarray(x), jnp.asarray(y), JConfig()))
    w = tdists.load_pretrained_weights()
    with torch.no_grad():
        got = spatial.spatial_dists_forward(replicate(mesh, torch_model), w, *_t(x, y), mesh, TConfig())
        single = tdists.forward(torch_model, w, *_t(x, y), TConfig())
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=DISTS_TOL, atol=DISTS_TOL)
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=DISTS_TOL, atol=DISTS_TOL)


@pytest.mark.slow
def test_spatial_dists_matches_jax_spatial(jax_params, torch_model, pair, mesh):
    # JAX's spatial_dists_forward on its virtual data 2 x model 4 mesh
    # (~30 s of XLA compile on the CPU)
    from nerf_qa_tpu.parallel import mesh as jmesh
    from nerf_qa_tpu.parallel.spatial import shard_frames_spatial, spatial_dists_forward

    x, y = pair
    jm = jmesh.create_mesh(jax.devices()[:8], model_parallel=4)
    xs, ys = shard_frames_spatial(jm, (x, y))
    want = np.asarray(spatial_dists_forward(jax_params, jdists.load_pretrained_weights(),
                                            xs, ys, jm, JConfig()))
    with torch.no_grad():
        got = spatial.spatial_dists_forward(replicate(mesh, torch_model), tdists.load_pretrained_weights(),
                                            *_t(x, y), mesh, TConfig())
    np.testing.assert_allclose(got.numpy(), want, rtol=DISTS_TOL, atol=DISTS_TOL)


@pytest.mark.parametrize("kw", [dict(as_loss=False), dict(as_map=True)])
def test_spatial_adists_matches_jax_and_single_device(jax_params, torch_model, pair,
                                                      mesh, kw):
    x, y = pair
    want = np.asarray(jadists.forward(jax_params, jnp.asarray(x), jnp.asarray(y),
                                      JAConfig(), **kw))
    with torch.no_grad():
        got = spatial.spatial_adists_forward(replicate(mesh, torch_model), *_t(x, y), mesh, TAConfig(), **kw)
        single = tadists.forward(torch_model, *_t(x, y), TAConfig(), **kw)
    assert tuple(got.shape) == want.shape == tuple(single.shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=ADISTS_TOL, atol=ADISTS_TOL)
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=ADISTS_TOL,
                               atol=ADISTS_TOL)


def test_model_axis_of_one_is_the_single_device_pyramid(torch_model, pair):
    # one slab: no halo, the single-device ops in the same order
    x, y = pair
    w = tdists.load_pretrained_weights()
    mesh = create_mesh(["cpu"] * 2)
    with torch.no_grad():
        got = spatial.spatial_dists_forward(replicate(mesh, torch_model), w, *_t(x, y),
                                            mesh, TConfig())
        feats = spatial._pyramid_spatial([torch_model], [torch.from_numpy(x)],
                                         torch.float32)[0]
        want = torch_model(torch.from_numpy(x))
    assert all(torch.equal(a, b) for a, b in zip(feats, want))
    np.testing.assert_allclose(
        got.numpy(), tdists.forward(torch_model, w, *_t(x, y),
                                    TConfig(stats_impl="kernel")).numpy(),
        rtol=DISTS_TOL, atol=DISTS_TOL)


@pytest.mark.parametrize("fn", ["dists", "adists"])
@pytest.mark.parametrize("hw", [(50, 32), (64, 40), (32, 32)])
def test_spatial_rejects_unaligned(torch_model, mesh, fn, hw):
    # H must divide by 4 * 16, W by 16 (the JAX check and message)
    x = torch.zeros((2, *hw, 3))
    with pytest.raises(ValueError, match="H % 64 == 0 and W % 16 == 0"):
        if fn == "dists":
            spatial.spatial_dists_forward(replicate(mesh, torch_model), tdists.load_pretrained_weights(),
                                          x, x, mesh)
        else:
            spatial.spatial_adists_forward(replicate(mesh, torch_model), x, x, mesh)


def test_frame_scorer_spatial_mode_matches_jax(jax_params, torch_model, pair, mesh):
    # uint8 frames at input resolution: the port's spatial scorer against
    # the JAX scorer at full size on one device (the spatial mode's
    # semantics), fp32
    x, y = pair
    xu, yu = (x * 255).astype(np.uint8), (y * 255).astype(np.uint8)
    want = JFrameScorer(jax_params, jdists.load_pretrained_weights(), JConfig(),
                        resize_to=None).score_frames(xu, yu, batch_size=2)
    got = FrameScorer(torch_model, tdists.load_pretrained_weights(), TConfig(),
                      resize_to=None, mesh=mesh, spatial=True).score_frames(
        xu, yu, batch_size=2)
    np.testing.assert_allclose(got, want, rtol=DISTS_TOL, atol=DISTS_TOL)


def test_frame_scorer_spatial_places_its_models_once(torch_model, pair, mesh,
                                                      monkeypatch):
    # the per-device pyramids are made when the scorer is built, not per
    # batch
    calls = []
    real = tmesh.replicate
    monkeypatch.setattr(tmesh, "replicate", lambda m, o: calls.append(o) or real(m, o))
    x, y = pair
    xu, yu = (x * 255).astype(np.uint8), (y * 255).astype(np.uint8)
    scorer = FrameScorer(torch_model, tdists.load_pretrained_weights(), TConfig(),
                         resize_to=None, mesh=mesh, spatial=True)
    built = len(calls)
    scorer.score_frames(np.concatenate([xu, xu]), np.concatenate([yu, yu]), batch_size=2)
    assert built == len(calls) and any(o is scorer.model for o in calls)


@pytest.mark.parametrize("kw,msg", [(dict(resize_to=(32, 32)), "full-resolution"),
                                    (dict(resize_to=None, mesh=None), "requires a mesh")])
def test_frame_scorer_spatial_requires_a_mesh_and_full_size(torch_model, mesh, kw, msg):
    kw = dict(dict(mesh=mesh), **kw)
    with pytest.raises(ValueError, match=msg):
        FrameScorer(torch_model, tdists.load_pretrained_weights(), spatial=True,
                    device="cpu", **kw)


def test_channel_blocks_of_a_three_channel_stage(torch_model, pair):
    # C = 3 over four devices: blocks of one channel, the last all padding
    # (zero, masked out), each at full height
    feats = [[torch.arange(2 * 4 * 5 * 3, dtype=torch.float32).reshape(2, 4, 5, 3) + s]
             for s in range(4)]
    blocks, mask, c = spatial._channel_blocks(feats, 0, 4, [torch.device("cpu")] * 4)
    assert c == 3 and mask.tolist() == [1.0, 1.0, 1.0, 0.0]
    full = torch.cat([f[0] for f in feats], dim=1)
    for b in range(3):
        assert torch.equal(blocks[b], full[..., b:b + 1])
    assert blocks[3].shape == (2, 16, 5, 1) and not blocks[3].any()
    assert all(b.is_contiguous() for b in blocks)


def test_kernels_are_called_per_slab_and_per_block(torch_model, pair, mesh, monkeypatch):
    # the moments kernel's wrapper: six calls a slab (4 slabs x 2 data
    # shards); the T/S kernel's: one per windowed stage (levels 0-1) per
    # channel block (4), per data shard; each on a contiguous slab or block
    calls = {"moments": [], "tsd": []}
    real_m, real_t = spatial.moment_sums, spatial.windowed_tsd

    def moments(fx, fy):
        calls["moments"].append(tuple(fx.shape))
        assert fx.is_contiguous() and fy.is_contiguous()
        return real_m(fx, fy)

    def tsd(fx, fy, *a, **k):
        calls["tsd"].append(tuple(fx.shape))
        assert fx.is_contiguous() and fy.is_contiguous()
        return real_t(fx, fy, *a, **k)

    monkeypatch.setattr(spatial, "moment_sums", moments)
    monkeypatch.setattr(spatial, "windowed_tsd", tsd)
    x, y = pair
    with torch.no_grad():
        spatial.spatial_dists_forward(replicate(mesh, torch_model), tdists.load_pretrained_weights(),
                                      *_t(x, y), mesh)
        spatial.spatial_adists_forward(replicate(mesh, torch_model), *_t(x, y), mesh, as_loss=False)
    assert len(calls["moments"]) == 6 * 4 * 2
    # level by level, each over the four slabs of the first data shard
    assert calls["moments"][:24:4] == [(1, 16, 32, 3), (1, 16, 32, 64), (1, 8, 16, 128),
                                       (1, 4, 8, 256), (1, 2, 4, 512), (1, 1, 2, 512)]
    assert len(calls["tsd"]) == 2 * 4 * 2
    # level 1 (64 channels, blocks of 16), then level 0 (3, blocks of 1)
    assert calls["tsd"][:8] == [(1, 64, 32, 16)] * 4 + [(1, 64, 32, 1)] * 4
