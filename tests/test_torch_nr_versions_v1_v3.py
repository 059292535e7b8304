"""NR v1-v3 in the port against the JAX package, on the CPU (cases in
tests/torch_nr_versions.py): the eval-mode forward, one training step's
losses, decoder gradient and BatchNorm running averages after it (the
JAX ``new_state``), the v1/v2 channel schedules and v3's RefineDown
re-encoding; the weight bridge's keys for every generation."""
import numpy as np
import pytest
import torch

from nerf_qa_torch.compat import from_jax
from nerf_qa_torch.config import NRModelConfig as TConfig
from nerf_qa_torch.models.nr import layers as tlayers
from nerf_qa_torch.models.nr.decoder import NRDecoder, version_schedules
from nerf_qa_tpu.models.nr.decoder import version_schedules as jax_schedules
from tests.torch_nr_versions import batch, check_case, make_case, run_case
from tests.torch_parity import jax_params, np_params, one_torch_thread, torch_model  # noqa: F401


@pytest.mark.parametrize("version", [1, 2, 3])
def test_version_matches_jax(version, jax_params, torch_model):
    jm, params, state, port = make_case(jax_params, torch_model, version)
    assert "batch_stats" in state
    got, want = run_case(jm, params, state, port, batch())
    worst = check_case(got, want)
    print(f"v{version}: worst gradient gap {worst:.3e}")
    assert set(got["losses"]) == {"l1", "dists_pref2ref", "combined"}
    assert got["state"]  # the BatchNorm generations carry running averages


@pytest.mark.parametrize("version", range(1, 9))
def test_version_schedules_match_jax(version):
    assert version_schedules(version, 384) == jax_schedules(version, 384)


def _jax_decoder_shapes(version: int, jax_params):
    """The JAX decoder's params and batch_stats at 64² / 56² as zeros of
    their shapes (``jax.eval_shape`` of its init: nothing computed)."""
    import jax

    from nerf_qa_tpu.config import NRModelConfig as JConfig
    from nerf_qa_tpu.models.nr.decoder import NRDecoder as JDecoder

    sds = jax.ShapeDtypeStruct
    dists = [sds((1, h, h, c), np.float32)
             for h, c in ((64, 3), (64, 64), (32, 128), (16, 256), (8, 512), (4, 512))]
    sem = sds((1, 4, 4, 384), np.float32)
    pyramid = ([sds((1, h, h, 384), np.float32) for h in (4, 8, 16, 32, 64, 64)]
               if version >= 7 else [])
    dec = JDecoder(cfg=JConfig(version=version, transformer_decoder_depth=1,
                               refine_up_depth=1, dropout_rate=0.0))
    shapes = jax.eval_shape(
        lambda d, s, p, v: dec.init(jax.random.PRNGKey(0), d, s, p, True, v),
        dists, sem, pyramid, jax_params)
    return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes)


@pytest.mark.parametrize("version", range(1, 9))
def test_bridge_keys_are_the_decoders(version, jax_params):
    # the JAX decoder's params and batch_stats map onto exactly the port
    # decoder's state_dict keys and shapes
    variables = _jax_decoder_shapes(version, jax_params)
    sd = from_jax.nr_decoder_state_dict_from_jax(
        variables["params"], qkv_bias=True, layer_scale=True,
        batch_stats=variables.get("batch_stats"), version=version)
    like = NRDecoder(jm_cfg(version), qkv_bias=True, layer_scale=True).state_dict()
    assert sd.keys() == like.keys()
    for k, v in like.items():
        assert sd[k].shape == v.shape, k
    norm = "norm_layer.norm.weight" if version >= 7 else "norm_layer.running_var"
    assert any(k.endswith(norm) for k in sd)
    assert ("batch_stats" in variables) == (version <= 6)


def jm_cfg(version):
    return TConfig(version=version, transformer_decoder_depth=1, refine_up_depth=1,
                   dropout_rate=0.0)


def test_v3_refine_down_predictions(jax_params, torch_model, monkeypatch):
    # v3's predictions come from the RefineDown cascade through the frozen
    # VGG stages: the pyramid's shapes, and the level-0 prediction is the
    # up-cascade's predicted image, ImageNet-normalised (model_nr_v3.py:289-301)
    from nerf_qa_torch.core.vgg import IMAGENET_MEAN, IMAGENET_STD

    _, _, _, port = make_case(jax_params, torch_model, 3)
    seen = []
    real = NRDecoder._refine_down

    def spy(self, feature_map, predicted, vgg, generator):
        seen.append(predicted[0].clone())
        return real(self, feature_map, predicted, vgg, generator)

    monkeypatch.setattr(NRDecoder, "_refine_down", spy)
    _, render, r224 = (torch.from_numpy(a) for a in batch())
    feats = port.encode(render, r224)
    with torch.no_grad():
        predicted, reg = port.apply_decoder(feats)
    assert len(port.decoder.refine_down) == 5 and reg.shape == (2, 4, 4, 1)
    assert [p.shape for p in predicted] == [f.shape for f in feats.dists_feats]
    torch.testing.assert_close(
        predicted[0], (seen[0] - torch.from_numpy(IMAGENET_MEAN))
        / torch.from_numpy(IMAGENET_STD), rtol=0, atol=0)
    keys = port.decoder.state_dict().keys()
    assert any(k.startswith("refine_down.0.block") for k in keys)
    assert not any(k.startswith("refine_down.0.downsample") for k in keys)
    assert any(k.startswith("refine_down.1.downsample_layer") for k in keys)


def test_batchnorm_follows_flax():
    # momentum 0.99 on the running averages, the biased variance, eps 1e-5,
    # fp32 statistics and a bf16 output under a bf16 dtype; eval mode
    # normalises with the running averages
    bn = tlayers.BatchNorm(4, torch.bfloat16).train()
    x = torch.randn((3, 4, 5, 6), generator=torch.Generator().manual_seed(0)) * 2 + 1
    y = bn(x.to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_mean, 0.01 * mean, rtol=1e-2, atol=1e-3)
    torch.testing.assert_close(bn.running_var, 0.99 + 0.01 * var, rtol=1e-3, atol=1e-3)
    assert int(bn.num_batches_tracked) == 1
    bn32 = tlayers.BatchNorm(4).train()
    want = (x - mean[None, :, None, None]) / torch.sqrt(var[None, :, None, None] + 1e-5)
    torch.testing.assert_close(bn32(x), want, rtol=1e-5, atol=1e-5)
    bn32.eval()
    run = bn32.running_mean.clone()
    torch.testing.assert_close(
        bn32(x), (x - run[None, :, None, None])
        / torch.sqrt(bn32.running_var[None, :, None, None] + 1e-5), rtol=1e-5, atol=1e-5)
    assert torch.equal(bn32.running_mean, run)
