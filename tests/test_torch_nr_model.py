"""The port's NR v8 model (decoder, encoder, forward) against the JAX
package, on the CPU, at 64² / 56² with a 2-block ViT and decoder depths
1 / 2; weights through compat/from_jax, inputs made by numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_qa_torch.compat import from_jax
from nerf_qa_torch.config import DISTSConfig as TDConfig
from nerf_qa_torch.config import NRModelConfig as TConfig
from nerf_qa_torch.models.nr.decoder import NRDecoder
from nerf_qa_torch.models.nr.model import NRModel
from nerf_qa_torch.ops.cuda import jbu as tjbu
from nerf_qa_tpu.config import DISTSConfig as JDConfig
from nerf_qa_tpu.config import NRModelConfig as JConfig
from nerf_qa_tpu.models.nr.model import NRModel as JNRModel
from tests.torch_parity import (  # noqa: F401
    NR_RENDER,
    NR_SEM,
    jax_nr,
    jax_params,
    np_params,
    nr_config,
    one_torch_thread,
    torch_model,
    torch_nr_from_jax,
)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def renders():
    rng = np.random.default_rng(0)
    return (rng.random((2, NR_RENDER, NR_RENDER, 3), dtype=np.float32),
            rng.random((2, NR_SEM, NR_SEM, 3), dtype=np.float32))


@pytest.fixture(scope="module")
def port_nr(jax_nr, torch_model):
    model, dec_params = jax_nr
    return torch_nr_from_jax(model, dec_params, torch_model, nr_config(TConfig))


def test_nr_forward_fp32_matches_jax(jax_nr, port_nr, renders):
    # ViT -> JBU pyramid -> VGG -> decoder -> DISTS, fp32 on both sides:
    # atol 1e-4 (the JAX package's parity bar against its torch oracle)
    model, dec_params = jax_nr
    r256, r224 = renders
    want = jax.jit(model.forward)(dec_params, jnp.asarray(r256), jnp.asarray(r224))
    with torch.no_grad():
        got = port_nr(torch.from_numpy(r256), torch.from_numpy(r224))
    assert got.shape == (2,) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_nr_forward_bf16_dists_config_matches_jax(jax_nr, jax_params, port_nr,
                                                  renders):
    # the serving config: bf16 VGG pyramid, the port with its kernel stats
    # path (the plain version on the CPU), JAX with its default stats.
    # bf16 rounds at other places in the two frameworks: atol 5e-3, the
    # bar the FR bf16 path is held to
    model, dec_params = jax_nr
    jcfg = nr_config(JConfig, JDConfig(compute_dtype="bfloat16"))
    jm = JNRModel(jax_params, model.dists_weights, jcfg, vit_params=model.vit_params,
                  jbu_params=model.jbu_params, vit=model.vit,
                  render_size=NR_RENDER, sem_size=NR_SEM)
    r256, r224 = renders
    want = jax.jit(jm.forward)(dec_params, jnp.asarray(r256), jnp.asarray(r224))
    tcfg = nr_config(TConfig, TDConfig(compute_dtype="bfloat16", stats_impl="kernel"))
    port = NRModel(port_nr.vgg, port_nr.dists_weights, tcfg, vit=port_nr.vit,
                   jbu=port_nr.jbu, decoder=port_nr.decoder,
                   render_size=NR_RENDER, sem_size=NR_SEM)
    with torch.no_grad():
        got = port(torch.from_numpy(r256), torch.from_numpy(r224)).numpy()
    gap = float(np.abs(got - np.asarray(want)).max())
    print(f"bf16 NR gap port vs JAX: {gap:.3e}")
    assert gap <= 5e-3


def test_decoder_matches_jax_with_random_params(jax_nr, renders):
    # every decoder parameter replaced by noise (qkv bias and LayerScale
    # included, so the decoder is built with both), the same encoder
    # features into both decoders: fp32, rtol/atol 1e-4
    model, dec_params = jax_nr
    rng = np.random.default_rng(3)
    noisy = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.05, np.shape(a))).astype(np.float32),
        dec_params)
    r256, r224 = renders
    feats = jax.jit(model.encode)(jnp.asarray(r256), jnp.asarray(r224))
    want, reg = jax.jit(lambda p, f: model.apply_decoder(p, f)[0])(noisy, feats)
    assert reg is None
    decoder = NRDecoder.from_state_dict(
        from_jax.nr_decoder_state_dict_from_jax(_np(noisy)), nr_config(TConfig)).eval()
    assert "transformer_decoder.0.attn.qkv.bias" in decoder.state_dict()
    to_t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    with torch.no_grad():
        got, reg = decoder([to_t(f) for f in feats.dists_feats], to_t(feats.sem_feats),
                           [to_t(f) for f in feats.sem_pyramid])
    assert reg is None and len(got) == 6
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


LAST_RESAMPLE = "decoder.5.upsample_layer"


def test_v8_forward_skips_the_last_resample(port_nr, renders):
    # the v7/v8 cascade never reads the last stage's resampled map: its
    # layer does not run, every other ChannelNorm runs once
    from nerf_qa_torch.models.nr.layers import ChannelNorm

    ran = {}
    mods = {n: m for n, m in port_nr.decoder.named_modules()
            if isinstance(m, ChannelNorm) or n == LAST_RESAMPLE}
    assert len(mods) == 20  # 19 ChannelNorms and the resample layer
    handles = [m.register_forward_hook(
        lambda mod, args, out, n=n: ran.__setitem__(n, ran.get(n, 0) + 1))
        for n, m in mods.items()]
    r256, r224 = renders
    try:
        with torch.no_grad():
            port_nr(torch.from_numpy(r256), torch.from_numpy(r224))
    finally:
        for h in handles:
            h.remove()
    skipped = {n for n in mods if n.startswith(LAST_RESAMPLE)}
    assert skipped == {LAST_RESAMPLE, LAST_RESAMPLE + ".norm_layer"}
    assert ran == {n: 1 for n in mods if n not in skipped}


def test_decoder_keeps_the_last_resample_weights(jax_nr):
    # the skipped layer's weights stay in the reference layout, so a
    # checkpoint loads with strict=True, and a dict without them does not
    _, dec_params = jax_nr
    sd = from_jax.nr_decoder_state_dict_from_jax(_np(dec_params))
    keys = {k for k in sd if k.startswith(LAST_RESAMPLE + ".")}
    assert keys == {f"{LAST_RESAMPLE}.{k}" for k in (
        "conv.weight", "conv.bias", "norm_layer.norm.weight", "norm_layer.norm.bias")}
    decoder = NRDecoder.from_state_dict(sd, nr_config(TConfig))
    assert decoder.state_dict().keys() == sd.keys()
    for k in keys:
        torch.testing.assert_close(decoder.state_dict()[k], sd[k], rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="Missing key"):
        NRDecoder.from_state_dict({k: v for k, v in sd.items() if k not in keys},
                                  nr_config(TConfig))


def test_encode_shapes_and_frozen_encoder(port_nr, renders):
    r256, r224 = renders
    feats = port_nr.encode(torch.from_numpy(r256), torch.from_numpy(r224))
    assert [f.shape[1] for f in feats.dists_feats] == [64, 64, 32, 16, 8, 4]
    assert [f.shape[1] for f in feats.sem_pyramid] == [4, 8, 16, 32, 64, 64]
    assert feats.sem_feats.shape == (2, 4, 4, 384)
    assert not any(f.requires_grad for f in feats.sem_pyramid)
    assert not any(p.requires_grad for m in (port_nr.vgg, port_nr.vit, port_nr.jbu)
                   for p in m.parameters())
    assert not port_nr.training


def test_cpu_path_takes_plain_jbu(port_nr, renders):
    before = tjbu.launches
    r256, r224 = renders
    port_nr.encode(torch.from_numpy(r256), torch.from_numpy(r224))
    assert tjbu.launches == before  # no kernel launch on CPU tensors


@pytest.mark.parametrize("version", [1, 3, 6])
def test_unported_versions_raise(version, torch_model):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NRDecoder(TConfig(version=version))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NRModel(torch_model, cfg=TConfig(version=version))


def test_decoder_state_dict_matches_export_layout(jax_nr):
    # the same keys and values as the JAX package's export_nr_state_dict
    from nerf_qa_tpu.compat.export_torch import export_nr_state_dict

    _, dec_params = jax_nr
    want = export_nr_state_dict(_np(dec_params))
    got = from_jax.nr_decoder_state_dict_from_jax(_np(dec_params))
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
