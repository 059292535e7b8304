"""NR v4-v6 and the v7/v8 score-regression head in the port against the
JAX package, on the CPU (cases in tests/torch_nr_versions.py): the
eval-mode forward and normalized score, one training step's losses,
decoder gradient and BatchNorm running averages after it; v4's
decoder-off regression, v5's MAE map, v6's calibration under each
``reg_activation`` and its ``forward_normalized``."""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_qa_torch.config import NRModelConfig as TConfig
from nerf_qa_torch.models.nr.model import NRModel
from nerf_qa_tpu.config import NRModelConfig as JConfig
from nerf_qa_tpu.models.nr.model import NRModel as JNRModel
from tests.torch_nr_versions import MEAN, STD, batch, check_case, make_case, run_case
from tests.torch_parity import jax_params, np_params, one_torch_thread, torch_model  # noqa: F401

CASES = {
    "v4": (4, {}, {"l1", "combined"}),
    "v5": (5, {}, {"l1", "mae_reg_l1_loss", "dists_pref2ref", "combined"}),
    "v6-sigmoid": (6, {"reg_activation": "sigmoid"},
                   {"l1", "mae_reg_l1_loss", "dists_std_l1", "dists_mean_l1",
                    "dists_pref2ref", "combined"}),
    "v8-head": (8, {"score_reg_channels": 1}, {"l1", "dists_pref2ref", "combined"}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_version_matches_jax(case, jax_params, torch_model):
    version, cfg, loss_keys = CASES[case]
    jm, params, state, port = make_case(jax_params, torch_model, version, **cfg)
    got, want = run_case(jm, params, state, port, batch())
    worst = check_case(got, want)
    print(f"{case}: worst gradient gap {worst:.3e}")
    assert set(got["losses"]) == loss_keys
    assert bool(got["state"]) == (version <= 6)


def test_v4_is_decoder_off(jax_params, torch_model):
    # no cascade: the regression head on the 16² mix is the model
    _, _, _, port = make_case(jax_params, torch_model, 4)
    keys = port.decoder.state_dict().keys()
    assert not any(k.startswith("decoder.") for k in keys)
    assert any(k.startswith("score_reg.block.1.") for k in keys)
    _, render, r224 = (torch.from_numpy(a) for a in batch())
    with torch.no_grad():
        predicted, reg = port.apply_decoder(port.encode(render, r224))
    assert predicted is None and reg.shape == (2, 4, 4, 1)


def test_v5_combined_folds_the_mae_map(jax_params, torch_model):
    _, _, _, port = make_case(jax_params, torch_model, 5)
    with torch.no_grad():
        losses = port.losses(*(torch.from_numpy(a) for a in batch()))
    c = port.cfg.dists_pref2ref_coeff
    want = c * losses["dists_pref2ref"] + (1 - c) * (losses["l1"] + losses["mae_reg_l1_loss"])
    torch.testing.assert_close(losses["combined"], want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("act", ["linear", "relu", "sigmoid"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_reg_outputs_match_jax(act, k):
    # the pooling and calibration of each head width under each activation
    reg_map = np.random.default_rng(k).standard_normal((3, 5, 6, k)).astype(np.float32) * 3
    want = JNRModel._reg_outputs(SimpleNamespace(cfg=JConfig(reg_activation=act)),
                                 jnp.asarray(reg_map))
    got = NRModel._reg_outputs(SimpleNamespace(cfg=TConfig(reg_activation=act)),
                               torch.from_numpy(reg_map))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6,
                                   atol=1e-7)


def test_v6_calibration_and_losses(jax_params, torch_model):
    # v6 combined = c·pref2ref + (1 − c)·(l1 + mae + std + mean)
    # (model_nr_v6.py:267-269); the normalized score is the calibrated one
    _, _, _, port = make_case(jax_params, torch_model, 6, reg_activation="relu")
    data = [torch.from_numpy(a) for a in batch()]
    with torch.no_grad():
        losses = port.losses(*data, score_std=torch.from_numpy(STD),
                             score_mean=torch.from_numpy(MEAN))
        score, normalized = port.forward_normalized(*data[1:])
        feats = port.encode(*data[1:])
        predicted, reg_map = port.apply_decoder(feats)
        _, reg = port._compose_score(feats, predicted, reg_map)
    c = port.cfg.dists_pref2ref_coeff
    want = c * losses["dists_pref2ref"] + (1 - c) * (
        losses["l1"] + losses["mae_reg_l1_loss"] + losses["dists_std_l1"]
        + losses["dists_mean_l1"])
    torch.testing.assert_close(losses["combined"], want, rtol=1e-6, atol=0)
    assert reg.keys() == {"dists_res", "mae_map", "pred_std", "pred_mean"}
    assert bool((reg["pred_std"] >= 0).all())  # relu calibration
    torch.testing.assert_close(
        normalized, (score - reg["pred_mean"]) / (reg["pred_std"] + 1e-7))


def test_reference_batchnorm_pth_is_refused(tmp_path):
    # a reference-layout .pth of a v1-v6 decoder (BatchNorm entries) is read
    # by neither package: it raises naming why, and loads nothing
    from nerf_qa_torch.compat import pretrained

    from nerf_qa_torch.models.nr.decoder import NRDecoder

    sd = NRDecoder(TConfig(version=2, transformer_decoder_depth=1,
                           refine_up_depth=1)).state_dict()
    torch.save(sd, tmp_path / "v2.pth")
    with pytest.raises(ValueError, match="BatchNorm entries.*neither package"):
        pretrained.load_nr_torch_file(str(tmp_path / "v2.pth"))


def test_port_v6_checkpoint_round_trips(tmp_path):
    # the port's own checkpoint of a v6 decoder, BatchNorm buffers and
    # num_batches_tracked (an integer) included, loads back exactly
    from nerf_qa_torch.compat import checkpoint, pretrained
    from nerf_qa_torch.models.nr.decoder import NRDecoder

    cfg = TConfig(version=6, transformer_decoder_depth=1, refine_up_depth=1)
    dec = NRDecoder(cfg)
    with torch.no_grad():
        for k, v in dec.state_dict().items():
            if v.is_floating_point():
                v.copy_(torch.randn(v.shape, generator=torch.Generator().manual_seed(len(k))))
            else:
                v.fill_(3)
    checkpoint.save_checkpoint(str(tmp_path / "ckpt"), 1, {"decoder": dec.state_dict()})
    sd, ab = pretrained.load_nr_torch_file(str(tmp_path / "ckpt"))
    assert ab is None
    back = NRDecoder.from_state_dict(sd, cfg)
    for k, v in dec.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    assert back.state_dict()["trans2sem.norm_layer.num_batches_tracked"].dtype == torch.long
