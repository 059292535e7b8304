"""``tools/verify_assets`` of the port on the CPU (``--device cpu``),
against checkpoints written in the reference torch layouts, as the JAX
package's ``tests/test_verify_assets.py`` builds them: a torchvision VGG16
state dict, ``weights.pt``, an FR ``model.pth`` exported by the JAX package,
and (the port's own seeded modules) a DINOv2 ViT, a FeatUp upsampler and a
v8 NR decoder. On the FR set both packages' tools run on the same directory
and agree on every line's status and numbers; the ViT, FeatUp and NR checks
pass on the second set; an empty directory, corrupt α/β and a decoder of
another layout fail as the JAX tool fails.

Tolerance: the printed numbers (four decimals, an SRCC to three) are held
equal."""
import re

import numpy as np
import pytest
import torch

from nerf_qa_torch.config import NRModelConfig
from nerf_qa_torch.models.nr.decoder import NRDecoder
from nerf_qa_torch.models.nr.featup import JBUStack
from nerf_qa_torch.models.nr.layers import init_lecun_normal_
from nerf_qa_torch.models.nr.vit import ViTS14, init_vit_
from nerf_qa_torch.tools import verify_assets as tva
from nerf_qa_tpu.compat.export_torch import export_fr_state_dict, save_state_dict
from nerf_qa_tpu.config import FRModelConfig
from nerf_qa_tpu.core import dists
from nerf_qa_tpu.core.vgg import VGG16_STAGES, init_vgg16_params
from nerf_qa_tpu.models import fr
from nerf_qa_tpu.tools import verify_assets as jva
from tests.torch_parity import one_torch_thread  # noqa: F401

CONV_IDX = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))


def _vgg_pth(path):
    rng = np.random.default_rng(0)
    state = {}
    for stage, idxs in zip(VGG16_STAGES, CONV_IDX):
        for (cin, cout), i in zip(stage, idxs):
            state[f"features.{i}.weight"] = torch.from_numpy(
                rng.normal(0, 0.05, (cout, cin, 3, 3)).astype(np.float32))
            state[f"features.{i}.bias"] = torch.from_numpy(
                rng.normal(0, 0.01, (cout,)).astype(np.float32))
    torch.save(state, path)


def _weights_pt(path, scale=1.0):
    w = dists.load_pretrained_weights()
    torch.save({"alpha": torch.from_numpy(np.array(w.alpha).reshape(1, 1475, 1, 1) * scale),
                "beta": torch.from_numpy(np.array(w.beta).reshape(1, 1475, 1, 1))}, path)


def _fr_model_pth(path):
    rng = np.random.default_rng(0)
    x = rng.uniform(0.001, 0.2, 24)  # random-VGG score scale
    y = 5.0 - 20.0 * x + rng.normal(0, 0.05, 24)
    cfg = FRModelConfig(regression_type="logistic")
    params = fr.init_params(x, y, cfg,
                            dists_weights=dists.load_pretrained_weights(cfg.dists))
    save_state_dict(export_fr_state_dict(params, vgg_params=init_vgg16_params(seed=0)),
                    str(path))


def _dinov2_pth(path, depth=12):
    """A dinov2_vits14_reg state dict: the port's ViT keys, with the CLS row
    of ``pos_embed`` the checkpoint carries."""
    sd = init_vit_(ViTS14(depth=depth), torch.Generator().manual_seed(4)).state_dict()
    sd["pos_embed"] = torch.cat([torch.zeros(1, 1, sd["pos_embed"].shape[-1]),
                                 sd["pos_embed"]], dim=1)
    torch.save(sd, path)


def _featup_pth(path):
    """A FeatUp hub checkpoint: the upsampler under ``upsampler.``."""
    jbu = init_lecun_normal_(JBUStack(384), torch.Generator().manual_seed(5))
    torch.save({f"upsampler.{k}": v for k, v in jbu.state_dict().items()}, path)


def _nr_model_pth(path, trans=2, refine=2):
    """A train-nr.py v8 save: the decoder's reference-layout keys."""
    dec = init_lecun_normal_(NRDecoder(NRModelConfig(transformer_decoder_depth=trans,
                                                     refine_up_depth=refine)),
                             torch.Generator().manual_seed(6))
    torch.save(dec.state_dict(), path)


def _lines(out):
    return {m.group(1): (m.group(2), m.group(3)) for m in
            re.finditer(r"verify_assets: (\w+): (PASS|FAIL|SKIP) — (.*)", out)}


@pytest.fixture(scope="module")
def fr_assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("assets")
    _vgg_pth(d / "vgg16-397923af.pth")
    _weights_pt(d / "weights.pt")
    _fr_model_pth(d / "model.pth")
    return d


def test_discovers_and_matches_jax(fr_assets, capsys):
    rc = tva.main(["--assets-dir", str(fr_assets), "--device", "cpu"])
    got = _lines(capsys.readouterr().out)
    assert rc == jva.main(["--assets-dir", str(fr_assets)]) == 0
    want = _lines(capsys.readouterr().out)
    assert {k: s for k, (s, _) in got.items()} == {k: s for k, (s, _) in want.items()} == {
        "vgg_sanity": "PASS", "dists_weights": "PASS", "dinov2": "SKIP",
        "featup_jbu": "SKIP", "fr_model": "PASS", "nr_model": "SKIP"}
    # the same distortion ladder scores and the same head correlation
    for name, pattern in (("vgg_sanity", r"scores (\[.*?\])"),
                          ("fr_model", r"SRCC\(pred, MOS\)=(\S+)")):
        assert (re.search(pattern, got[name][1]).group(1)
                == re.search(pattern, want[name][1]).group(1)), name


def test_the_nr_checks_pass(tmp_path, capsys):
    """The checks the FR set skips: the ViT, the FeatUp upsampler (an NR v8
    forward with both) and an NR decoder."""
    _dinov2_pth(tmp_path / "dinov2_vits14_reg4.pth")
    _featup_pth(tmp_path / "featup_jbu.pth")
    # depths 1 / 1: the check runs three fp32 forwards at 128² on the CPU
    _nr_model_pth(tmp_path / "model_nr.pth", trans=1, refine=1)
    rc = tva.main(["--assets-dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert {k: s for k, (s, _) in _lines(out).items()} == {
        "vgg_golden": "SKIP", "dists_weights": "SKIP", "dinov2": "PASS",
        "featup_jbu": "PASS", "fr_model": "SKIP", "nr_model": "PASS"}, out


@pytest.mark.parametrize("trans,refine", [(2, 2), (1, 2), (0, 1)])
def test_nr_depths_are_read_from_the_keys(tmp_path, trans, refine):
    _nr_model_pth(tmp_path / "m.pth", trans, refine)
    sd = torch.load(tmp_path / "m.pth")
    assert tva.nr_depths(sd) == (trans, refine)


def test_nr_model_of_another_layout_fails(tmp_path, capsys):
    torch.save({"decoder.0.block.0.conv.weight": torch.zeros(3, 3, 3, 3)},
               tmp_path / "model_nr.pth")
    rc = tva.main(["--nr-model", str(tmp_path / "model_nr.pth"), "--device", "cpu"])
    assert rc == 1
    assert "nr_model: FAIL — import failed" in capsys.readouterr().out


def test_empty_dir(tmp_path, capsys):
    assert tva.main(["--assets-dir", str(tmp_path), "--device", "cpu"]) == 2
    assert "nothing to verify" in capsys.readouterr().out


def test_detects_corrupt_weights(tmp_path, capsys):
    _weights_pt(tmp_path / "weights.pt", scale=2.0)
    rc = tva.main(["--assets-dir", str(tmp_path), "--device", "cpu",
                   "--dists-weights", str(tmp_path / "weights.pt")])
    assert rc == 1
    assert "dists_weights: FAIL" in capsys.readouterr().out
