"""The weight bridge, checkpoint loading, package isolation and the fp32
path's TF32 guard of the PyTorch port."""
import ast
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_qa_torch.compat import pretrained as tpre
from nerf_qa_torch.compat.from_jax import dists_weights_from_jax, vgg_state_dict_from_jax
from nerf_qa_torch.config import DISTSConfig as TConfig
from nerf_qa_torch.config import true_fp32
from nerf_qa_torch.core import dists as tdists
from nerf_qa_torch.core.vgg import VGG16Pyramid
from nerf_qa_torch.eval.video_scorer import FrameScorer
from nerf_qa_tpu.compat.export_torch import _dists_module_out, export_fr_state_dict
from nerf_qa_tpu.compat.torch_weights import export_vgg16_to_npz
from nerf_qa_tpu.core import dists as jdists
from tests.torch_parity import (  # noqa: F401
    NR_SEM,
    jax_nr,
    jax_params,
    np_params,
    nr_config,
    one_torch_thread,
    torch_nr_from_jax,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "nerf_qa_torch"


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(11)
    x = rng.random((2, 64, 64, 3), dtype=np.float32)
    y = np.clip(x + rng.normal(0, 0.05, x.shape).astype(np.float32), 0, 1)
    return x, y


def test_vgg_state_dict_matches_export_layout(np_params):
    # the same keys and values export_torch._dists_module_out writes
    want: dict = {}
    _dists_module_out(want, "", None, np_params)
    got = vgg_state_dict_from_jax(np_params)
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    assert VGG16Pyramid().state_dict().keys() == got.keys()


def test_exported_fr_model_loads_strict_and_scores_like_jax(jax_params,
                                                            np_params, images):
    # dists_model.* keys of a reference-format FR model.pth -> the port's
    # DISTS module, strict; fp32 score vs the JAX forward: atol 1e-4
    w = jdists.load_pretrained_weights()
    params = {"head": {"weight": np.ones(1, np.float32),
                       "bias": np.zeros(1, np.float32)}, "dists": w}
    sd = export_fr_state_dict(params, vgg_params=np_params)
    prefix = "dists_model."
    sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    model = tdists.DISTS()
    model.load_state_dict(sub, strict=True)
    x, y = images
    got = model.score(torch.from_numpy(x), torch.from_numpy(y))
    want = jdists.forward(jax_params, w, jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)


def test_resolve_vgg_params_formats_agree(np_params, jax_params, tmp_path):
    """.npz (JAX format), a torchvision-style .pth and a reference
    model.pth all give the same pyramid."""
    want = vgg_state_dict_from_jax(np_params)
    npz = str(tmp_path / "vgg.npz")
    export_vgg16_to_npz(jax_params, npz)
    tv = {}
    for k, v in want.items():
        parts = k.split(".")
        if parts[0].startswith("stage") and parts[-1] in ("weight", "bias"):
            tv[f"features.{parts[1]}.{parts[2]}"] = v
    tv["classifier.0.weight"] = torch.zeros(2, 2)  # ignored, as torchvision's head
    tv_path = str(tmp_path / "vgg16.pth")
    torch.save(tv, tv_path)
    ref_path = str(tmp_path / "model.pth")
    torch.save({f"encoder.dists.{k}": v for k, v in want.items()}, ref_path)
    for path in (npz, tv_path, ref_path):
        sd = tpre.resolve_vgg_params(path).state_dict()
        for k in want:
            torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0, msg=k)


def test_resolve_vgg_params_random_warns_and_is_seeded(capsys, monkeypatch):
    monkeypatch.delenv(tpre.ENV_VGG, raising=False)
    a = tpre.resolve_vgg_params(seed=3)
    assert "RANDOM" in capsys.readouterr().err
    b = tpre.resolve_vgg_params(seed=3)
    w = a.state_dict()["stage1.0.weight"]
    torch.testing.assert_close(w, b.state_dict()["stage1.0.weight"], rtol=0, atol=0)
    # He-normal: std sqrt(2 / fan_in), fan_in = 9 * 3
    assert abs(float(w.std()) - np.sqrt(2 / 27)) < 0.05
    assert not any(p.requires_grad for p in a.parameters())


def test_resolve_dists_weights_from_pt_and_env(tmp_path, monkeypatch):
    raw = jdists.init_random_weights(seed=2)
    pt = str(tmp_path / "weights.pt")
    torch.save({"alpha": torch.from_numpy(np.asarray(raw.alpha)).view(1, -1, 1, 1),
                "beta": torch.from_numpy(np.asarray(raw.beta)).view(1, -1, 1, 1)}, pt)
    monkeypatch.setenv(tpre.ENV_DISTS, pt)
    got = tpre.resolve_dists_weights(TConfig())
    np.testing.assert_array_equal(got.alpha.numpy(), np.asarray(raw.alpha))
    monkeypatch.delenv(tpre.ENV_DISTS)
    bundled = tpre.resolve_dists_weights(TConfig())
    want = jdists.load_pretrained_weights()
    np.testing.assert_array_equal(bundled.beta.numpy(), np.asarray(want.beta))
    w = dists_weights_from_jax(np.asarray(raw.alpha), np.asarray(raw.beta))
    np.testing.assert_array_equal(w.beta.numpy(), np.asarray(raw.beta))


def _record_conv_tf32(monkeypatch):
    seen = []
    real = torch.nn.functional.conv2d

    def spy(*args, **kw):
        seen.append(torch.backends.cudnn.allow_tf32)
        return real(*args, **kw)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    return seen


def test_fp32_path_disables_cudnn_tf32(monkeypatch, np_params):
    model = VGG16Pyramid()
    model.load_state_dict(vgg_state_dict_from_jax(np_params))
    x = torch.rand(1, 16, 16, 3)
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    seen = _record_conv_tf32(monkeypatch)
    model(x, torch.float32)
    assert len(seen) == 17 and not any(seen)  # 13 convs + 4 L2 pools
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before
    seen.clear()
    scorer = FrameScorer(model, tdists.load_pretrained_weights(), TConfig(),
                         resize_to=(16, 16), device="cpu")
    scorer.score_frames(np.zeros((1, 20, 20, 3), np.uint8),
                        np.zeros((1, 20, 20, 3), np.uint8), batch_size=1)
    assert seen and not any(seen)


def test_true_fp32_restores_flags_on_error():
    before = torch.backends.cudnn.allow_tf32
    with pytest.raises(KeyError):
        with true_fp32():
            assert torch.backends.cudnn.allow_tf32 is False
            assert torch.backends.cuda.matmul.allow_tf32 is False
            raise KeyError
    assert torch.backends.cudnn.allow_tf32 == before


def test_port_and_chip_smoke_import_no_jax():
    """A fresh interpreter imports every port module and chip_smoke with
    neither jax nor nerf_qa_tpu landing in sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import nerf_qa_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(nerf_qa_torch.__path__,"
        " 'nerf_qa_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('nerf_qa_tpu')]\n"
        "assert not bad, bad\n"
        "print(*names)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 30
    for mod in ("models.nr.layers", "models.nr.vit", "models.nr.featup",
                "models.nr.decoder", "models.nr.model", "ops.cuda.jbu",
                "ops.cuda.channelnorm", "ops.windowed", "ops.cuda.windowed_tsd",
                "core.adists", "train.nr_train", "train.schedules",
                "tools.train_nr", "tools.make_synthetic_dataset",
                "compat.checkpoint", "data.datasets", "data.samplers",
                "data.pipeline", "data.factories", "logging.metrics",
                "eval.correlations"):
        assert f"nerf_qa_torch.{mod}" in names, mod


def _imported_modules(path: pathlib.Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    return mods


def test_source_scan_no_jax_or_reference_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        text = path.read_text()
        assert "nerf_qa_tpu" not in text.replace("nerf_qa_tpu/", ""), path
        for mod in _imported_modules(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "flax", "optax",
                                             "nerf_qa_tpu"), (path, mod)


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=path)


def test_nr_params_bridge_strict_and_round_trip(jax_nr, np_params):
    """JAX random-init NR params -> from_jax -> the port's modules load
    strict; the same state_dicts fed to the JAX package's importers
    (convert_nr_decoder, convert_featup_jbu, convert_dinov2_vit) give back
    the JAX params, flipped transposed-conv kernels included."""
    from nerf_qa_torch.config import NRModelConfig as TNRConfig
    from nerf_qa_tpu.compat.torch_featup import convert_featup_jbu
    from nerf_qa_tpu.compat.torch_nr import convert_nr_decoder
    from nerf_qa_tpu.compat.torch_vit import convert_dinov2_vit

    model, dec_params = jax_nr
    port = torch_nr_from_jax(model, dec_params, VGG16Pyramid(), nr_config(TNRConfig))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    _assert_trees_equal(convert_nr_decoder(port.decoder.state_dict(), upsample_stages=4),
                        to_np(dec_params))
    _assert_trees_equal(convert_featup_jbu(port.jbu.state_dict()),
                        to_np(model.jbu_params))
    vit_sd = dict(port.vit.state_dict())
    cls_pos = torch.zeros(1, 1, vit_sd["pos_embed"].shape[-1])
    vit_sd["pos_embed"] = torch.cat([cls_pos, vit_sd["pos_embed"]], dim=1)  # DINOv2's
    _assert_trees_equal(convert_dinov2_vit(vit_sd, depth=2, grid_size=NR_SEM // 14),
                        to_np(model.vit_params))


def test_resolve_vit_and_jbu_params_from_torch_files(jax_nr, tmp_path, monkeypatch):
    """A DINOv2-format .pth (CLS position row, a 6x6 grid resampled to 4x4,
    a mask_token, two blocks of three) and a FeatUp .pth (the upsampler
    under 'upsampler.') load as the JAX package's importers read them."""
    from nerf_qa_torch.compat import from_jax
    from nerf_qa_tpu.compat.torch_featup import load_featup_from_torch_file
    from nerf_qa_tpu.compat.torch_vit import load_dinov2_from_torch_file

    model, _ = jax_nr
    rng = np.random.default_rng(12)
    sd = from_jax.vit_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, model.vit_params))
    sd.update({k.replace("blocks.1.", "blocks.2."): v for k, v in sd.items()
               if k.startswith("blocks.1.")})
    sd["pos_embed"] = torch.from_numpy(rng.normal(0, 0.02, (1, 37, 384)).astype(np.float32))
    sd["mask_token"] = torch.zeros(1, 384)
    vit_path = str(tmp_path / "dinov2.pth")
    torch.save(sd, vit_path)
    monkeypatch.setenv(tpre.ENV_VIT, vit_path)
    got = tpre.resolve_vit_params(depth=2, grid_size=4).state_dict()
    want = from_jax.vit_state_dict_from_jax(load_dinov2_from_torch_file(
        vit_path, depth=2, grid_size=4))
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-7, msg=k)

    jbu_sd = from_jax.jbu_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, model.jbu_params))
    jbu_path = str(tmp_path / "featup.pth")
    torch.save({"upsampler." + k: v.reshape(1) if v.dim() == 0 else v
                for k, v in jbu_sd.items()} | {"model.0.weight": torch.zeros(1)},
               jbu_path)
    got = tpre.resolve_jbu_params(jbu_path).state_dict()
    want = from_jax.jbu_state_dict_from_jax(load_featup_from_torch_file(jbu_path))
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_resolve_vit_and_jbu_random_warn_and_are_seeded(capsys, monkeypatch):
    monkeypatch.delenv(tpre.ENV_VIT, raising=False)
    monkeypatch.delenv(tpre.ENV_JBU, raising=False)
    a = tpre.resolve_vit_params(depth=1, seed=3)
    b = tpre.resolve_vit_params(depth=1, seed=3)
    j = tpre.resolve_jbu_params(seed=4)
    assert capsys.readouterr().err.count("RANDOM") == 3
    for k, v in a.state_dict().items():
        torch.testing.assert_close(v, b.state_dict()[k], rtol=0, atol=0, msg=k)
    w = a.state_dict()["blocks.0.attn.qkv.weight"]  # lecun normal, fan_in 384
    assert abs(float(w.std()) - 384**-0.5) < 0.005
    assert float(j.state_dict()["up1.sigma_spatial"]) == 1.0
