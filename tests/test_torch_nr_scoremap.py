"""The score-map objective in the port against the JAX package, on the
CPU, at the small NR size of tests/torch_parity.py (64² / 56², a 2-block
ViT, decoder depths 1 / 2): ``NRModel.losses(score_map=...)`` (the ADISTS
map of the clipped predicted image against the render, in -log10, an L1
against the target) and the decoder gradient against ``jax.grad`` of the
JAX losses, in fp32 and with the bf16 decoder; one ``train_step_score_map``
against the JAX trainer's step; and the score-map dataset's items and
batches against the JAX dataset's.

The JAX loss cannot be differentiated with a bf16 VGG (the CLI's default
``--compute-dtype``): its bf16 L2 pool asks the conv for an fp32 output,
whose transpose rule refuses the bf16 operands under grad
(nerf_qa_tpu/ops/l2pool.py:108; ROADMAP, faults of the JAX package). So
the bf16 decoder's gradient is held with the fp32 VGG, and at the CLI's
precision (bf16 VGG and decoder) the port's losses are held to the JAX
forward and its gradient shown finite. Weights go through compat/from_jax;
inputs come from numpy seeds. The port's ADISTS inside the loss takes the
plain T/S version (the kernel has no backward): its profiler range is
``nr.score_map``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from nerf_qa_torch.compat import from_jax
from nerf_qa_torch.config import DISTSConfig as TDConfig
from nerf_qa_torch.config import NRModelConfig as TConfig
from nerf_qa_torch.config import TrainConfig as TTrainConfig
from nerf_qa_torch.data import datasets as tdatasets
from nerf_qa_torch.data import factories as tfactories
from nerf_qa_torch.models.nr.decoder import NRDecoder
from nerf_qa_torch.models.nr.model import NRModel
from nerf_qa_torch.tools import make_synthetic_dataset as tsynth
from nerf_qa_torch.tools.train_nr import read_rows
from nerf_qa_torch.train import nr_train as ttrain
from nerf_qa_tpu.config import DISTSConfig as JDConfig
from nerf_qa_tpu.config import NRModelConfig as JConfig
from nerf_qa_tpu.config import TrainConfig as JTrainConfig
from nerf_qa_tpu.data import datasets as jdatasets
from nerf_qa_tpu.data import factories as jfactories
from nerf_qa_tpu.models.nr.model import NRModel as JNRModel
from nerf_qa_tpu.train import nr_train as jtrain
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

# the bars of tests/test_torch_nr_train.py: losses 1e-4 fp32 / 5e-3 bf16;
# decoder gradients per tensor 1e-3 of its largest |grad| in fp32; the bf16
# gradient per tensor within 4x JAX's own bf16 rounding on that tensor
# (its bf16 gradient's distance from its fp32 one) plus the fp32 bar, as
# that file holds the bf16 gradient of ``combined``. The score-map term
# makes the bf16 gradient even less well conditioned there: JAX's own bf16
# gradient lies 0.50 of the largest |grad| from its fp32 one (measured),
# so the whole gradient is held no farther from JAX's fp32 gradient than
# JAX's bf16 gradient is (measured: the port's is nearer, per tensor)
LOSS_BAR = {"float32": 1e-4, "bfloat16": 5e-3}
GRAD_BAR = 1e-3
BF16_NOISE_FACTOR = 4.0


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    scale = max(float(want.abs().max()), 1e-12)
    return float((got.detach().float() - want).abs().max()) / scale


@pytest.fixture(scope="module")
def batch():
    """(gt, render, render at 56², a 3-channel score map at 80² whose
    channel 1 is a -log10 map, so the loss resizes it)."""
    rng = np.random.default_rng(0)
    gt = rng.random((2, NR_RENDER, NR_RENDER, 3), dtype=np.float32)
    render = np.clip(gt + rng.normal(0, 0.08, gt.shape).astype(np.float32), 0, 1)
    r224 = rng.random((2, NR_SEM, NR_SEM, 3), dtype=np.float32)
    score_map = rng.random((2, 80, 80, 3), dtype=np.float32)
    score_map[..., 1] = 1.0 + 1.5 * score_map[..., 1]
    return gt, render, r224, score_map


@pytest.fixture(scope="module")
def noisy_params(jax_nr):
    _, dec_params = jax_nr
    rng = np.random.default_rng(3)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.05, np.shape(a))).astype(np.float32),
        dec_params)


def _models(jax_nr, jax_params, torch_model, noisy_params, dtype, vgg_dtype="float32",
            dropout_rate=0.2):
    """The JAX model and the port's with the decoder in ``dtype`` and the
    VGG in ``vgg_dtype``, the decoder from ``noisy_params``."""
    model, _ = jax_nr
    kw = dict(decoder_dtype=dtype, score_map_coeff=0.7, dropout_rate=dropout_rate)
    jcfg = nr_config(JConfig, JDConfig(compute_dtype=vgg_dtype)).replace(**kw)
    tcfg = nr_config(TConfig, TDConfig(compute_dtype=vgg_dtype)).replace(**kw)
    jm = JNRModel(jax_params, model.dists_weights, jcfg, vit_params=model.vit_params,
                  jbu_params=model.jbu_params, vit=model.vit,
                  render_size=NR_RENDER, sem_size=NR_SEM)
    port = torch_nr_from_jax(model, noisy_params, torch_model, tcfg)
    port.decoder = NRDecoder.from_state_dict(
        from_jax.nr_decoder_state_dict_from_jax(_np(noisy_params), qkv_bias=True,
                                                layer_scale=True), tcfg)
    return jm, port


def _grads(decoder):
    return {n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in decoder.named_parameters()}


def _case(jax_nr, jax_params, torch_model, noisy_params, batch, dtype, score_map):
    jm, port = _models(jax_nr, jax_params, torch_model, noisy_params, dtype)
    frozen = jm.frozen_params()

    @jax.jit
    def run(p, f, gt, render, r224, sm):
        def loss_fn(q):
            losses, _ = jm.losses(q, gt, render, r224, score_map=sm, frozen=f)
            return losses["combined"], losses

        (_, losses), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return losses, g

    jl, jg = run(noisy_params, frozen, *(jnp.asarray(a) for a in batch[:3]),
                 jnp.asarray(score_map))
    tl = port.losses(*(torch.from_numpy(a) for a in batch[:3]),
                     score_map=torch.from_numpy(score_map))
    tl["combined"].backward()
    want = from_jax.nr_decoder_tensors_from_jax(_np(jg), port.decoder.state_dict())
    return ({k: float(v) for k, v in jl.items()}, want,
            {k: float(v.detach()) for k, v in tl.items()}, _grads(port.decoder))


@pytest.fixture(scope="module")
def fp32_case(jax_nr, jax_params, torch_model, noisy_params, batch):
    return _case(jax_nr, jax_params, torch_model, noisy_params, batch, "float32", batch[3])


@pytest.fixture(scope="module")
def bf16_case(jax_nr, jax_params, torch_model, noisy_params, batch):
    # the bf16 decoder with the fp32 VGG, and a single-channel (N, H, W)
    # target at the map's own size
    return _case(jax_nr, jax_params, torch_model, noisy_params, batch, "bfloat16",
                 batch[3][..., 1][:, 8:72, 8:72].copy())


CASES = {"float32": "fp32_case", "bfloat16": "bf16_case"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_score_map_losses_match_jax(dtype, request):
    want, _, got, _ = request.getfixturevalue(CASES[dtype])
    assert set(got) == set(want) == {"l1", "dists_pref2ref", "score_map_l1", "combined"}
    gaps = {k: abs(got[k] - want[k]) for k in want}
    print(f"{dtype} loss gaps port vs JAX: {gaps}")
    assert all(np.isfinite(v) for v in got.values())
    assert got["score_map_l1"] > 0.1  # the map term is not vanishing
    assert max(gaps.values()) <= LOSS_BAR[dtype]


def test_score_map_gradient_matches_jax_fp32(fp32_case):
    _, want, _, got = fp32_case
    assert set(got) == set(want)
    gaps = {k: _rel_gap(got[k], want[k]) for k in want}
    worst = max(gaps, key=gaps.get)
    print(f"fp32 worst gradient gap: {worst} {gaps[worst]:.3e}")
    assert all(torch.isfinite(g).all() for g in got.values())
    assert gaps[worst] <= GRAD_BAR


def test_score_map_gradient_matches_jax_bf16(bf16_case, fp32_case):
    _, want, _, got = bf16_case
    want32 = fp32_case[1]
    assert set(got) == set(want) == set(want32)
    assert all(torch.isfinite(g).all() for g in got.values())
    ratios = {}
    for k in want:
        noise = float((want[k] - want32[k]).abs().max())
        gap = float((got[k].float() - want[k]).abs().max())
        ratios[k] = gap / max(noise, 1e-30)
        assert gap <= BF16_NOISE_FACTOR * noise + GRAD_BAR * float(want32[k].abs().max()), k
    worst = max(ratios, key=ratios.get)
    scale = max(float(w.abs().max()) for w in want32.values())
    port_off = max(float((got[k].float() - want32[k]).abs().max()) for k in want) / scale
    jax_off = max(float((want[k] - want32[k]).abs().max()) for k in want) / scale
    print(f"bf16: worst gap over JAX's bf16 rounding {worst} {ratios[worst]:.2f}x; "
          f"from the fp32 gradient: port {port_off:.3f}, JAX {jax_off:.3f}")
    assert port_off <= jax_off


def test_score_map_at_the_cli_precision(jax_nr, jax_params, torch_model, noisy_params,
                                        batch):
    # bf16 VGG and decoder: the losses against the JAX forward (no grad,
    # which the JAX package cannot take here), 5e-3; a finite gradient
    jm, port = _models(jax_nr, jax_params, torch_model, noisy_params, "bfloat16",
                       vgg_dtype="bfloat16")
    jl, _ = jax.jit(lambda p, f, *a: jm.losses(p, *a[:3], score_map=a[3], frozen=f))(
        noisy_params, jm.frozen_params(), *(jnp.asarray(a) for a in batch))
    tl = port.losses(*(torch.from_numpy(a) for a in batch[:3]),
                     score_map=torch.from_numpy(batch[3]))
    tl["combined"].backward()
    assert set(tl) == set(jl)
    for k in jl:
        assert abs(float(tl[k]) - float(jl[k])) <= LOSS_BAR["bfloat16"], k
    grads = _grads(port.decoder)
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert max(float(g.abs().max()) for g in grads.values()) > 0


def test_score_map_term_moves_the_gradient(fp32_case, jax_nr, jax_params, torch_model,
                                           noisy_params, batch):
    # without the map the decoder gradient differs: the ADISTS term
    # reaches the decoder through the predicted image
    _, _, _, with_map = fp32_case
    _, port = _models(jax_nr, jax_params, torch_model, noisy_params, "float32")
    port.losses(*(torch.from_numpy(a) for a in batch[:3]))["combined"].backward()
    without = _grads(port.decoder)
    assert any(not torch.allclose(with_map[k], without[k]) for k in without)


def test_train_step_score_map_matches_jax(jax_nr, jax_params, torch_model, noisy_params,
                                          batch, fp32_case):
    # one Adam step (lr 1e-3, dropout rate 0) of each trainer from the same
    # decoder: the same losses (1e-4), and the same update wherever the
    # gradient is resolved. Adam's first step moves each weight by
    # lr·g/(|g| + eps), within lr·eps/|g| of ±lr; so where |g| is at least
    # 1e-3 of its tensor's largest (the fp32 gradient bar; fp32_case's JAX
    # gradient of the same deterministic loss) the two updates agree to
    # 1e-3·lr + 2·lr·eps/|g|. Elsewhere the sign of a gradient within the
    # bar of zero may differ (|Δ| ≤ 2·lr)
    lr = 1e-3
    jm, port = _models(jax_nr, jax_params, torch_model, noisy_params, "float32",
                       dropout_rate=0.0)
    jt = jtrain.NRTrainer(jm, JTrainConfig(lr=lr, schedule="constant", batch_size=2),
                          steps_per_epoch=1)
    opt_state = jt.optimizer.init(noisy_params)
    p1, _, _, jl, _ = jt.train_step_score_map(noisy_params, {}, opt_state, *batch[:3],
                                              batch[3], jax.random.PRNGKey(0))
    trainer = ttrain.NRTrainer(port, TTrainConfig(lr=lr, schedule="constant",
                                                  batch_size=2),
                               steps_per_epoch=1, device="cpu")
    before = {k: v.clone() for k, v in port.decoder.state_dict().items()}
    trainer.set_decoder(port.decoder)
    tl = trainer.train_step_score_map(*batch)
    assert set(tl) == set(jl)
    for k in jl:
        assert abs(float(tl[k]) - float(jl[k])) <= 1e-4, k
    want = from_jax.nr_decoder_tensors_from_jax(_np(p1), before)
    after = trainer.model.decoder.state_dict()
    grads = fp32_case[1]
    resolved = total = 0
    for k, w in want.items():
        got_step, want_step = after[k] - before[k], w - before[k]
        mask = grads[k].abs() >= GRAD_BAR * float(grads[k].abs().max())
        if float(grads[k].abs().max()) == 0.0:  # the unused last resample
            assert float(want_step.abs().max()) == float(got_step.abs().max()) == 0.0
            continue
        resolved += int(mask.sum())
        total += mask.numel()
        bar = 1e-3 * lr + 2 * lr * 1e-8 / grads[k].abs().clamp_min(1e-30)
        assert bool(((got_step - want_step).abs() <= bar)[mask].all()), k
        assert float((got_step - want_step).abs().max()) <= 2 * lr * (1 + 1e-6), k
    print(f"resolved gradient elements: {resolved}/{total}")
    assert resolved >= 0.5 * total  # measured 70.6 %


# -- the score-map dataset -----------------------------------------------------

RENDER, SEM = 32, 28


@pytest.fixture(scope="module")
def sm_tree(tmp_path_factory):
    """A synthetic NR tree with score-map PNGs (L mode, as prep_nr writes
    them) and their log-range columns written by hand."""
    root = str(tmp_path_factory.mktemp("nr_sm"))
    path = tsynth.make_nr_tree(root, scenes=("chair", "drums"), methods=("nerfacto",),
                               frames=3, hw=(40, 56))
    rows = read_rows(path)
    rng = np.random.default_rng(9)
    for row in rows:
        out = f"{root}/{row['render_dir'].rsplit('/', 1)[0]}/score-map"
        os.makedirs(out)
        for name in tdatasets.parse_list_column(row["basenames"]):
            Image.fromarray((rng.random((64, 64)) * 255).astype(np.uint8), "L").save(
                f"{out}/{name}")
        row["score_map_log_min"] = str([round(float(v), 6) for v in 1 + rng.random(3)])
        row["score_map_log_max"] = str([round(float(v), 6) for v in 2.5 + rng.random(3)])
    pd.DataFrame(rows).to_csv(path, index=False)
    return root, path


@pytest.mark.parametrize("is_train", [False, True])
def test_score_map_dataset_matches_jax(sm_tree, is_train):
    root, path = sm_tree
    kw = dict(mode="score-map", is_train=is_train, render_size=RENDER, sem_size=SEM)
    t = tdatasets.NerfNRQADataset(read_rows(path), root, rng=np.random.default_rng(2), **kw)
    j = jdatasets.NerfNRQADataset(pd.read_csv(path), root, rng=np.random.default_rng(2), **kw)
    for idx in (0, 4, 1, 5, 0):
        got, want = t[idx], j[idx]
        assert len(got) == 5 and got[2].shape == (64, 64, 3)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1]["256x256"], want[1]["256x256"])
        np.testing.assert_array_equal(got[1]["224x224"], want[1]["224x224"])
        np.testing.assert_array_equal(got[2], want[2])
        assert got[3:] == want[3:]


def test_score_map_loader_matches_jax(sm_tree):
    # the 5-tuple batches through the port's collation and sampler order
    root, path = sm_tree
    kw = dict(mode="score-map", is_train=True, batch_size=2, seed=3,
              render_size=RENDER, sem_size=SEM)
    got = list(tfactories.create_nr_dataloader(read_rows(path), root, num_workers=0, **kw))
    want = list(jfactories.create_nr_dataloader(pd.read_csv(path), root, num_workers=0,
                                                **kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert len(g) == len(w) == 5
        np.testing.assert_array_equal(g[0], np.asarray(w[0]))
        np.testing.assert_array_equal(g[1]["256x256"], np.asarray(w[1]["256x256"]))
        np.testing.assert_array_equal(g[2], np.asarray(w[2]))
        np.testing.assert_array_equal(g[3], np.asarray(w[3]))
        np.testing.assert_array_equal(g[4], np.asarray(w[4]))

