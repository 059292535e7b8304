"""Activation checkpointing of the v7/v8 RefineUp stages (``cfg.remat``,
the JAX package's ``nn.remat(RefineUp)``) in the port, on the CPU, at the
small NR size of tests/torch_parity.py: a remat training step equals a
plain one bit for bit (losses, decoder gradients, the updated decoder and
the dropout generator's state after it), with dropout on, in fp32 and
bf16; the recomputation draws the masks the forward drew; and the remat
losses and decoder gradient match JAX's ``remat=True`` at the fp32 bars of
tests/test_torch_nr_train.py (losses 1e-4, gradients 1e-3 of each
tensor's largest)."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_qa_torch.compat import from_jax
from nerf_qa_torch.config import DISTSConfig as TDConfig
from nerf_qa_torch.config import NRModelConfig as TConfig
from nerf_qa_torch.config import TrainConfig as TTrainConfig
from nerf_qa_torch.models.nr import layers as tlayers
from nerf_qa_torch.models.nr.decoder import NRDecoder
from nerf_qa_torch.train.nr_train import NRTrainer
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
def batch():
    rng = np.random.default_rng(0)
    gt = rng.random((2, NR_RENDER, NR_RENDER, 3), dtype=np.float32)
    render = np.clip(gt + rng.normal(0, 0.08, gt.shape).astype(np.float32), 0, 1)
    r224 = rng.random((2, NR_SEM, NR_SEM, 3), dtype=np.float32)
    return gt, render, r224


@pytest.fixture(scope="module")
def base(jax_nr, torch_model):
    model, dec_params = jax_nr
    return torch_nr_from_jax(model, dec_params, torch_model, nr_config(TConfig))


def _trainer(base, remat: bool, dtype: str) -> NRTrainer:
    """A trainer over a copy of ``base`` with dropout 0.2 and the decoder
    at ``dtype``, its decoder the same for either ``remat``."""
    cfg = nr_config(TConfig, TDConfig(compute_dtype=dtype)).replace(
        decoder_dtype=dtype, remat=remat, dropout_rate=0.2)
    model = copy.deepcopy(base)
    model.cfg = cfg
    model.decoder = NRDecoder.from_state_dict(base.decoder.state_dict(), cfg)
    trainer = NRTrainer(model, TTrainConfig(lr=1e-3, schedule="constant"),
                        steps_per_epoch=1, device="cpu")
    trainer.set_decoder(model.decoder)
    return trainer


def _step(trainer, batch):
    """One training step, the gradients read before Adam's update."""
    grads = {}

    def keep(opt, args, kwargs):
        for n, p in trainer.model.decoder.named_parameters():
            grads[n] = None if p.grad is None else p.grad.clone()

    handle = trainer.optimizer.register_step_pre_hook(keep)
    try:
        losses = trainer.train_step(*batch)
    finally:
        handle.remove()
    return losses, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_step_equals_plain_step_bit_for_bit(base, batch, dtype):
    out = {}
    for remat in (False, True):
        trainer = _trainer(base, remat, dtype)
        assert trainer.model.decoder.cfg.remat is remat
        losses, grads = _step(trainer, batch)
        out[remat] = (losses, grads, trainer.model.decoder.state_dict(),
                      trainer.generator.get_state())
    (lp, gp, sp, rp), (lr_, gr, sr, rr) = out[False], out[True]
    assert set(lp) == set(lr_)
    for k in lp:
        assert torch.equal(lp[k], lr_[k]), k
    assert gp.keys() == gr.keys()
    for k in gp:
        if gp[k] is None:  # the unused last resample
            assert gr[k] is None, k
        else:
            assert torch.equal(gp[k], gr[k]), k
    for k in sp:
        assert torch.equal(sp[k], sr[k]), k
    assert torch.equal(rp, rr)  # the generator stands where a plain step leaves it


def test_remat_recompute_draws_the_forward_masks(base, batch, monkeypatch):
    # every Dropout2d mask of the remat step, in draw order: the forward's
    # 17 stage layers (trans2sem's is outside the checkpoints), then the
    # backward's recomputation of each stage, which repeats its masks
    masks = []
    real = tlayers.Dropout2d.forward

    def record(self, x, generator=None):
        y = real(self, x, generator)
        if generator is not None and self.training and self.rate:
            masks.append((y != 0).flatten(2).any(-1).clone())
        return y

    monkeypatch.setattr(tlayers.Dropout2d, "forward", record)
    trainer = _trainer(base, True, "float32")
    _step(trainer, batch)
    n_stage = 5 * 3 + 2  # depth-2 blocks and resamples, the last not resampled
    assert len(masks) == 1 + 2 * n_stage
    fwd, rec = masks[1:1 + n_stage], masks[1 + n_stage:]
    # the backward recomputes the stages last to first
    per_stage = [3] * 5 + [2]
    starts = np.cumsum([0] + per_stage)
    rec_starts = np.cumsum([0] + per_stage[::-1])
    for i in range(6):
        want = fwd[starts[i]:starts[i + 1]]
        j = 5 - i
        got = rec[rec_starts[j]:rec_starts[j + 1]]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert any(not m.all() for m in fwd)  # some channels dropped


def test_remat_off_the_grad_path_is_the_plain_forward(base, batch):
    # under no_grad (scoring) nothing is checkpointed: equal scores
    r256, r224 = (torch.from_numpy(a) for a in batch[1:])
    scores = []
    for remat in (False, True):
        model = _trainer(base, remat, "float32").model.eval()
        with torch.no_grad():
            scores.append(model(r256, r224))
    assert torch.equal(*scores)


def test_remat_is_for_the_refineup_generations():
    with pytest.raises(ValueError, match="remat"):
        NRDecoder(TConfig(version=6, remat=True))


def test_remat_matches_jax(jax_nr, jax_params, base, batch):
    # the deterministic fp32 losses and decoder gradient of JAX's
    # remat=True model and the port's
    model, dec_params = jax_nr
    jm = JNRModel(jax_params, model.dists_weights, nr_config(JConfig).replace(remat=True),
                  vit_params=model.vit_params, jbu_params=model.jbu_params, vit=model.vit,
                  render_size=NR_RENDER, sem_size=NR_SEM)

    @jax.jit
    def run(p, f, gt, render, r224):
        def loss_fn(q):
            losses, _ = jm.losses(q, gt, render, r224, frozen=f)
            return losses["combined"], losses

        (_, losses), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return losses, g

    jl, jg = run(dec_params, jm.frozen_params(), *(jnp.asarray(a) for a in batch))
    port = _trainer(base, True, "float32").model
    port.decoder.train()
    with port.train_precision():
        tl = port.losses(*(torch.from_numpy(a) for a in batch))
        tl["combined"].backward()
    assert set(tl) == set(jl)
    for k in jl:
        assert abs(float(tl[k]) - float(jl[k])) <= 1e-4, k
    want = from_jax.nr_decoder_tensors_from_jax(_np(jg), port.decoder.state_dict())
    for n, p in port.decoder.named_parameters():
        w = want[n]
        g = torch.zeros_like(p) if p.grad is None else p.grad
        scale = max(float(w.abs().max()), 1e-12)
        assert float((g - w).abs().max()) / scale <= 1e-3, n
