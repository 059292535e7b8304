"""Shared cases of the NR generation tests (tests/test_torch_nr_versions_*.py):
one JAX NRModel of a version at a small size (64² / 56², a 1-block ViT,
decoder depths 1 / 1, dropout rate 0, batch 2), its params and BatchNorm
state perturbed by seeded noise, and the port's model with the same
weights and running averages (compat/from_jax). ``run_case`` computes,
on both sides, the eval-mode forward (``forward_normalized``) and one
training-mode step's losses, decoder gradient and BatchNorm running
averages after it (the JAX ``new_state``; the port's ``NRTrainer``)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from nerf_qa_torch.compat import from_jax
from nerf_qa_torch.config import NRModelConfig as TConfig
from nerf_qa_torch.config import TrainConfig as TTrainConfig
from nerf_qa_torch.models.nr.decoder import NRDecoder
from nerf_qa_torch.models.nr.featup import JBUStack
from nerf_qa_torch.models.nr.model import NRModel
from nerf_qa_torch.models.nr.vit import ViTS14
from nerf_qa_torch.train.nr_train import NRTrainer
from nerf_qa_tpu.config import NRModelConfig as JConfig
from nerf_qa_tpu.models.nr.model import NRModel as JNRModel
from nerf_qa_tpu.models.nr.vit import ViTS14 as JViT

R, S = 64, 56
STD, MEAN = np.array([0.05, 0.06], np.float32), np.array([0.3, 0.35], np.float32)
# fp32 bars, the port's NR parity bars (tests/test_torch_nr_train.py):
# scores and losses 1e-4; decoder gradients per tensor 1e-3 of its largest
# |grad|; the running averages after a step 1e-5 of their largest value
# (one fp32 step from the same start, sums in another order). A tensor
# whose gradient is below RESOLVED of the decoder's largest |grad| is not
# resolved per tensor (a conv bias in front of a BatchNorm on batch
# statistics, whose true gradient is zero: the normalisation removes any
# per-channel shift; or everything behind a training-mode BatchNorm whose
# upstream gradient is constant over the batch, v4's head on some
# batches): both sides give rounding noise there, held to NULL_GRAD_BAR of
# the decoder's largest |grad| (measured: a v6 head BatchNorm weight at
# 0.7 % of the largest |grad| differs by 1.03e-3 of its own largest, 7e-6
# of the decoder's; the null gradient of the v6 head's last conv bias, a
# sum over 131,072 pixels, by 2.8e-5 of the decoder's)
SCORE_ATOL = 1e-4
GRAD_BAR = 1e-3
RESOLVED = 1e-2
NULL_GRAD_BAR = 1e-4
STATS_RTOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def batch():
    rng = np.random.default_rng(0)
    gt = rng.random((2, R, R, 3), dtype=np.float32)
    render = np.clip(gt + rng.normal(0, 0.08, gt.shape).astype(np.float32), 0, 1)
    r224 = rng.random((2, S, S, 3), dtype=np.float32)
    return gt, render, r224


def make_case(jax_params, torch_model, version: int, **cfg):
    """(JAX model, params, state, the port's model) for ``version``; params
    (by N(0, 0.01)) and running averages moved off their init by seeded
    noise (the means by
    N(0, 0.01), the variances scaled by U(0.9, 1.1): far enough to show a
    mapping fault, near enough that eval-mode heads stay in range)."""
    kw = dict(version=version, transformer_decoder_depth=1, refine_up_depth=1,
              dropout_rate=0.0, **cfg)
    jm = JNRModel(jax_params, cfg=JConfig(**kw), vit=JViT(depth=1), render_size=R,
                  sem_size=S)
    params, state = jax.jit(jm.init, static_argnums=0)(0)
    rng = np.random.default_rng(version)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.01, np.shape(a))).astype(np.float32),
        params)
    if state:
        state = {"batch_stats": _perturb_stats(_np(state["batch_stats"]), rng)}
    tcfg = TConfig(**kw)
    sd = from_jax.nr_decoder_state_dict_from_jax(
        _np(params), qkv_bias=True, layer_scale=True,
        batch_stats=state.get("batch_stats") if state else None, version=version)
    vit = ViTS14(depth=1, grid_size=S // 14)
    vit.load_state_dict(from_jax.vit_state_dict_from_jax(_np(jm.vit_params)))
    jbu = None
    if version >= 7:
        jbu = JBUStack(vit.embed_dim)
        jbu.load_state_dict(from_jax.jbu_state_dict_from_jax(_np(jm.jbu_params)))
    w = jm.dists_weights
    port = NRModel(torch_model, from_jax.dists_weights_from_jax(np.asarray(w.alpha),
                                                                np.asarray(w.beta)),
                   tcfg, vit=vit, jbu=jbu, decoder=NRDecoder.from_state_dict(sd, tcfg),
                   render_size=R, sem_size=S)
    return jm, params, state, port


def _perturb_stats(tree, rng):
    if set(tree) == {"mean", "var"}:
        m, v = np.asarray(tree["mean"]), np.asarray(tree["var"])
        return {"mean": (m + rng.normal(0, 0.01, m.shape)).astype(np.float32),
                "var": (v * rng.uniform(0.9, 1.1, v.shape)).astype(np.float32)}
    return {k: _perturb_stats(v, rng) for k, v in tree.items()}


def run_case(jm, params, state, port, data):
    """Both sides' (scores, normalized scores) in eval mode, and one
    training step's (losses, decoder gradient in the port's keys, the
    decoder's running averages after it)."""
    gt, render, r224 = (jnp.asarray(a) for a in data)
    frozen = jm.frozen_params()

    @jax.jit
    def jax_run(p, s, f):
        fwd = jm.forward_normalized(p, render, r224, state=s, frozen=f)

        def loss_fn(q):
            losses, new_state = jm.losses(q, gt, render, r224, rng=jax.random.PRNGKey(1),
                                          score_std=jnp.asarray(STD),
                                          score_mean=jnp.asarray(MEAN), state=s, frozen=f)
            return losses["combined"], (losses, new_state)

        (_, (losses, new_state)), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return fwd, losses, g, new_state

    fwd, jl, jg, new_state = jax_run(params, state, frozen)
    want = {
        "forward": tuple(np.asarray(a) for a in fwd),
        "losses": {k: float(v) for k, v in jl.items()},
        "grads": from_jax.nr_decoder_tensors_from_jax(
            _np(jg), port.decoder.state_dict(), jm.cfg.version),
        "state": (from_jax.nr_decoder_state_dict_from_jax(
            _np(params), qkv_bias=True, layer_scale=True,
            batch_stats=_np(new_state["batch_stats"]), version=jm.cfg.version)
            if new_state else {}),
    }
    with torch.no_grad():
        fwd_t = port.forward_normalized(*(torch.from_numpy(a) for a in data[1:]))
    trainer = NRTrainer(port, TTrainConfig(lr=1e-3, schedule="constant", batch_size=2),
                        steps_per_epoch=1, device="cpu")
    trainer.set_decoder(port.decoder)
    grads = {}

    def keep(opt, args, kwargs):
        for n, p in port.decoder.named_parameters():
            grads[n] = torch.zeros_like(p) if p.grad is None else p.grad.clone()

    handle = trainer.optimizer.register_step_pre_hook(keep)
    losses = trainer.train_step(*data, STD, MEAN)
    handle.remove()
    got = {"forward": tuple(a.numpy() for a in fwd_t),
           "losses": {k: float(v) for k, v in losses.items()},
           "grads": grads,
           "state": {k: v for k, v in port.decoder.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))}}
    return got, want


def check_case(got, want):
    """Hold the port's case to the JAX one at the module's bars."""
    for a, b in zip(got["forward"], want["forward"]):
        assert a.shape == b.shape and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=SCORE_ATOL)
    assert set(got["losses"]) == set(want["losses"])
    for k, v in want["losses"].items():
        assert abs(got["losses"][k] - v) <= SCORE_ATOL, (k, got["losses"][k], v)
    assert set(got["grads"]) == set(want["grads"])
    worst = 0.0
    top = max(float(w.abs().max()) for w in want["grads"].values())
    for k, w in want["grads"].items():
        gap = float((got["grads"][k] - w).abs().max())
        if float(w.abs().max()) < RESOLVED * top:
            assert gap <= NULL_GRAD_BAR * top, (k, gap / top)
            continue
        gap /= max(float(w.abs().max()), 1e-12)
        assert gap <= GRAD_BAR, (k, gap, float(w.abs().max()), top)
        worst = max(worst, gap)
    stats = {k: v for k, v in want["state"].items()
             if k.endswith(("running_mean", "running_var"))}
    assert set(got["state"]) == set(stats)
    for k, w in stats.items():
        scale = max(float(w.abs().max()), 1e-12)
        assert float((got["state"][k] - w).abs().max()) <= STATS_RTOL * scale, k
    return worst
