"""NR v8 training in the port against the JAX package, on the CPU, at the
small size of tests/torch_parity.py (64² / 56², a 2-block ViT, decoder
depths 1 / 2): the ChannelNorm backward's plain version, the losses, the
decoder gradients, dropout and a few training steps. Inputs come from
numpy seeds; weights go through compat/from_jax. The JAX side runs under
jax.jit, as its own tests run it. The backward kernel itself is held to
the plain version on the card (tests/test_torch_kernels.py,
chip_smoke.py)."""
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
from nerf_qa_torch.models.nr.model import NRModel
from nerf_qa_torch.ops.cuda import channelnorm as tcn
from nerf_qa_torch.train import nr_train as ttrain
from nerf_qa_tpu.config import DISTSConfig as JDConfig
from nerf_qa_tpu.config import NRModelConfig as JConfig
from nerf_qa_tpu.models.nr import layers as jlayers
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


def _rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| over max(1e-12, max |want|)."""
    want = torch.as_tensor(np.array(want, np.float32))
    scale = max(float(want.abs().max()), 1e-12)
    return float((got.detach().float() - want).abs().max()) / scale


# -- ChannelNorm backward ----------------------------------------------------

# row counts that are a multiple of no tile (the kernel's 8-row blocks, the
# TPU kernel's 256-row tiles), at the decoder's odd widths and a small one
CN_BWD_CASES = [(37, 387), (129, 448), (300, 64)]


def _cn_case(rows, c, seed):
    rng = np.random.default_rng(seed)
    x = (1.5 * rng.standard_normal((rows, c)) + 0.3).astype(np.float32)
    g = rng.standard_normal((rows, c)).astype(np.float32)
    scale = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(c)).astype(np.float32)
    return x, g, scale, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("rows,c", CN_BWD_CASES)
def test_channelnorm_bwd_plain_matches_autograd(rows, c, gelu, dtype):
    # the written-out formulas against autograd of the plain forward on the
    # same inputs. fp32: 1e-5 of each output's largest value (sums in other
    # orders); bf16 input: dx may round the other way once (one bf16 ulp,
    # 2**-7 of the largest value), dscale / dbias are fp32 sums of the same
    # bf16 values (1e-5)
    x, g, s, b = _cn_case(rows, c, c)
    x, g = torch.from_numpy(x).to(dtype), torch.from_numpy(g).to(dtype)
    s, b = torch.from_numpy(s), torch.from_numpy(b)
    xr, sr, br = (t.clone().requires_grad_(True) for t in (x, s, b))
    tcn.channel_norm_act_plain(xr, sr, br, gelu=gelu).backward(g)
    dx, ds, db = tcn.channel_norm_act_bwd_plain(x, g, s, b, gelu=gelu)
    assert dx.dtype == dtype and ds.dtype == db.dtype == torch.float32
    dx_bar = 1e-5 if dtype == torch.float32 else 2**-7
    assert _rel_gap(dx, xr.grad.float()) <= dx_bar
    assert _rel_gap(ds, sr.grad) <= 1e-5
    assert _rel_gap(db, br.grad) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("rows,c", CN_BWD_CASES)
def test_channelnorm_bwd_plain_matches_jax_grad(rows, c, gelu, dtype):
    # against jax.vjp of the JAX ChannelNorm module (the erf GELU of
    # layers.py:84-101) with the same cotangent; bars as above
    x, g, s, b = _cn_case(rows, c, c + 1)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    mod = jlayers.ChannelNorm(c)

    @jax.jit
    def vjp(params, xx, gg):
        _, back = jax.vjp(lambda p, v: mod.apply({"params": p}, v, gelu=gelu),
                          params, xx)
        return back(gg)

    dparams, want_dx = vjp({"scale": s, "bias": b}, jnp.asarray(x, jdt),
                           jnp.asarray(g, jdt))
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    dx, ds, db = tcn.channel_norm_act_bwd_plain(
        torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt),
        torch.from_numpy(s), torch.from_numpy(b), gelu=gelu)
    dx_bar = 1e-5 if dtype == "float32" else 2**-7
    assert _rel_gap(dx, np.asarray(want_dx, np.float32)) <= dx_bar
    assert _rel_gap(ds, dparams["scale"]) <= 1e-5
    assert _rel_gap(db, dparams["bias"]) <= 1e-5


def test_channelnorm_module_grad_on_the_cpu_takes_the_plain_version():
    # CPU tensors under grad: the module's fused and plain settings are the
    # same autograd graph of the plain version, so the grads are equal
    x, g, s, b = _cn_case(2 * 5 * 7, 387, 9)
    grads = []
    for fused in (True, False):
        cn = tlayers.ChannelNorm(387)
        cn.fused = fused
        with torch.no_grad():
            cn.norm.weight.copy_(torch.from_numpy(s))
            cn.norm.bias.copy_(torch.from_numpy(b))
        xin = tlayers.nchw(torch.from_numpy(x).reshape(2, 5, 7, 387)).requires_grad_(True)
        cn(xin, gelu=True).backward(tlayers.nchw(torch.from_numpy(g).reshape(2, 5, 7, 387)))
        grads.append((xin.grad, cn.norm.weight.grad, cn.norm.bias.grad))
    for a, b_ in zip(*grads):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)


# -- losses and decoder gradients against JAX ---------------------------------

@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    gt = rng.random((1, NR_RENDER, NR_RENDER, 3), dtype=np.float32)
    render = np.clip(gt + rng.normal(0, 0.08, gt.shape).astype(np.float32), 0, 1)
    r224 = rng.random((1, NR_SEM, NR_SEM, 3), dtype=np.float32)
    return gt, render, r224


@pytest.fixture(scope="module")
def noisy_params(jax_nr):
    """The JAX decoder's params plus seeded noise (qkv bias and LayerScale
    included), so no parameter sits at a special value."""
    _, dec_params = jax_nr
    rng = np.random.default_rng(3)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.05, np.shape(a))).astype(np.float32),
        dec_params)


@pytest.fixture(scope="module")
def port_base(jax_nr, torch_model):
    model, dec_params = jax_nr
    return torch_nr_from_jax(model, dec_params, torch_model, nr_config(TConfig))


def _configs(dtype: str):
    """(JAX, port) configs: fp32 everywhere, or the CLI default bf16 VGG
    and bf16 decoder."""
    j = nr_config(JConfig, JDConfig(compute_dtype=dtype)).replace(decoder_dtype=dtype)
    t = nr_config(TConfig, TDConfig(compute_dtype=dtype)).replace(decoder_dtype=dtype)
    return j, t


def _both_models(jax_nr, jax_params, port_base, noisy_params, dtype):
    """The JAX model and the port's at ``dtype``, the decoder from
    ``noisy_params`` built with qkv bias and LayerScale, as the trainers
    build it."""
    model, _ = jax_nr
    jcfg, tcfg = _configs(dtype)
    jm = JNRModel(jax_params, model.dists_weights, jcfg, vit_params=model.vit_params,
                  jbu_params=model.jbu_params, vit=model.vit,
                  render_size=NR_RENDER, sem_size=NR_SEM)
    sd = from_jax.nr_decoder_state_dict_from_jax(_np(noisy_params), qkv_bias=True,
                                                 layer_scale=True)
    port = NRModel(port_base.vgg, port_base.dists_weights, tcfg, vit=port_base.vit,
                   jbu=port_base.jbu, decoder=NRDecoder.from_state_dict(sd, tcfg),
                   render_size=NR_RENDER, sem_size=NR_SEM)
    return jm, port


def _grads(decoder) -> dict[str, torch.Tensor]:
    # the last stage's resample layer feeds nothing (its map is the
    # cascade's unused output): no grad in torch, zeros in JAX
    return {n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in decoder.named_parameters()}


@pytest.fixture(scope="module")
def fp32_case(jax_nr, jax_params, port_base, noisy_params, batch):
    """The deterministic fp32 losses and the decoder gradient of
    ``combined`` on both sides: (JAX losses, JAX grads in the port's
    keys, port losses, port grads)."""
    jm, port = _both_models(jax_nr, jax_params, port_base, noisy_params, "float32")
    gt, render, r224 = (jnp.asarray(a) for a in batch)

    def loss_fn(p):
        losses, _ = jm.losses(p, gt, render, r224)  # rng=None: no dropout
        return losses["combined"], losses

    (_, jl), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(noisy_params)
    tl = port.losses(*(torch.from_numpy(a) for a in batch))
    tl["combined"].backward()
    want = from_jax.nr_decoder_tensors_from_jax(_np(jg), port.decoder.state_dict())
    return ({k: float(v) for k, v in jl.items()}, want,
            {k: float(v.detach()) for k, v in tl.items()}, _grads(port.decoder))


@pytest.fixture(scope="module")
def bf16_case(jax_nr, jax_params, port_base, noisy_params, batch):
    """The CLI default precision (bf16 VGG, bf16 decoder) on both sides:
    the deterministic losses, the decoder gradient of a fixed linear
    functional sum(r * pred) of its predictions from the same encoder
    features, and the decoder gradient of ``combined``: (JAX losses, JAX
    functional grads in the port's keys, port losses, port functional
    grads, JAX ``combined`` grads, port ``combined`` grads)."""
    jm, port = _both_models(jax_nr, jax_params, port_base, noisy_params, "bfloat16")
    gt, render, r224 = (jnp.asarray(a) for a in batch)
    rng = np.random.default_rng(11)
    rs = [rng.standard_normal(f.shape).astype(np.float32)
          for f in jax.eval_shape(jm.encode, render, r224).dists_feats]

    def loss_fn(p):
        losses, _ = jm.losses(p, gt, render, r224)  # rng=None: no dropout
        return losses["combined"], losses

    @jax.jit
    def run(p):
        (_, losses), comb = jax.value_and_grad(loss_fn, has_aux=True)(p)
        feats = jm.encode(render, r224)

        def lin(q):
            pred, _ = jm.decoder.apply({"params": q}, feats.dists_feats, feats.sem_feats,
                                       feats.sem_pyramid, True, None)
            return sum(jnp.sum(a.astype(jnp.float32) * r) for a, r in zip(pred, rs))

        return losses, feats, jax.grad(lin)(p), comb

    jl, feats, jg, jcomb = run(noisy_params)
    tl = port.losses(*(torch.from_numpy(a) for a in batch))
    tl["combined"].backward()
    got_comb = {k: v.clone() for k, v in _grads(port.decoder).items()}
    port.decoder.zero_grad(set_to_none=True)
    to_t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    pred, _ = port.decoder([to_t(f) for f in feats.dists_feats], to_t(feats.sem_feats),
                           [to_t(f) for f in feats.sem_pyramid])
    assert all(p.dtype == torch.bfloat16 for p in pred)
    sum((a.float() * torch.from_numpy(r)).sum() for a, r in zip(pred, rs)).backward()
    like = port.decoder.state_dict()
    return ({k: float(v) for k, v in jl.items()},
            from_jax.nr_decoder_tensors_from_jax(_np(jg), like),
            {k: float(v.detach()) for k, v in tl.items()}, _grads(port.decoder),
            from_jax.nr_decoder_tensors_from_jax(_np(jcomb), like), got_comb)


# losses: the port's fp32 parity bar, and bf16 rounding at other places
LOSS_BAR = {"float32": 1e-4, "bfloat16": 5e-3}
# decoder gradients, per tensor, relative to its largest |grad|. fp32, of
# ``combined``: sums and the erf GELU's derivative in other orders
# (measured 1.2e-4). bf16, of the linear functional: the two frameworks
# round the bf16 convolutions, their cotangents and the conv-bias sums at
# other places (measured 4.5e-2, on a conv bias).
GRAD_BAR = {"float32": 1e-3, "bfloat16": 2e-1}
# The bf16 gradient of ``combined`` is held as a whole, relative to the
# largest |grad| over all tensors: at this size its DISTS statistics (4x4
# and 8x8 maps) make it ill-conditioned per tensor (a conv bias's
# gradient is a small sum of large cancelling terms behind each
# ChannelNorm), and the JAX package's own bf16 and fp32 gradients differ
# by up to 54 % of a conv bias's largest value. Measured 0.19.
COMBINED_BF16_BAR = 0.35
# Per tensor, the port's gap to JAX's bf16 gradient is held to a multiple
# of JAX's own bf16 rounding on that tensor (its bf16 gradient's distance
# from its fp32 one), plus the fp32 bar of that tensor's largest value:
# a casting fault in the bf16 backward that moves one tensor by more than
# bf16 rounding does fails here. Measured at most 2.26 times (a conv bias).
COMBINED_BF16_NOISE_FACTOR = 4.0
CASES = {"float32": "fp32_case", "bfloat16": "bf16_case"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_losses_match_jax(dtype, request):
    case = request.getfixturevalue(CASES[dtype])
    want, got = case[0], case[2]
    assert set(got) == set(want) == {"l1", "dists_pref2ref", "combined"}
    gaps = {k: abs(got[k] - want[k]) for k in want}
    print(f"{dtype} loss gaps port vs JAX: {gaps}")
    assert all(np.isfinite(v) for v in got.values())
    assert max(gaps.values()) <= LOSS_BAR[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_gradients_match_jax(dtype, request):
    case = request.getfixturevalue(CASES[dtype])
    want, got = case[1], case[3]
    assert set(got) == set(want)
    gaps = {k: _rel_gap(got[k], want[k].numpy()) for k in want}
    worst = max(gaps, key=gaps.get)
    print(f"{dtype} worst gradient gap: {worst} {gaps[worst]:.3e}")
    assert all(torch.isfinite(g).all() for g in got.values())
    assert gaps[worst] <= GRAD_BAR[dtype]


def test_bf16_combined_gradient_matches_jax(bf16_case, fp32_case):
    want, got, want_fp32 = bf16_case[4], bf16_case[5], fp32_case[1]
    assert set(got) == set(want) == set(want_fp32)
    assert all(torch.isfinite(g).all() for g in got.values())
    scale = max(float(w.abs().max()) for w in want.values())
    gap = max(float((got[k].float() - want[k]).abs().max()) for k in want) / scale
    print(f"bf16 combined gradient gap: {gap:.3e} of the largest |grad|")
    assert gap <= COMBINED_BF16_BAR
    ratios = {}
    for k in want:
        noise = float((want[k] - want_fp32[k]).abs().max())
        tensor_gap = float((got[k].float() - want[k]).abs().max())
        ratios[k] = tensor_gap / max(noise, 1e-30)
        bar = (COMBINED_BF16_NOISE_FACTOR * noise
               + GRAD_BAR["float32"] * float(want_fp32[k].abs().max()))
        assert tensor_gap <= bar, k
    worst = max(ratios, key=ratios.get)
    print(f"bf16 combined gradient, worst gap over JAX's bf16 rounding: "
          f"{worst} {ratios[worst]:.2f}x")


# -- dropout, training, remat and the score map ----------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout2d_drops_whole_channels_and_repeats(dtype):
    d = tlayers.Dropout2d(0.5).train()
    x = tlayers.nchw(torch.rand(4, 6, 7, 32, generator=torch.Generator().manual_seed(0))
                     + 0.5).to(dtype)
    y = d(x, torch.Generator().manual_seed(3))
    assert y.dtype == dtype and y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, d(x, torch.Generator().manual_seed(3)))
    assert not torch.equal(y, d(x, torch.Generator().manual_seed(4)))
    kept = (y != 0).all(dim=(2, 3))
    dropped = (y == 0).all(dim=(2, 3))
    assert bool((kept | dropped).all())  # whole channels, per sample
    assert 0 < int(dropped.sum()) < dropped.numel()
    torch.testing.assert_close(y[kept], (x / 0.5)[kept], rtol=0, atol=0)
    assert d(x, None) is x
    assert d.eval()(x, torch.Generator().manual_seed(3)) is x
    assert tlayers.Dropout2d(0.0).train()(x, torch.Generator()) is x


def test_training_lowers_the_loss(port_base, batch):
    # lr 3e-4, four steps on one batch with dropout 0.1 on (as
    # tests/test_nr_model.py:95-107 does for the JAX trainer), at refine
    # depth 1; the deterministic loss falls and the frozen encoder does
    # not move
    model = NRModel(port_base.vgg, port_base.dists_weights,
                    nr_config(TConfig).replace(refine_up_depth=1, dropout_rate=0.1),
                    vit=port_base.vit, jbu=port_base.jbu,
                    render_size=NR_RENDER, sem_size=NR_SEM)
    vit_before = {k: v.clone() for k, v in model.vit.state_dict().items()}
    trainer = ttrain.NRTrainer(model, TTrainConfig(lr=3e-4, schedule="constant"),
                               steps_per_epoch=4, device="cpu")
    trainer.init(seed=0)
    assert "transformer_decoder.0.ls1.gamma" in model.decoder.state_dict()
    assert "transformer_decoder.0.attn.qkv.bias" in model.decoder.state_dict()
    inputs = [torch.from_numpy(a) for a in batch]

    def loss() -> float:
        with torch.no_grad():
            return float(model.losses(*inputs)["combined"])

    before = loss()
    steps = [float(trainer.train_step(*batch)["combined"]) for _ in range(4)]
    after = loss()
    assert np.isfinite(steps).all() and after < before, (before, steps, after)
    assert trainer.step == 4
    for k, v in model.vit.state_dict().items():
        assert torch.equal(v, vit_before[k]), k
    scores = trainer.score_frames(batch[1], batch[2])
    assert scores.shape == (1,) and np.isfinite(scores).all()
    video = trainer.score_video(np.repeat(batch[1], 3, 0), np.repeat(batch[2], 3, 0),
                                batch_size=2)
    assert np.isfinite(video)


def test_trainer_needs_a_gpu_unless_asked(port_base, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.NRTrainer(port_base)


def test_unported_training_options_raise(port_base, batch):
    # remat and the score-map objective raised until they were ported: a
    # remat decoder builds from the same weights, the score-map loss runs
    # (its parity: tests/test_torch_nr_remat.py and
    # tests/test_torch_nr_scoremap.py), and the v7/v8 normalized score is
    # still the score
    remat = NRDecoder.from_state_dict(port_base.decoder.state_dict(),
                                      nr_config(TConfig).replace(remat=True))
    assert remat.cfg.remat
    losses = port_base.losses(*(torch.from_numpy(a) for a in batch),
                              score_map=torch.ones(1, NR_RENDER, NR_RENDER))
    assert {"score_map_l1", "combined"} <= set(losses)
    assert torch.isfinite(losses["score_map_l1"]) and float(losses["score_map_l1"]) > 0
    with torch.no_grad():
        score, normalized = port_base.forward_normalized(
            torch.from_numpy(batch[1]), torch.from_numpy(batch[2]))
    assert torch.equal(score, normalized) and score.shape == (1,)
