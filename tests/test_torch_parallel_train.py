"""The port's data-parallel trainers on CPU meshes: FRTrainer(mesh=...)
against the JAX package's FRTrainer(mesh=...) on its virtual mesh (one
image step, the bars of tests/test_torch_fr_train.py's image step) and
against its own unsharded steps (image, cached and eval, a batch that
needs padding); NRTrainer(mesh=...) against its unsharded step with
dropout on (the global masks sliced per shard) for v8 and for the
BatchNorm generation v1 (global batch statistics), and the BatchNorm
running averages, the dropout generator and the losses after it. The NR
comparisons against JAX's meshed trainer are in
tests/test_torch_parallel_nr.py."""
import copy

import jax
import numpy as np
import pytest
import torch

from nerf_qa_torch.config import DISTSConfig as TDConfig
from nerf_qa_torch.config import FRModelConfig as TConfig
from nerf_qa_torch.config import NRModelConfig as TNRConfig
from nerf_qa_torch.config import TrainConfig as TTrain
from nerf_qa_torch.core.vgg import VGG16Pyramid, init_he_normal
from nerf_qa_torch.models.nr.layers import BatchNorm
from nerf_qa_torch.models.nr.model import NRModel
from nerf_qa_torch.models.nr.vit import ViTS14, init_vit_
from nerf_qa_torch.parallel.mesh import create_mesh
from nerf_qa_torch.train import fr_train as tft
from nerf_qa_torch.train.nr_train import NRTrainer
from nerf_qa_tpu.config import DISTSConfig as JDConfig
from nerf_qa_tpu.config import FRModelConfig as JConfig
from nerf_qa_tpu.config import TrainConfig as JTrain
from nerf_qa_tpu.parallel import mesh as jmesh
from nerf_qa_tpu.train import fr_train as jft
from tests.test_torch_fr_train import (
    AGREE_MIN_GRAD,
    AGREE_SHARE,
    CACHED_GRAD_SHARE,
    CACHED_LOSS_ATOL,
    CACHED_PARAM_ATOL,
    CACHED_PRED_ATOL,
    FIRST_LR,
    IMAGE_GRAD_ATOL,
    IMAGE_LOSS_ATOL,
    _flat,
    _init,
    _jax_grads,
    _port_flat,
    _port_params,
    _record_grads,
)
from tests.torch_parity import jax_params, np_params, one_torch_thread, torch_model  # noqa: F401

N, HW = 4, 32
CPU = torch.device("cpu")
# the NR training bars of the port (chip_smoke.py's kernels-vs-plain
# step, fp32): losses 1e-5; each decoder gradient within 1e-4 of its own
# largest value, where that value is resolved (RESOLVED of the decoder's
# largest; below it both sides give rounding noise, held to NULL_GRAD_BAR
# of the decoder's largest, as tests/torch_nr_versions.py does); the
# running averages 1e-5 of their largest
NR_LOSS_ATOL = 1e-5
NR_GRAD_RTOL = 1e-4
RESOLVED = 1e-2
NULL_GRAD_BAR = 1e-5
STATS_RTOL = 1e-5


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    ref = rng.random((6, HW, HW, 3), dtype=np.float32)
    dist = np.clip(ref + rng.normal(0, 0.1, ref.shape), 0, 1).astype(np.float32)
    targets = rng.uniform(1, 5, 6).astype(np.float32)
    return dist, ref, targets


def _fr_trainers(jax_params, torch_model, jax_mesh=None, port_mesh=None,
                 jax_impl="xla", port_impl="eager", port_device=None):
    train = dict(lr=1e-3, schedule="exp", gamma=0.5, batch_size=N)
    jt = jft.FRTrainer(jax_params, JConfig(regression_type="linear",
                                           dists=JDConfig(stats_impl=jax_impl)),
                       JTrain(**train), steps_per_epoch=2, mesh=jax_mesh)
    tt = tft.FRTrainer(copy.deepcopy(torch_model),
                       TConfig(regression_type="linear",
                               dists=TDConfig(stats_impl=port_impl)),
                       TTrain(**train), steps_per_epoch=2, mesh=port_mesh,
                       device=port_device)
    return jt, tt


@pytest.mark.parametrize("impls", [("xla", "kernel")])
def test_fr_mesh_image_step_matches_jax_meshed_trainer(jax_params, torch_model, batch,
                                                       impls):
    # four shards of one pair each on both sides, the port's statistics
    # through the moments kernel's wrapper (its plain sums here); the bars
    # of the unsharded image step (test_torch_fr_train.py)
    dist, ref, targets = batch
    jt, tt = _fr_trainers(jax_params, torch_model, jmesh.create_mesh(jax.devices()[:4]),
                          create_mesh([CPU] * 4), *impls)
    jp, jo, tp, to = _init(jt, tt)
    tp = _port_params(tp, to)
    seen = _record_grads(tt)
    stats = np.asarray(jt._pair_stats_step(dist[:N], ref[:N]))
    want_g = _jax_grads(jt, jp, stats, targets[:N])
    jp1, _, jloss, jaux = jt.train_step(jp, jo, dist[:N], ref[:N], targets[:N])
    tp1, _, tloss, taux = tt.train_step(tp, to, dist[:N], ref[:N], targets[:N])
    slope = abs(float(jp["head"]["weight"][0]))
    assert abs(float(tloss) - float(jloss)) <= IMAGE_LOSS_ATOL * slope
    np.testing.assert_allclose(taux[0].numpy(), np.asarray(jaux[0]),
                               atol=IMAGE_LOSS_ATOL * slope)
    np.testing.assert_allclose(taux[1].numpy(), np.asarray(jaux[1]), atol=IMAGE_LOSS_ATOL)
    for got, want in zip(seen[-1], _flat(want_g)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=IMAGE_GRAD_ATOL * slope)
    for got, want, tg, jg in zip(_port_flat(tp1), _flat(jp1), seen[-1], _flat(want_g)):
        tg = tg.numpy()
        agree = ((np.sign(tg) == np.sign(jg))
                 & (np.minimum(np.abs(tg), np.abs(jg)) > AGREE_MIN_GRAD))
        gap = np.abs(got - want)
        assert gap[agree].max(initial=0) <= CACHED_PARAM_ATOL
        assert gap.max() <= 2 * FIRST_LR + CACHED_PARAM_ATOL
        if got.size > 1:
            assert agree.mean() >= AGREE_SHARE, agree.mean()


# four copies of the CPU, or four distinct device names (cpu:1 is the CPU
# too, under another name), whose shards then run on copies of the model
DEVICE_SETS = {"repeated": [CPU] * 4, "distinct": ["cpu", "cpu:1", "cpu:2", "cpu:3"]}


@pytest.mark.parametrize("devices", list(DEVICE_SETS))
def test_fr_mesh_steps_match_the_unsharded_steps(jax_params, torch_model, batch, devices):
    # six pairs over four shards (padded to eight, the padding dropped):
    # the image step, a cached step and the eval step against the same
    # trainer without a mesh, from the same params and Adam state
    dist, ref, targets = batch
    jt, single = _fr_trainers(jax_params, torch_model, port_device="cpu")
    _, meshed = _fr_trainers(jax_params, torch_model,
                             port_mesh=create_mesh(DEVICE_SETS[devices]))
    assert len(set(map(id, meshed._vggs.values()))) == (4 if devices == "distinct" else 1)
    _, _, sp, so = _init(jt, single)
    _, _, mp, mo = _init(jt, meshed)
    sp, mp = _port_params(sp, so), _port_params(mp, mo)
    s_seen, m_seen = _record_grads(single), _record_grads(meshed)
    stats = meshed.pair_stats(dist, ref)
    assert stats.shape == (5, 6, 1475)
    np.testing.assert_allclose(stats.numpy(), single.pair_stats(dist, ref).numpy(),
                               rtol=1e-6, atol=1e-7)
    cache = stats.transpose(0, 1).numpy()
    for step in ("image", "cached"):
        if step == "image":
            sp, so, sl, sa = single.train_step(sp, so, dist, ref, targets)
            mp, mo, ml, ma = meshed.train_step(mp, mo, dist, ref, targets)
        else:
            sp, so, sl, sa = single.train_step_cached(sp, so, cache, targets)
            mp, mo, ml, ma = meshed.train_step_cached(mp, mo, cache, targets)
        assert abs(float(ml) - float(sl)) <= CACHED_LOSS_ATOL
        np.testing.assert_allclose(ma[0].numpy(), sa[0].numpy(), atol=CACHED_PRED_ATOL)
        want = [g.numpy() for g in s_seen[-1]]
        n_head = len(want) - 2
        for lo, hi in ((0, n_head), (n_head, len(want))):
            scale = max(float(np.abs(w).max()) for w in want[lo:hi])
            for g, w in zip(m_seen[-1][lo:hi], want[lo:hi]):
                np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                           atol=CACHED_GRAD_SHARE * scale)
        for got, want in zip(_port_flat(mp), _port_flat(sp)):
            np.testing.assert_allclose(got, want, rtol=0, atol=CACHED_PARAM_ATOL)
    pred, ds = meshed.evaluate(mp, dist, ref)
    want_pred, want_ds = single.evaluate(mp, dist, ref)
    assert pred.shape == (6,)
    np.testing.assert_allclose(pred.numpy(), want_pred.numpy(), atol=CACHED_PRED_ATOL)
    np.testing.assert_allclose(ds.numpy(), want_ds.numpy(), atol=1e-6)


# -- NR ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def nr_batch():
    rng = np.random.default_rng(1)
    gt = rng.random((4, 32, 32, 3), dtype=np.float32)
    render = np.clip(gt + rng.normal(0, 0.08, gt.shape), 0, 1).astype(np.float32)
    r224 = rng.random((4, 28, 28, 3), dtype=np.float32)
    return gt, render, r224


def _nr_step(model, mesh, data, steps=1):
    """One fresh trainer's decoder gradients of its first step, its losses
    after ``steps`` steps, and its decoder state and generator after them."""
    trainer = NRTrainer(copy.deepcopy(model), TTrain(lr=1e-3, schedule="constant",
                                                     batch_size=4),
                        steps_per_epoch=1, device="cpu", mesh=mesh)
    trainer.init(seed=0)
    grads = {}

    def keep(opt, args, kwargs):
        if not grads:
            for n, p in trainer.model.decoder.named_parameters():
                grads[n] = torch.zeros_like(p) if p.grad is None else p.grad.clone()

    trainer.optimizer.register_step_pre_hook(keep)
    losses = [{k: float(v) for k, v in trainer.train_step(*data).items()}
              for _ in range(steps)]
    return (losses, grads, dict(trainer.model.decoder.state_dict()),
            trainer.generator.get_state(), trainer)


def _check_grads(got, want):
    top = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        gap = float((got[k] - w).abs().max())
        scale = float(w.abs().max())
        if scale < RESOLVED * top:
            assert gap <= NULL_GRAD_BAR * top, (k, gap / top)
        else:
            assert gap <= NR_GRAD_RTOL * scale, (k, gap / scale)


@pytest.mark.parametrize("version,devices", [(8, "repeated"), (1, "repeated"),
                                             (1, "distinct")])
def test_nr_mesh_step_matches_the_unsharded_step(nr_batch, version, devices):
    # dropout 0.2 on: the sharded step draws the unsharded step's masks;
    # v1's BatchNorms normalise with the global batch's statistics and move
    # their running averages once. Two shards of two rows at 32² / 28²;
    # on distinct devices the second shard runs a copy of the model whose
    # gradients are added to the trainer's.
    torch.manual_seed(0)
    vgg = init_he_normal(VGG16Pyramid(), torch.Generator().manual_seed(0))
    cfg = TNRConfig(version=version, transformer_decoder_depth=1, refine_up_depth=1,
                    dropout_rate=0.2)
    vit = init_vit_(ViTS14(depth=1, grid_size=2), torch.Generator().manual_seed(1))
    model = NRModel(vgg, cfg=cfg, vit=vit, render_size=32, sem_size=28)
    want = _nr_step(model, None, nr_batch)
    got = _nr_step(model, create_mesh(DEVICE_SETS[devices][:2]), nr_batch)
    copies = [m for m in got[4]._replicas.values() if m is not got[4].model]
    assert len(copies) == (devices == "distinct")
    for a, b in zip(got[0], want[0]):
        assert a.keys() == b.keys()
        for k in b:
            assert abs(a[k] - b[k]) <= NR_LOSS_ATOL, (k, a[k], b[k])
    _check_grads(got[1], want[1])
    assert torch.equal(got[3], want[3])  # the generator drew the same masks
    bn = [k for k in want[2] if k.endswith(("running_mean", "running_var"))]
    assert bool(bn) == (version == 1)
    for k in bn:
        scale = max(float(want[2][k].abs().max()), 1e-12)
        assert float((got[2][k] - want[2][k]).abs().max()) <= STATS_RTOL * scale, k
    counts = [int(v) for k, v in got[2].items() if k.endswith("num_batches_tracked")]
    assert all(c == 1 for c in counts)
    trainer = got[4]
    scores = trainer.score_frames(nr_batch[1], nr_batch[2])
    want_scores = want[4].score_frames(nr_batch[1], nr_batch[2])
    assert scores.shape == (4,)
    np.testing.assert_allclose(scores, want_scores, atol=1e-3)


def test_nr_mesh_batch_must_split(nr_batch):
    vgg = init_he_normal(VGG16Pyramid(), torch.Generator().manual_seed(0))
    cfg = TNRConfig(version=8, transformer_decoder_depth=0, refine_up_depth=1)
    vit = init_vit_(ViTS14(depth=1, grid_size=2), torch.Generator().manual_seed(1))
    trainer = NRTrainer(NRModel(vgg, cfg=cfg, vit=vit, render_size=32, sem_size=28),
                        device="cpu", mesh=create_mesh([CPU] * 4))
    trainer.init()
    with pytest.raises(ValueError, match="does not split"):
        trainer.train_step(*(a[:3] for a in nr_batch))
    assert not any(isinstance(m, BatchNorm) for m in trainer.model.decoder.modules())


def test_nr_mesh_stays_within_one_process(nr_batch):
    # the FR trainer sums over a mesh's process group; the NR trainer
    # refuses one (train_nr's processes train their own slices)
    from nerf_qa_torch.parallel.mesh import Mesh

    vgg = init_he_normal(VGG16Pyramid(), torch.Generator().manual_seed(0))
    cfg = TNRConfig(version=8, transformer_decoder_depth=0, refine_up_depth=1)
    vit = init_vit_(ViTS14(depth=1, grid_size=2), torch.Generator().manual_seed(1))
    model = NRModel(vgg, cfg=cfg, vit=vit, render_size=32, sem_size=28)
    mesh = create_mesh([CPU] * 2)
    with pytest.raises(ValueError, match="within one process"):
        NRTrainer(model, device="cpu", mesh=Mesh(mesh.devices, group=object()))
