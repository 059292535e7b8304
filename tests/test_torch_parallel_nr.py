"""The port's data-parallel NR trainer against the JAX package's meshed
trainer on the CPU: NR v1 (the BatchNorm generation, whose batch
statistics are global under JAX's sharding) at the small size of
tests/torch_nr_versions.py (64² / 56², a 1-block ViT, decoder depths
1 / 1, dropout 0, batch 2), one step over a two-device mesh on each side:
the losses and the BatchNorm running averages after the step at that
module's bars, and the first Adam update (lr · g / (|g| + eps) per
element, so its sign) element by element wherever the port's gradient is
resolved. The port's meshed step against its unsharded one, gradients
included, is in tests/test_torch_parallel_train.py."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nerf_qa_torch.compat import from_jax
from nerf_qa_torch.config import TrainConfig as TTrainConfig
from nerf_qa_torch.parallel.mesh import create_mesh
from nerf_qa_torch.train.nr_train import NRTrainer
from nerf_qa_tpu.config import TrainConfig as JTrainConfig
from nerf_qa_tpu.parallel import mesh as jmesh
from nerf_qa_tpu.train.nr_train import NRTrainer as JNRTrainer
from tests.torch_nr_versions import MEAN, SCORE_ATOL, STATS_RTOL, STD, batch, make_case
from tests.torch_parity import jax_params, np_params, one_torch_thread, torch_model  # noqa: F401

LR = 1e-3
# Adam's first update is lr · g / (|g| + eps) with eps 1e-8: where the
# port's |g| is at least 1e-6 of the decoder's largest gradient the two
# updates must agree within 1 % of lr, on at least 99 % of those elements
# (a gradient that near zero may flip its sign between two reduction
# orders)
RESOLVED_GRAD = 1e-6
UPDATE_ATOL = 1e-2 * LR
AGREE_SHARE = 0.99


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_nr_mesh_step_matches_jax_meshed_trainer(jax_params, torch_model):
    jm, params, state, port = make_case(jax_params, torch_model, 1)
    data = batch()
    assert "batch_stats" in state and data[0].shape[0] == 2

    jt = JNRTrainer(jm, JTrainConfig(lr=LR, schedule="constant", batch_size=2),
                    steps_per_epoch=1, mesh=jmesh.create_mesh(jax.devices()[:2]))
    new_params, new_state, _, jl, _ = jt.train_step(
        params, state, jt.optimizer.init(params), *(jnp.asarray(a) for a in data),
        jax.random.PRNGKey(1), STD, MEAN)

    trainer = NRTrainer(copy.deepcopy(port), TTrainConfig(lr=LR, schedule="constant",
                                                          batch_size=2),
                        steps_per_epoch=1, device="cpu", mesh=create_mesh(["cpu"] * 2))
    trainer.set_decoder(trainer.model.decoder)
    before = {k: v.clone() for k, v in trainer.model.decoder.state_dict().items()}
    grads = {}

    def keep(opt, args, kwargs):
        for n, p in trainer.model.decoder.named_parameters():
            grads[n] = torch.zeros_like(p) if p.grad is None else p.grad.clone()

    trainer.optimizer.register_step_pre_hook(keep)
    losses = {k: float(v) for k, v in trainer.train_step(*data, STD, MEAN).items()}
    after = trainer.model.decoder.state_dict()

    assert set(losses) == {k for k in jl} == {"l1", "dists_pref2ref", "combined"}
    for k, v in jl.items():
        assert abs(losses[k] - float(v)) <= SCORE_ATOL, (k, losses[k], float(v))

    want = from_jax.nr_decoder_state_dict_from_jax(
        _np(new_params), qkv_bias=True, layer_scale=True,
        batch_stats=_np(new_state["batch_stats"]), version=1)
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        scale = max(float(want[k].abs().max()), 1e-12)
        assert float((after[k] - want[k]).abs().max()) <= STATS_RTOL * scale, k

    top = max(float(g.abs().max()) for g in grads.values())
    agree = total = 0
    for k, g in grads.items():
        got = (before[k] - after[k]).numpy()
        jax_update = (before[k] - want[k]).numpy()
        resolved = g.abs().numpy() >= RESOLVED_GRAD * top
        total += int(resolved.sum())
        agree += int((np.abs(got - jax_update)[resolved] <= UPDATE_ATOL).sum())
    assert total > 1000 and agree >= AGREE_SHARE * total, (agree, total)
