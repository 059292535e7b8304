"""Fixtures shared by the port's parity tests (tests/test_torch_*.py):
the JAX package's VGG params from ``init_vgg16_params(seed=0)``, the same
weights in the port's pyramid through ``compat.from_jax``, a small JAX
NR v8 model with the port's copy of it, and a single torch thread per
test process."""
import jax
import numpy as np
import pytest
import torch

from nerf_qa_torch.compat.from_jax import vgg_state_dict_from_jax
from nerf_qa_torch.core.vgg import VGG16Pyramid
from nerf_qa_tpu.core.vgg import init_vgg16_params


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several worker processes on the host's cores at
    once; torch's own thread pool in each would oversubscribe them and
    slow every test that shares the machine, timed ones included."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    return init_vgg16_params(seed=0)


@pytest.fixture(scope="module")
def np_params(jax_params):
    return jax.tree_util.tree_map(np.asarray, jax_params)


@pytest.fixture(scope="module")
def torch_model(np_params):
    model = VGG16Pyramid()
    model.load_state_dict(vgg_state_dict_from_jax(np_params), strict=True)
    return model


# The NR model at a small but valid size: the DISTS pyramid (H / 16) and the
# ViT grid (H_sem / 14) must agree, 64 / 16 == 56 / 14 == 4 (as
# tests/test_nr_model.py), with a 2-block ViT and decoder depths 1 / 2.
NR_RENDER, NR_SEM = 64, 56


def nr_config(cfg_cls, dists_cfg=None):
    kw = {} if dists_cfg is None else {"dists": dists_cfg}
    return cfg_cls(transformer_decoder_depth=1, refine_up_depth=2, **kw)


@pytest.fixture(scope="module")
def jax_nr(jax_params):
    """(JAX NRModel, decoder params), every init under jit (eager flax init
    of the ViT, JBU and decoder takes over a minute on the CPU)."""
    from nerf_qa_tpu.config import NRModelConfig
    from nerf_qa_tpu.models.nr.featup import JBUStack
    from nerf_qa_tpu.models.nr.model import NRModel
    from nerf_qa_tpu.models.nr.vit import ViTS14

    k_vit, k_jbu, k_dec = jax.random.split(jax.random.PRNGKey(0), 3)
    image = jax.numpy.zeros((1, NR_SEM, NR_SEM, 3))
    vit = ViTS14(depth=2)
    vit_params = jax.jit(vit.init)(k_vit, image)["params"]
    grid = jax.numpy.zeros((1, NR_SEM // 14, NR_SEM // 14, vit.embed_dim))
    jbu_params = jax.jit(JBUStack(vit.embed_dim).init)(k_jbu, grid, image)["params"]
    model = NRModel(jax_params, cfg=nr_config(NRModelConfig), vit=vit,
                    vit_params=vit_params, jbu_params=jbu_params,
                    render_size=NR_RENDER, sem_size=NR_SEM)
    feats = jax.jit(model.encode)(jax.numpy.zeros((1, NR_RENDER, NR_RENDER, 3)), image)
    dec_params = jax.jit(lambda k, f: model.decoder.init(
        k, f.dists_feats, f.sem_feats, f.sem_pyramid, True, None))(k_dec, feats)["params"]
    return model, dec_params


def torch_nr_from_jax(jax_model, dec_params, vgg, cfg):
    """The port's NRModel with the JAX model's weights (compat/from_jax)."""
    from nerf_qa_torch.compat import from_jax
    from nerf_qa_torch.models.nr.decoder import NRDecoder
    from nerf_qa_torch.models.nr.featup import JBUStack
    from nerf_qa_torch.models.nr.model import NRModel
    from nerf_qa_torch.models.nr.vit import ViTS14

    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    vit = ViTS14(depth=2, grid_size=NR_SEM // 14)
    vit.load_state_dict(from_jax.vit_state_dict_from_jax(to_np(jax_model.vit_params)))
    jbu = JBUStack(vit.embed_dim)
    jbu.load_state_dict(from_jax.jbu_state_dict_from_jax(to_np(jax_model.jbu_params)))
    decoder = NRDecoder.from_state_dict(
        from_jax.nr_decoder_state_dict_from_jax(to_np(dec_params)), cfg)
    w = jax_model.dists_weights
    return NRModel(vgg, from_jax.dists_weights_from_jax(np.asarray(w.alpha),
                                                        np.asarray(w.beta)),
                   cfg, vit=vit, jbu=jbu, decoder=decoder,
                   render_size=NR_RENDER, sem_size=NR_SEM)
