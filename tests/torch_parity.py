"""Fixtures shared by the port's parity tests (tests/test_torch_*.py):
the JAX package's VGG params from ``init_vgg16_params(seed=0)``, the same
weights in the port's pyramid through ``compat.from_jax``, and a single
torch thread per test process."""
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
