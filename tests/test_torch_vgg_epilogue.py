"""The VGG pyramid's epilogue wrappers on the CPU (ops/cuda/vgg_epilogue.py).

CPU tensors take the plain versions and launch nothing; the pyramid, which
now hands the L2 pool the squares its last conv pass made, gives the same
bits as the ops it ran before: conv, add_, relu_ after each conv, and the
pool's x * x, conv, add_, sqrt_. The kernels themselves are held to the
plain versions on the card (tests/test_torch_kernels.py).
"""
import weakref

import pytest
import torch
import torch.nn.functional as F

from nerf_qa_torch.core import vgg
from nerf_qa_torch.ops.cuda import vgg_epilogue as ve
from nerf_qa_torch.ops.l2pool import hann_filter, l2pool_nchw, l2pool_squares

DTYPES = [torch.float32, torch.bfloat16]


def _map(shape, dtype, seed=0, channels_last=True):
    g = torch.Generator().manual_seed(seed)
    y = torch.randn(shape, generator=g).to(dtype)
    return y.contiguous(memory_format=torch.channels_last) if channels_last else y


@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_bias_relu_takes_the_plain_version(dtype, square):
    y = _map((2, 16, 5, 6), dtype)
    b = torch.randn(16)
    want = ve.bias_relu_plain(y.clone(), b, square=square)
    before = ve.launches
    got = ve.bias_relu(y, b, square=square)
    assert ve.launches == before
    for g, w in zip(got if square else (got,), want if square else (want,)):
        assert torch.equal(g, w) and g.stride() == w.stride()
    h = got[0] if square else got
    assert h.data_ptr() == y.data_ptr()  # in place, as the plain add_/relu_


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_pool_root_takes_the_plain_version(dtype):
    p = _map((2, 16, 5, 6), dtype).abs()
    want = p.clone().add_(1e-12).sqrt_()
    before = ve.launches
    got = ve.pool_root(p)
    assert ve.launches == before
    assert torch.equal(got, want) and got.data_ptr() == p.data_ptr()


def test_bias_relu_rejects_a_bias_that_requires_grad():
    with pytest.raises(RuntimeError, match="requires grad"):
        ve.bias_relu(_map((1, 4, 3, 3), torch.float32),
                     torch.zeros(4, requires_grad=True))
    with pytest.raises(ValueError, match="C biases"):
        ve.bias_relu(_map((1, 4, 3, 3), torch.float32), torch.zeros(5))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        ve.pool_root(torch.ones((1, 4, 3, 3), dtype=torch.float16))


def test_bias_relu_folds_no_squares_under_a_recorded_gradient():
    """Under autograd the caller squares the output itself (the pyramid
    does), so the fold is refused on every device."""
    y = _map((1, 4, 3, 3), torch.float32).requires_grad_(True)
    with pytest.raises(RuntimeError, match="recorded gradient"):
        ve.bias_relu(y * 1, torch.zeros(4), square=True)
    with torch.no_grad():
        h, sq = ve.bias_relu(y * 1, torch.zeros(4), square=True)
    assert torch.equal(sq, h * h)


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_l2pool_from_squares_equals_l2pool_nchw(dtype, channels_last):
    x = _map((2, 8, 11, 14), dtype, seed=1, channels_last=channels_last)
    filt = hann_filter(8)
    want = l2pool_nchw(x, filt)
    got = l2pool_squares(x * x, filt)
    assert torch.equal(got, want) and got.stride() == want.stride()
    assert torch.equal(vgg.L2Pool(8).from_squares(x * x), want)


def _pyramid_as_before(model, x, dtype):
    """The pyramid's forward as its separate PyTorch ops ran it."""
    feats = [x.to(dtype).contiguous()]
    h = (vgg._nchw(x.float()) - model.mean) / model.std
    with vgg._precision(dtype):
        for si in range(1, 6):
            for layer in model.stage(si).children():
                if isinstance(layer, vgg.L2Pool):
                    out = F.conv2d(h * h, layer.filter.to(h.dtype), stride=2,
                                   padding=1, groups=h.shape[1])
                    h = out.add_(1e-12).sqrt_()
                else:
                    y = F.conv2d(h.to(dtype), layer.weight.to(dtype), padding=1)
                    h = y.add_(layer.bias.to(dtype).view(1, -1, 1, 1)).relu_()
            h = h.contiguous(memory_format=torch.channels_last)
            feats.append(h.permute(0, 2, 3, 1))
    return feats


@pytest.mark.parametrize("dtype", DTYPES)
def test_pyramid_with_the_square_fold_equals_the_ops_before(dtype):
    gen = torch.Generator().manual_seed(0)
    model = vgg.init_he_normal(vgg.VGG16Pyramid(), gen)
    with torch.no_grad():
        for name, t in model.named_parameters():
            if name.endswith("bias"):
                t.copy_(0.05 * torch.randn(t.shape, generator=gen))
    x = torch.rand((2, 40, 56, 3), generator=gen)
    with torch.no_grad():
        got = model(x, dtype)
        want = _pyramid_as_before(model, x, dtype)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.is_contiguous()
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pyramid_under_grad_equals_the_ops_before(dtype):
    """With a gradient recorded the squares are not folded into the last
    conv's pass: the ops run in their old order, so the input's gradient
    is the old one bit for bit."""
    gen = torch.Generator().manual_seed(4)
    model = vgg.init_he_normal(vgg.VGG16Pyramid(), gen)
    x = torch.rand((1, 36, 44, 3), generator=gen)
    cots = [torch.randn(f.shape, generator=gen).to(dtype)
            for f in _pyramid_as_before(model, x, dtype)]
    grads = []
    for pyramid in (lambda t: model(t, dtype), lambda t: _pyramid_as_before(model, t, dtype)):
        leaf = x.clone().requires_grad_(True)
        loss = sum((f.float() * c.float()).sum() for f, c in zip(pyramid(leaf), cots))
        grads.append(torch.autograd.grad(loss, leaf)[0])
    assert torch.equal(grads[0], grads[1])


def test_stage_apply_under_grad_matches_the_ops_before():
    """NR's RefineDown runs vgg_stage_apply under training: the gradient
    through the pool's squares and the bias-ReLU is PyTorch's own."""
    gen = torch.Generator().manual_seed(2)
    model = vgg.init_he_normal(vgg.VGG16Pyramid(), gen)
    x = torch.rand((1, 16, 20, 64), generator=gen)
    grads = []
    for run in ("now", "before"):
        leaf = x.clone().requires_grad_(True)
        if run == "now":
            out = vgg.vgg_stage_apply(model, 2, leaf)
        else:
            h = vgg._nchw(leaf.float())
            pool, *convs = model.stage(2).children()
            h = F.conv2d(h * h, pool.filter, stride=2, padding=1,
                         groups=h.shape[1]).add_(1e-12).sqrt_()
            for conv in convs:
                h = F.conv2d(h, conv.weight, padding=1).add_(
                    conv.bias.view(1, -1, 1, 1)).relu_()
            out = h.permute(0, 2, 3, 1)
        (g,) = torch.autograd.grad(out.square().sum(), leaf)
        grads.append((out.detach(), g))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])


def test_pyramid_frees_the_squares_and_each_pooled_map_after_use(monkeypatch):
    """Peak memory: the squares a stage's last pass wrote are gone once the
    next stage has pooled them, and the pooled map once the first conv of
    its stage has read it; nothing outside the stage loop holds either."""
    refs = []
    real_bias_relu, real_from_squares, real_conv = ve.bias_relu, vgg.L2Pool.from_squares, vgg._conv

    def bias_relu(y, b, *, square=False):
        out = real_bias_relu(y, b, square=square)
        if square:
            refs.append(("squares", weakref.ref(out[1])))
        return out

    def from_squares(self, sq):
        out = real_from_squares(self, sq)
        refs.append(("pooled", weakref.ref(out)))
        return out

    live = []

    def conv(h, c, dtype):
        out = real_conv(h, c, dtype)
        live.append([(kind, i) for i, (kind, r) in enumerate(refs) if r() is not None])
        return out

    monkeypatch.setattr(ve, "bias_relu", bias_relu)
    monkeypatch.setattr(vgg.L2Pool, "from_squares", from_squares)
    monkeypatch.setattr(vgg, "_conv", conv)
    model = vgg.init_he_normal(vgg.VGG16Pyramid(), torch.Generator().manual_seed(5))
    with torch.no_grad():
        model(torch.rand((1, 40, 48, 3), generator=torch.Generator().manual_seed(6)),
              torch.bfloat16)
    assert [k for k, _ in refs] == ["squares", "pooled"] * 4 and len(live) == 13
    # at each conv only the map it read may still be alive: the pooled map
    # at a stage's first conv, nothing at the others
    firsts = [2, 4, 7, 10]  # the first conv of stages 2-5
    for i, alive in enumerate(live):
        want = [("pooled", 2 * firsts.index(i) + 1)] if i in firsts else []
        assert alive == want, (i, alive)
