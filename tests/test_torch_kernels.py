"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU with nvcc and skip elsewhere. Run them on the
card with (tests/conftest.py imports JAX, which the card's machine need not
have):  python -m pytest tests/test_torch_kernels.py -m cuda --noconftest
"""
import contextlib

import pytest
import torch

from nerf_qa_torch.ops.cuda import channelnorm, jbu, moments, vgg_epilogue, windowed_tsd

pytestmark = pytest.mark.cuda

# fp32 sums taken in other orders over up to 2M terms
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")


def _pair(shape, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    fx = torch.rand(shape, generator=g, device="cuda")
    fy = 0.6 * fx + 0.4 * torch.rand(shape, generator=g, device="cuda")
    return fx.to(dtype), fy.to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [
    (4, 256, 256, 3), (4, 256, 256, 64), (4, 128, 128, 128), (4, 64, 64, 256),
    (4, 32, 32, 512), (4, 16, 16, 512), (1, 17, 33, 3), (2, 67, 120, 512),
    (3, 1, 1, 8), (2, 5, 7, 12),
])
def test_moments_kernel_matches_plain(shape, dtype):
    fx, fy = _pair(shape, dtype)
    before = moments.launches
    got = moments.moment_sums(fx, fy)
    torch.cuda.synchronize()
    assert moments.launches == before + 1
    torch.testing.assert_close(got, moments.moment_sums_plain(fx, fy),
                               rtol=RTOL, atol=ATOL)


def test_moments_kernel_unaligned_input_takes_scalar_loads():
    base = torch.rand(1 + 2 * 9 * 11 * 64, device="cuda")
    fx = base[1:].view(2, 9, 11, 64)  # 4-byte offset: not 16-byte aligned
    fy = torch.flip(fx, dims=(0,)).contiguous()
    torch.testing.assert_close(moments.moment_sums(fx, fy),
                               moments.moment_sums_plain(fx, fy),
                               rtol=RTOL, atol=ATOL)


def test_moments_kernel_repeats_bit_for_bit():
    fx, fy = _pair((2, 200, 300, 64), torch.bfloat16)
    assert torch.equal(moments.moment_sums(fx, fy), moments.moment_sums(fx, fy))


def test_moments_stats_match_two_pass_at_1080p():
    fx, fy = _pair((2, 1080, 1920, 64), torch.bfloat16)
    got = moments.stage_stats_kernel(fx, fy)
    x, y = fx.double(), fy.double()
    mx, my = x.mean((1, 2)), y.mean((1, 2))
    dx, dy = x - mx[:, None, None], y - my[:, None, None]
    want = (mx, my, dx.square().mean((1, 2)), dy.square().mean((1, 2)),
            (dx * dy).mean((1, 2)))
    for a, b in zip(got, want):
        torch.testing.assert_close(a.double(), b, rtol=RTOL, atol=ATOL)


# the FR training step's stages: one pyramid batch of 2 x 32 images at
# 256², split into its dist and ref halves (train/fr_train.py)
FR_STAGES = ((256, 3), (256, 64), (128, 128), (64, 256), (32, 512), (16, 512))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hw,c", FR_STAGES)
def test_moments_kernel_at_fr_training_shapes(hw, c, dtype):
    both, _ = _pair((64, hw, hw, c), dtype, seed=hw + c)
    fx, fy = both[:32], both[32:]
    before = moments.launches
    got = moments.moment_sums(fx, fy)
    torch.cuda.synchronize()
    assert moments.launches == before + 1
    torch.testing.assert_close(got, moments.moment_sums_plain(fx, fy),
                               rtol=RTOL, atol=ATOL)


def test_moments_kernel_rejects_grad_and_bad_layout():
    fx, fy = _pair((1, 8, 8, 16), torch.float32)
    with pytest.raises(RuntimeError, match="no backward"):
        moments.moment_sums(fx.requires_grad_(True), fy)
    with pytest.raises(ValueError):
        moments.moment_sums(fy.transpose(1, 2), fy.transpose(1, 2))


# ChannelNorm: fp32 row statistics in other orders; bf16 output may round
# the other way once (one bf16 ulp, 2**-8 relative)
CN_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2**-7, 1e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("rows,c", [(1000, 384), (777, 387), (513, 448),
                                    (300, 512), (257, 640), (129, 896),
                                    (33, 3), (5, 1024)])
def test_channelnorm_kernel_matches_plain(rows, c, gelu, dtype):
    g = torch.Generator(device="cuda").manual_seed(c)
    x = (1.5 * torch.randn((rows, c), generator=g, device="cuda") + 0.3).to(dtype)
    scale = 1 + 0.2 * torch.randn(c, generator=g, device="cuda")
    bias = 0.2 * torch.randn(c, generator=g, device="cuda")
    before = channelnorm.launches
    got = channelnorm.channel_norm_act(x, scale, bias, gelu=gelu)
    torch.cuda.synchronize()
    assert channelnorm.launches == before + 1 and got.dtype == dtype
    rtol, atol = CN_TOL[dtype]
    torch.testing.assert_close(
        got.float(), channelnorm.channel_norm_act_plain(x, scale, bias, gelu=gelu).float(),
        rtol=rtol, atol=atol)


def test_channelnorm_kernel_unaligned_and_nhwc_view():
    base = torch.randn(1 + 6 * 5 * 448, device="cuda")
    x = base[1:].view(6, 5, 448)  # 4-byte offset: scalar loads
    s, b = torch.ones(448, device="cuda"), torch.zeros(448, device="cuda")
    torch.testing.assert_close(channelnorm.channel_norm_act(x, s, b, gelu=True),
                               channelnorm.channel_norm_act_plain(x, s, b, gelu=True),
                               rtol=1e-5, atol=1e-5)


def test_channelnorm_module_routes_cuda_tensors_to_the_kernel():
    from nerf_qa_torch.models.nr.layers import ChannelNorm, nchw

    cn = ChannelNorm(387).cuda()
    x = nchw(torch.randn(2, 9, 11, 387, device="cuda"))
    before = channelnorm.launches
    with torch.no_grad():
        got = cn(x, gelu=True)
        assert channelnorm.launches == before + 1
        cn.fused = False
        want = cn(x, gelu=True)
    assert channelnorm.launches == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_channelnorm_kernel_rejects_grad_layout_and_width():
    # a CUDA tensor under grad goes through the autograd Function (the
    # backward kernel), never the plain version; bad layouts and widths
    # still raise
    x = torch.randn(4, 8, 64, device="cuda")
    s, b = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    before = (channelnorm.launches, channelnorm.bwd_launches)
    xg = x.clone().requires_grad_(True)
    channelnorm.channel_norm_act(xg, s, b).sum().backward()
    assert (channelnorm.launches, channelnorm.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert xg.grad.shape == x.shape
    with pytest.raises(ValueError):
        channelnorm.channel_norm_act(x.transpose(0, 1), s, b)
    wide = torch.randn(2, 1100, device="cuda")
    with pytest.raises(ValueError):
        channelnorm.channel_norm_act(wide, torch.ones(1100, device="cuda"),
                                     torch.zeros(1100, device="cuda"))
    with pytest.raises(ValueError):
        channelnorm.channel_norm_act_bwd(x, x[:2], s, b)


def _cn_bwd_inputs(rows, c, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (1.5 * torch.randn((rows, c), generator=g, device="cuda") + 0.3).to(dtype)
    dy = torch.randn((rows, c), generator=g, device="cuda").to(dtype)
    scale = 1 + 0.2 * torch.randn(c, generator=g, device="cuda")
    bias = 0.2 * torch.randn(c, generator=g, device="cuda")
    return x, dy, scale, bias


def _cn_abs_terms(x, g, scale, bias, gelu, eps=1e-5):
    """Per channel, the sums of |dy·x̂| and |dy| that dscale and dbias add
    up (the scale of their rounding)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xh = (xf - mean) * torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + eps)
    dy = g.float()
    if gelu:
        t = xh * scale + bias
        dy = dy * (0.5 * (1 + torch.erf(t * 0.5**0.5))
                   + t * torch.exp(-0.5 * t * t) * (2 * torch.pi) ** -0.5)
    return (dy * xh).abs().sum(0), dy.abs().sum(0)


def _cn_bwd_vs_plain(x, g, scale, bias, gelu):
    """The backward kernel against its plain version: dx within the
    forward's tolerance, dscale and dbias within 1e-5 of the sums of their
    terms' magnitudes (fp32 sums over the rows in another order). Returns
    the kernel's outputs."""
    before = channelnorm.bwd_launches
    dx, ds, db = channelnorm.channel_norm_act_bwd(x, g, scale, bias, gelu=gelu)
    torch.cuda.synchronize()
    assert channelnorm.bwd_launches == before + 1 and dx.dtype == x.dtype
    pdx, pds, pdb = channelnorm.channel_norm_act_bwd_plain(x, g, scale, bias, gelu=gelu)
    rtol, atol = CN_TOL[x.dtype]
    torch.testing.assert_close(dx.float(), pdx.float(), rtol=rtol, atol=atol)
    abs_s, abs_b = _cn_abs_terms(x, g, scale, bias, gelu)
    assert bool(((ds - pds).abs() <= 1e-5 * abs_s + 1e-7).all())
    assert bool(((db - pdb).abs() <= 1e-5 * abs_b + 1e-7).all())
    return dx, ds, db


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("rows", [1, 7, 4099, 262_144])
@pytest.mark.parametrize("c", [1, 5, 33, 384, 387, 448, 512, 640, 896, 1024])
def test_channelnorm_bwd_kernel_matches_plain(c, rows, gelu, dtype):
    # every kernel variant's width range, odd and even C, a part tile,
    # a row count that is a multiple of no tile and the training step's
    # largest
    _cn_bwd_vs_plain(*_cn_bwd_inputs(rows, c, dtype, c + rows), gelu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c", [(1001, 387), (1000, 387), (1001, 448), (7, 5)])
def test_channelnorm_bwd_kernel_misaligned_view(rows, c, dtype):
    # x and g one and two elements past a 16-byte boundary, each ending at
    # its allocation's end: every row's edges take the word copies. At an
    # odd element count one of the two ends 2 bytes into a word (bf16),
    # whose copy must stop at the tensor's end. The results equal those of
    # aligned copies bit for bit
    x, g, scale, bias = _cn_bwd_inputs(rows, c, dtype, 4)
    xm = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")[1:].view_as(x)
    gm = torch.empty(g.numel() + 2, dtype=dtype, device="cuda")[2:].view_as(g)
    xm.copy_(x)
    gm.copy_(g)
    assert xm.data_ptr() % 16 and gm.data_ptr() % 16 and xm.is_contiguous()
    got = _cn_bwd_vs_plain(xm, gm, scale, bias, True)
    want = channelnorm.channel_norm_act_bwd(x, g, scale, bias, gelu=True)
    for u, v in zip(got, want):
        assert torch.equal(u, v)


def test_channelnorm_bwd_kernel_repeats_bit_for_bit():
    x, g, scale, bias = _cn_bwd_inputs(262_144, 387, torch.bfloat16, 1)
    a = channelnorm.channel_norm_act_bwd(x, g, scale, bias, gelu=True)
    b = channelnorm.channel_norm_act_bwd(x, g, scale, bias, gelu=True)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_channelnorm_function_takes_non_contiguous_grad():
    # autograd may hand the Function a gradient that is not row-contiguous
    x, g, scale, bias = _cn_bwd_inputs(2 * 9 * 11, 448, torch.float32, 2)
    x = x.reshape(2, 9, 11, 448)
    gt = g.reshape(2, 11, 9, 448).transpose(1, 2)  # the shape of x, not contiguous
    assert not gt.is_contiguous()
    xg, sg, bg = (t.clone().requires_grad_(True) for t in (x, scale, bias))
    channelnorm.channel_norm_act(xg, sg, bg, gelu=True).backward(gt)
    dx, ds, db = channelnorm.channel_norm_act_bwd_plain(x, gt, scale, bias, gelu=True)
    torch.testing.assert_close(xg.grad, dx, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sg.grad, ds, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(bg.grad, db, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_channelnorm_module_launches_both_kernels_under_grad(dtype):
    from nerf_qa_torch.models.nr.layers import ChannelNorm, nchw

    cn = ChannelNorm(387).cuda()
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = nchw(torch.randn(2, 9, 11, 387, generator=gen, device="cuda")).to(dtype)
    dy = nchw(torch.randn(2, 9, 11, 387, generator=gen, device="cuda")).to(dtype)
    grads = []
    for fused in (True, False):
        cn.fused = fused
        cn.zero_grad()
        xg = x.clone().requires_grad_(True)
        before = (channelnorm.launches, channelnorm.bwd_launches)
        cn(xg, gelu=True).backward(dy)
        launched = (channelnorm.launches - before[0], channelnorm.bwd_launches - before[1])
        assert launched == ((1, 1) if fused else (0, 0))
        grads.append((xg.grad.float(), cn.norm.weight.grad.clone(), cn.norm.bias.grad.clone()))
    rtol, atol = CN_TOL[dtype]
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=rtol, atol=atol)
    for a, b in zip(grads[0][1:], grads[1][1:]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_channelnorm_backward_runs_in_its_span(dtype, tmp_path):
    # the backward kernel and its finalize are launched inside the span
    # nr.cn_bwd:<rows>:<c>:<gelu>:<itemsize>, opened on autograd's thread
    import json

    from nerf_qa_torch.models.nr.layers import ChannelNorm, nchw

    cn = ChannelNorm(387).cuda()
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = nchw(torch.randn(2, 9, 11, 387, generator=gen, device="cuda")).to(dtype)
    x.requires_grad_(True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        cn(x, gelu=True).sum().backward()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    size = torch.tensor([], dtype=dtype).element_size()
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("nr.cn_bwd")]
    assert [e["name"] for e in spans] == [f"nr.cn_bwd:{2 * 9 * 11}:387:1:{size}"]
    fwd = [e for e in events if e.get("cat") == "user_annotation"
           and e["name"].startswith("nr.cn:")]
    assert [e["name"] for e in fwd] == [f"nr.cn:{2 * 9 * 11}:387:1:{size}"]
    lo, hi = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    inside = [e["name"] for e in events
              if e.get("cat") == "kernel" and "channel_norm_bwd" in e["name"]
              and lo <= launched.get(e["args"].get("correlation"), -1) <= hi]
    assert len(inside) == 2 and any("finalize" in k for k in inside), inside


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channelnorm_kernels_under_remat(dtype):
    # a v7/v8 decoder with remat on the card (a small one: decoder depths
    # 1 / 2, 16² top grid): each checkpointed RefineUp stage recomputes its
    # ChannelNorm forwards in the backward (17 of the 18, trans2sem's sits
    # outside), the backward launches stay 18, and the losses' decoder
    # gradient equals the plain step's (atol 1e-6 of the largest |grad|:
    # the same arithmetic, cuDNN's backward may sum in another order)
    from nerf_qa_torch.config import NRModelConfig
    from nerf_qa_torch.models.nr.decoder import NRDecoder
    from nerf_qa_torch.models.nr.layers import init_lecun_normal_

    cfg = NRModelConfig(transformer_decoder_depth=1, decoder_dtype=dtype, dropout_rate=0.2)
    dec = init_lecun_normal_(NRDecoder(cfg), torch.Generator().manual_seed(0)).cuda().train()
    g = torch.Generator(device="cuda").manual_seed(1)
    chns = (3, 64, 128, 256, 512, 512)
    sizes = (128, 128, 64, 32, 16, 8)
    feats = [torch.rand((2, s, s, c), generator=g, device="cuda") for s, c in zip(sizes, chns)]
    sem = torch.rand((2, 8, 8, 384), generator=g, device="cuda")
    pyramid = [torch.rand((2, s, s, 384), generator=g, device="cuda")
               for s in (8, 16, 32, 64, 128, 128)]
    drop = torch.Generator(device="cuda").manual_seed(2)
    state = drop.get_state()
    out = {}
    for remat in (False, True):
        dec.cfg = cfg.replace(remat=remat)
        dec.zero_grad(set_to_none=True)
        drop.set_state(state)
        before = (channelnorm.launches, channelnorm.bwd_launches)
        pred, _ = dec(feats, sem, pyramid, drop)
        loss = sum(p.float().square().mean() for p in pred)
        loss.backward()
        torch.cuda.synchronize()
        out[remat] = ((channelnorm.launches - before[0], channelnorm.bwd_launches - before[1]),
                      float(loss), {n: p.grad.clone() for n, p in dec.named_parameters()
                                    if p.grad is not None}, drop.get_state())
    assert out[False][0] == (18, 18)
    assert out[True][0] == (35, 18)
    assert out[True][1] == pytest.approx(out[False][1], rel=1e-6)
    assert torch.equal(out[True][3], out[False][3])
    top = max(float(t.abs().max()) for t in out[False][2].values())
    assert out[True][2].keys() == out[False][2].keys()
    for n, t in out[False][2].items():
        assert float((out[True][2][n] - t).abs().max()) <= 1e-6 * top, n


def _jbu_inputs(shape, dtype, seed=0):
    n, h, w, c = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    hr = torch.randn(shape, generator=g, device="cuda").to(dtype)
    proj = (0.3 * torch.randn((n, h, w, 32), generator=g, device="cuda")).to(dtype)
    offs = torch.linspace(-1, 1, 7, device="cuda")
    sq = (offs[:, None] ** 2 + offs[None, :] ** 2).reshape(-1)
    spatial = torch.exp(-sq / (2 * 0.9**2))
    return hr, proj, spatial, torch.tensor(1.7, device="cuda")


# fp32 accumulation of 49 terms and 32-term dots in other orders
JBU_RTOL, JBU_ATOL = 1e-4, 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 32, 32, 384), (1, 64, 48, 384),
                                   (1, 17, 33, 48), (3, 4, 5, 8), (1, 16, 16, 33)])
def test_jbu_kernel_matches_plain(shape, dtype):
    hr, proj, spatial, temp = _jbu_inputs(shape, dtype)
    before = jbu.launches
    got = jbu.jbu_filter(hr, proj, spatial, temp)
    torch.cuda.synchronize()
    assert jbu.launches == before + 1 and got.dtype == torch.float32
    torch.testing.assert_close(got, jbu.jbu_filter_plain(hr, proj, spatial, temp),
                               rtol=JBU_RTOL, atol=JBU_ATOL)


@pytest.mark.parametrize("c", [5, 33])
def test_jbu_kernel_odd_channel_counts(c):
    # C not a multiple of 4: plain loads into the chunk layout, scalar stores
    hr, proj, spatial, temp = _jbu_inputs((2, 23, 37, c), torch.float32, seed=c)
    assert not jbu._plan(2, 23, 37, c).vec
    torch.testing.assert_close(jbu.jbu_filter(hr, proj, spatial, temp),
                               jbu.jbu_filter_plain(hr, proj, spatial, temp),
                               rtol=JBU_RTOL, atol=JBU_ATOL)


def test_jbu_kernel_misaligned_view():
    # a contiguous view whose data_ptr is one element past a 16-byte boundary
    hr, proj, spatial, temp = _jbu_inputs((1, 20, 24, 64), torch.float32, seed=4)
    base = torch.empty(hr.numel() + 1, device="cuda")
    view = base[1:].view(hr.shape)
    view.copy_(hr)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    torch.testing.assert_close(jbu.jbu_filter(view, proj, spatial, temp),
                               jbu.jbu_filter_plain(hr, proj, spatial, temp),
                               rtol=JBU_RTOL, atol=JBU_ATOL)


def test_jbu_kernel_repeats_bit_for_bit():
    # a split level (channel groups) and an unsplit one
    for shape in [(8, 32, 32, 384), (2, 256, 256, 384)]:
        args = _jbu_inputs(shape, torch.float32, seed=2)
        assert torch.equal(jbu.jbu_filter(*args), jbu.jbu_filter(*args))


def test_kernel_attributes_show_no_spills():
    from nerf_qa_torch.ops.cuda import build

    lib = build.load_library()
    variants = [(lib.nqt_jbu_attrs, args, jbu.BLOCKS_PER_SM)
                for args in ((0, 1), (0, 0), (1, 0))]
    variants += [(lib.nqt_windowed_tsd_attrs, (bf, vec, s), shp.blocks_per_sm)
                 for bf in (0, 1) for vec in (0, 1)
                 for s, shp in enumerate(windowed_tsd.SHAPES)]
    # every ChannelNorm backward variant at its widest C (its grid comes
    # from the occupancy calculator, so only its launch bounds bind it)
    variants += [(lib.nqt_channel_norm_bwd_attrs, (bf, c), 1)
                 for bf in (0, 1) for c in range(32, channelnorm.MAX_CHANNELS + 1, 32)]
    for fn, args, blocks in variants:
        a = build.kernel_attrs(fn, *args)
        assert a["local_bytes"] == 0, (fn.__name__, args, a)
        # the plan's blocks an SM and those the kernel is built for fit its
        # registers and shared memory
        assert a["blocks_per_sm"] >= max(blocks, a["min_blocks_per_sm"]), (
            fn.__name__, args, a)


def test_jbu_module_routes_cuda_tensors_to_the_kernel():
    from nerf_qa_torch.models.nr.featup import JBU

    up = JBU(48).cuda().eval()
    g = torch.Generator(device="cuda").manual_seed(1)
    src = torch.randn((2, 8, 11, 48), generator=g, device="cuda")
    guide = torch.rand((2, 16, 22, 3), generator=g, device="cuda")
    before = jbu.launches
    with torch.no_grad():
        got = up(src, guide)
        assert jbu.launches == before + 1
        up.fused = False
        want = up(src, guide)
    assert jbu.launches == before + 1
    torch.testing.assert_close(got, want, rtol=JBU_RTOL, atol=JBU_ATOL)


def test_jbu_kernel_rejects_grad_and_bad_shapes():
    hr, proj, spatial, temp = _jbu_inputs((1, 8, 8, 16), torch.float32)
    with pytest.raises(RuntimeError, match="no backward"):
        jbu.jbu_filter(hr.clone().requires_grad_(True), proj, spatial, temp)
    with pytest.raises(ValueError):
        jbu.jbu_filter(hr, proj[..., :16].contiguous(), spatial, temp)  # K != 32
    with pytest.raises(ValueError):
        jbu.jbu_filter(hr[:, :3, :3].contiguous(), proj[:, :3, :3].contiguous(),
                       spatial, temp)  # H, W <= radius
    with pytest.raises(ValueError):
        jbu.jbu_filter(hr.transpose(1, 2), proj.transpose(1, 2), spatial, temp)


def _tsd_inputs(shape, dtype, seed=0, ps_value=None, scaled=True):
    n, h, w, c = shape
    fx, fy = _pair(shape, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    ps = torch.rand((n, h - 20, w - 20), generator=g, device="cuda")
    if ps_value is not None:
        ps.fill_(ps_value)
    weights = torch.rand((n, c), generator=g, device="cuda")
    weights /= weights.sum(1, keepdim=True)
    kw = {}
    if scaled:
        kw = {k: 1 / f.float().square().sum((1, 2)).sqrt().clamp_min(1e-12)
              for k, f in (("inv_x", fx), ("inv_y", fy))}
    return (fx, fy, ps, weights), kw


def _assert_rel(got, want, rtol=1e-4):
    # fp32 window sums in other orders: 1e-4 of the map's largest value
    err = float((got.double() - want.double()).abs().max())
    assert err <= rtol * float(want.abs().max()), err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [
    (2, 256, 256, 3), (2, 256, 256, 64), (2, 128, 128, 128), (2, 64, 64, 256),
    (2, 32, 32, 512), (1, 1080, 1920, 3), (1, 540, 960, 128),
    (1, 135, 240, 512), (1, 67, 120, 512), (1, 21, 21, 3), (2, 37, 53, 5),
    (1, 40, 1920, 8),
])
def test_tsd_kernel_matches_plain(shape, dtype):
    args, kw = _tsd_inputs(shape, dtype)
    before = windowed_tsd.launches
    got = windowed_tsd.windowed_tsd(*args, **kw)
    torch.cuda.synchronize()
    assert windowed_tsd.launches == before + 1
    assert got.shape == (shape[0], shape[1] - 20, shape[2] - 20)
    _assert_rel(got, windowed_tsd.windowed_tsd_plain(*args, **kw))


@pytest.mark.parametrize("case", ["ps0", "ps1", "unscaled", "zero_channel"])
def test_tsd_kernel_edge_cases(case):
    args, kw = _tsd_inputs((2, 45, 70, 12), torch.float32,
                           ps_value={"ps0": 0.0, "ps1": 1.0}.get(case),
                           scaled=case != "unscaled")
    if case == "zero_channel":
        fx = args[0].clone()
        fx[..., 3] = 0
        args = (fx, *args[1:])
        kw["inv_x"] = 1 / fx.square().sum((1, 2)).sqrt().clamp_min(1e-12)
    got = windowed_tsd.windowed_tsd(*args, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    _assert_rel(got, windowed_tsd.windowed_tsd_plain(*args, **kw))


def test_tsd_kernel_repeats_bit_for_bit():
    args, kw = _tsd_inputs((2, 100, 150, 40), torch.bfloat16)
    assert torch.equal(windowed_tsd.windowed_tsd(*args, **kw),
                       windowed_tsd.windowed_tsd(*args, **kw))
    # split channels: the partial maps are added in group order
    args, kw = _tsd_inputs((1, 67, 120, 512), torch.bfloat16)
    assert windowed_tsd._plan(1, 67, 120, 512).groups > 1
    assert torch.equal(windowed_tsd.windowed_tsd(*args, **kw),
                       windowed_tsd.windowed_tsd(*args, **kw))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 32, 32, 512), (1, 67, 120, 512),
                                   (2, 135, 240, 512), (16, 32, 32, 512)])
def test_tsd_kernel_channel_split_stages(shape, dtype):
    assert windowed_tsd._plan(*shape, dtype).groups > 1
    args, kw = _tsd_inputs(shape, dtype, seed=3)
    _assert_rel(windowed_tsd.windowed_tsd(*args, **kw),
                windowed_tsd.windowed_tsd_plain(*args, **kw))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [3, 5, 12])
def test_tsd_kernel_odd_channel_counts(c, dtype):
    args, kw = _tsd_inputs((2, 45, 130, c), dtype, seed=c)
    _assert_rel(windowed_tsd.windowed_tsd(*args, **kw),
                windowed_tsd.windowed_tsd_plain(*args, **kw))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tsd_kernel_misaligned_view(dtype):
    # C = 64 would take 16-byte copies; a view one element past a 16-byte
    # boundary takes the plain-load path
    args, kw = _tsd_inputs((2, 40, 60, 64), dtype, seed=5)
    fx = args[0]
    base = torch.empty(fx.numel() + 1, dtype=dtype, device="cuda")
    view = base[1:].view(fx.shape)
    view.copy_(fx)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    _assert_rel(windowed_tsd.windowed_tsd(view, *args[1:], **kw),
                windowed_tsd.windowed_tsd_plain(*args, **kw))


def test_tsd_kernel_rejects_grad_layout_and_small_stages():
    (fx, fy, ps, w), kw = _tsd_inputs((1, 30, 30, 8), torch.float32)
    with pytest.raises(RuntimeError, match="no backward"):
        windowed_tsd.windowed_tsd(fx.clone().requires_grad_(True), fy, ps, w)
    with pytest.raises(ValueError, match="contiguous"):
        windowed_tsd.windowed_tsd(fx.transpose(1, 2), fy.transpose(1, 2), ps, w)
    with pytest.raises(ValueError, match="window"):
        windowed_tsd.windowed_tsd(fx[:, :20].contiguous(), fy[:, :20].contiguous(),
                                  ps, w)
    with pytest.raises(ValueError, match="window"):
        windowed_tsd.windowed_tsd(fx, fy, torch.zeros((1, 20, 20), device="cuda"), w,
                                  window_size=11)


def test_adists_forward_on_the_card_launches_the_kernel():
    from nerf_qa_torch.compat.pretrained import resolve_vgg_params
    from nerf_qa_torch.config import ADISTSConfig
    from nerf_qa_torch.core import adists

    model = resolve_vgg_params(seed=0).cuda()
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.rand((2, 64, 64, 3), generator=g, device="cuda")
    y = (x + 0.1 * torch.rand(x.shape, generator=g, device="cuda")).clamp(0, 1)
    cfg = ADISTSConfig(compute_dtype="bfloat16")
    before = windowed_tsd.launches
    with torch.no_grad():
        got = adists.forward(model, x, y, cfg, as_loss=False)
        assert windowed_tsd.launches == before + 3  # stages 0-2 fit at 64²
        want = adists.forward(model, x, y, cfg.replace(fused_tsd=False), as_loss=False)
    assert windowed_tsd.launches == before + 3
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_default_frame_scorer_launches_the_moments_kernel():
    from nerf_qa_torch.compat.pretrained import resolve_dists_weights, resolve_vgg_params
    from nerf_qa_torch.config import DISTSConfig
    from nerf_qa_torch.eval.video_scorer import FrameScorer

    scorer = FrameScorer(resolve_vgg_params(seed=0),
                         resolve_dists_weights(DISTSConfig()))
    frames = torch.randint(0, 256, (2, 90, 120, 3), dtype=torch.uint8, device="cuda")
    before = moments.launches
    scores = scorer.score_frames(frames, frames.flip(0), batch_size=2)
    assert moments.launches == before + 6
    assert scores.shape == (2,)


# ---- the VGG epilogues (csrc/vgg_epilogue.cu): bit for bit against plain

# output channels of the pyramid's 13 convolutions
VGG_CONV_WIDTHS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
SPECIALS = (float("nan"), float("inf"), float("-inf"), -0.0, 0.0, 1e-39, -1e-39,
            1e-40, -1e-44, 3e-38, -3e-38, 1.0, -1.0, 0.5, -2.75, 1e38, -3e38,
            -1e-12, -1e-13, 1e-30)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _assert_bits(got: torch.Tensor, want: torch.Tensor, strides: bool = True) -> None:
    assert got.shape == want.shape and (got.stride() == want.stride() or not strides)
    diff = _bits(got) != _bits(want)
    if bool(diff.any()):
        i = int(diff.flatten().nonzero()[0])
        raise AssertionError(f"{int(diff.sum())} values differ; first "
                             f"{got.flatten()[i].item()} vs {want.flatten()[i].item()}")


def _conv_out(shape, dtype, seed=0, channels_last=True):
    g = torch.Generator(device="cuda").manual_seed(seed)
    y = torch.randn(shape, generator=g, device="cuda").to(dtype)
    return y.contiguous(memory_format=torch.channels_last) if channels_last else y


def _bias_relu_both(y, b, square):
    want = vgg_epilogue.bias_relu_plain(y.clone(), b, square=square)
    before = vgg_epilogue.launches
    got = vgg_epilogue.bias_relu(y, b, square=square)
    torch.cuda.synchronize()
    assert vgg_epilogue.launches == before + 1
    return got, want


@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("conv", range(len(VGG_CONV_WIDTHS)))
def test_bias_relu_matches_plain_bit_for_bit(conv, dtype, square):
    c = VGG_CONV_WIDTHS[conv]
    y = _conv_out((2, c, 11, 17), dtype, seed=conv)
    b = 0.5 * torch.randn(c, device="cuda")
    got, want = _bias_relu_both(y, b, square)
    if square:
        _assert_bits(got[0], want[0])
        _assert_bits(got[1], want[1])
        assert got[0].data_ptr() == y.data_ptr()  # in place
    else:
        _assert_bits(got, want)
        assert got.data_ptr() == y.data_ptr()


@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 64, 9, 16), (1, 3, 5, 7), (2, 12, 3, 5)])
def test_bias_relu_nchw_and_odd_widths(shape, dtype, square):
    """NCHW maps (ST-LPIPS's blur pool hands the conv one) take the plane
    path; widths that are no multiple of the vector take scalar accesses."""
    for channels_last in (False, True):
        y = _conv_out(shape, dtype, channels_last=channels_last)
        b = torch.randn(shape[1], device="cuda")
        got, want = _bias_relu_both(y, b, square)
        for g, w in zip(got if square else (got,), want if square else (want,)):
            _assert_bits(g, w)


@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bias_relu_special_values(dtype, square):
    vals = torch.tensor(SPECIALS, device="cuda").to(dtype)
    n = len(SPECIALS)
    # every value of y (one a row) against every value of the bias
    y = vals.view(n, 1).repeat(1, 64).view(n, 64, 1, 1)
    b = torch.cat([vals, vals.flip(0), vals, vals.flip(0)])[:64]
    got, want = _bias_relu_both(y, b, square)
    for g, w in zip(got if square else (got,), want if square else (want,)):
        _assert_bits(g, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bias_relu_unaligned_view(dtype):
    shape = (2, 64, 7, 9)
    base = torch.randn(1 + 2 * 64 * 7 * 9, device="cuda").to(dtype)
    y = base[1:].view(2, 7, 9, 64).permute(0, 3, 1, 2)  # channels_last, 2/4-byte offset
    assert y.is_contiguous(memory_format=torch.channels_last) and y.data_ptr() % 16
    assert vgg_epilogue.bias_relu_plan(y.numel(), 64, 1, y.element_size(), False, 132).vec == 1
    b = torch.randn(64, device="cuda")
    got, want = _bias_relu_both(y, b, True)
    _assert_bits(got[0], want[0])
    _assert_bits(got[1], want[1])
    assert got[0].shape == shape


def test_epilogues_above_2_31_elements():
    """64-bit offsets: a bf16 channels_last map of 2.15 G values (~4.3 GB)."""
    shape = (1, 64, 5800, 5800)
    assert 64 * 5800 * 5800 > 2**31
    y = torch.empty(shape, dtype=torch.bfloat16, device="cuda",
                    memory_format=torch.channels_last).normal_()
    b = torch.randn(64, device="cuda")
    got, want = _bias_relu_both(y, b, True)
    _assert_bits(got[0], want[0])
    _assert_bits(got[1], want[1])
    del want
    p = got[1]
    want = vgg_epilogue.pool_root_plain(p.clone())
    _assert_bits(vgg_epilogue.pool_root(p), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 64, 540, 960), (2, 128, 270, 480), (2, 256, 135, 240),
                                   (2, 512, 68, 120), (2, 512, 5, 7), (1, 3, 5, 7)])
def test_pool_root_matches_plain_bit_for_bit(shape, dtype):
    for channels_last in (True, False):
        p = _conv_out(shape, dtype, channels_last=channels_last).abs_()
        p[0, 0, 0] = 0.0
        want = vgg_epilogue.pool_root_plain(p.clone())
        before = vgg_epilogue.launches
        got = vgg_epilogue.pool_root(p)
        torch.cuda.synchronize()
        assert vgg_epilogue.launches == before + 1 and got.data_ptr() == p.data_ptr()
        _assert_bits(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pool_root_special_values_and_unaligned_view(dtype):
    vals = torch.tensor(SPECIALS, device="cuda").to(dtype)
    p = vals.repeat(7).view(1, 1, 7, len(SPECIALS))
    _assert_bits(vgg_epilogue.pool_root(p.clone()), vgg_epilogue.pool_root_plain(p.clone()))
    base = torch.rand(1 + 2 * 64 * 5 * 6, device="cuda").to(dtype)
    q = base[1:].view(2, 64, 5, 6)
    assert q.data_ptr() % 16
    want = vgg_epilogue.pool_root_plain(q.clone())
    _assert_bits(vgg_epilogue.pool_root(q), want)


def _plain_pyramid(monkeypatch, model, x, dtype):
    with monkeypatch.context() as m:
        m.setattr(vgg_epilogue, "bias_relu", vgg_epilogue.bias_relu_plain)
        m.setattr(vgg_epilogue, "pool_root", vgg_epilogue.pool_root_plain)
        before = vgg_epilogue.launches
        feats = model(x, dtype)
        assert vgg_epilogue.launches == before
    return feats


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pyramid_at_1080p_matches_the_plain_path_bit_for_bit(dtype, monkeypatch):
    from nerf_qa_torch.core.vgg import VGG16Pyramid, init_he_normal

    gen = torch.Generator().manual_seed(0)
    model = init_he_normal(VGG16Pyramid(), gen)
    with torch.no_grad():
        for name, t in model.named_parameters():
            if name.endswith("bias"):
                t.copy_(0.05 * torch.randn(t.shape, generator=gen))
    model = model.cuda()
    x = torch.rand((2, 1080, 1920, 3), generator=torch.Generator(device="cuda").manual_seed(1),
                   device="cuda")  # one pair through one pyramid forward
    with torch.no_grad():
        want = _plain_pyramid(monkeypatch, model, x, dtype)
        before = vgg_epilogue.launches
        got = model(x, dtype)
        torch.cuda.synchronize()
    assert vgg_epilogue.launches == before + 17
    for g, w in zip(got, want):
        _assert_bits(g, w)


@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_epilogue_backward_matches_pytorch(dtype, square):
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((2, 64, 9, 10), generator=g, device="cuda").to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    b = torch.randn(64, generator=g, device="cuda")
    cot = torch.randn((2, 64, 9, 10), generator=g, device="cuda").to(dtype)

    if square:  # under autograd the caller makes the squares
        with pytest.raises(RuntimeError, match="recorded gradient"):
            vgg_epilogue.bias_relu(x.clone().requires_grad_(True) * 1, b, square=True)

    def run(relu, root):
        leaf = x.clone().requires_grad_(True)
        h = relu(leaf * 1, b)
        sq = h * h if square else None
        p = root(h * 1 + 0.25)
        loss = (p * cot).sum() + (0 if sq is None else (sq * cot).sum())
        (grad,) = torch.autograd.grad(loss, leaf)
        return p.detach(), grad

    before = vgg_epilogue.launches
    got = run(vgg_epilogue.bias_relu, vgg_epilogue.pool_root)
    assert vgg_epilogue.launches == before + 2
    want = run(vgg_epilogue.bias_relu_plain, lambda p: vgg_epilogue.pool_root_plain(p))
    _assert_bits(got[0], want[0])
    _assert_bits(got[1], want[1], strides=False)  # autograd picks the layout


def test_bias_relu_rejects_a_bias_that_requires_grad_and_strided_maps():
    y = torch.randn((1, 8, 4, 4), device="cuda")
    with pytest.raises(RuntimeError, match="requires grad"):
        vgg_epilogue.bias_relu(y, torch.zeros(8, device="cuda", requires_grad=True))
    with pytest.raises(ValueError, match="contiguous"):
        vgg_epilogue.bias_relu(y[:, :, ::2], torch.zeros(8, device="cuda"))


def _seeded_vgg():
    from nerf_qa_torch.core.vgg import VGG16Pyramid, init_he_normal

    gen = torch.Generator().manual_seed(0)
    model = init_he_normal(VGG16Pyramid(), gen)
    with torch.no_grad():
        for name, t in model.named_parameters():
            if name.endswith("bias"):
                t.copy_(0.05 * torch.randn(t.shape, generator=gen))
    return model.cuda()


def _kernel_and_plain(monkeypatch, run):
    """``run()`` through the kernels, then through the plain versions;
    returns both results and the kernels' launches."""
    before = vgg_epilogue.launches
    got = run()
    torch.cuda.synchronize()
    launched = vgg_epilogue.launches - before
    with monkeypatch.context() as m:
        m.setattr(vgg_epilogue, "bias_relu", vgg_epilogue.bias_relu_plain)
        m.setattr(vgg_epilogue, "pool_root", vgg_epilogue.pool_root_plain)
        want = run()
    return got, want, launched


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_spatial_pyramid_takes_the_kernel_bit_for_bit(dtype, monkeypatch):
    """parallel/spatial over four H-slabs of one card: the conv outputs of
    the haloed slabs and the pools of the haloed squares go through the
    kernel (17 launches a slab) and give the plain ops' bits; the DISTS
    and ADISTS scores over the mesh equal the plain path's."""
    from nerf_qa_torch.config import ADISTSConfig, DISTSConfig, true_fp32
    from nerf_qa_torch.core import dists
    from nerf_qa_torch.parallel import spatial
    from nerf_qa_torch.parallel.mesh import create_mesh, replicate

    model = _seeded_vgg()
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.rand((2, 256, 96, 3), generator=g, device="cuda")
    y = (x + 0.05 * torch.randn(x.shape, generator=g, device="cuda")).clamp(0, 1)
    mesh = create_mesh([torch.device("cuda", 0)] * 4, model_parallel=4)
    models = replicate(mesh, model)
    slabs = list(x.chunk(4, dim=1))
    name = "float32" if dtype == torch.float32 else "bfloat16"
    w = dists.load_pretrained_weights().to("cuda")
    precision = true_fp32 if dtype == torch.float32 else contextlib.nullcontext
    with torch.no_grad(), precision():
        got, want, launched = _kernel_and_plain(
            monkeypatch, lambda: spatial._pyramid_spatial([model] * 4, slabs, dtype))
        assert launched == 17 * 4
        for slab_got, slab_want in zip(got, want):
            for a, b in zip(slab_got, slab_want):
                _assert_bits(a, b)
        got, want, launched = _kernel_and_plain(monkeypatch, lambda: spatial.spatial_dists_forward(
            models, w, x, y, mesh, DISTSConfig(compute_dtype=name)))
        assert launched == 17 * 4 and torch.equal(got, want)
        got, want, launched = _kernel_and_plain(monkeypatch, lambda: spatial.spatial_adists_forward(
            models, x, y, mesh, ADISTSConfig(compute_dtype=name), as_loss=False))
        assert launched == 17 * 4 and torch.equal(got, want)


def test_iqa_vgg_takes_the_kernel_bit_for_bit(monkeypatch):
    """eval/iqa's fp32 VGG, behind LPIPS's max pools (channels_last maps)
    and ST-LPIPS's blur pools (NCHW maps after the first stage, the plane
    path): 13 bias-ReLU launches a pyramid, and the features and scores
    are the plain ops'."""
    from nerf_qa_torch.config import true_fp32
    from nerf_qa_torch.eval import iqa

    model = _seeded_vgg()
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.rand((2, 96, 128, 3), generator=g, device="cuda")
    y = (x + 0.05 * torch.randn(x.shape, generator=g, device="cuda")).clamp(0, 1)
    with torch.no_grad(), true_fp32():
        for pyramid, score in ((iqa._lpips_pyramid, iqa.lpips),
                               (iqa._st_lpips_pyramid, iqa.st_lpips)):
            got, want, launched = _kernel_and_plain(monkeypatch, lambda: pyramid(model, x))
            assert launched == 13
            for a, b in zip(got, want):
                _assert_bits(a, b)
            got, want, launched = _kernel_and_plain(monkeypatch, lambda: score(model, x, y))
            assert launched == 2 * 13 and torch.equal(got, want)
