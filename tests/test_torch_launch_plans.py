"""Launch plans of the port's JBU, windowed T/S, windowed γ, ChannelNorm
backward and VGG epilogue kernels, on the CPU.

The plans are plain Python (tiles, channel groups, copy path, grid); the
kernels that run them need the card (tests/test_torch_kernels.py). Each
plan must cover every output pixel (or row) exactly once, partition the
channels, and stay within the grid's limits. The shared-memory sizes live only in the kernel
sources, held by their static_asserts, and the card's test reads them
(test_kernel_attributes_show_no_spills).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from nerf_qa_torch.ops.cuda import build, channelnorm as cn, jbu, vgg_epilogue as ve, windowed_tsd as tsd
from nerf_qa_torch.ops.cuda import windowed_gamma as wg
from nerf_qa_torch.ops.windowed import gaussian_taps

GRID_X_MAX = 2**31 - 1
GRID_YZ_MAX = 65535

# the ADISTS paths' stage shapes (256² at batch 128, 1080p at batch 2) and
# edge shapes
TSD_SHAPES = [
    (128, 256, 256, 3), (128, 256, 256, 64), (128, 128, 128, 128),
    (128, 64, 64, 256), (128, 32, 32, 512), (2, 1080, 1920, 3),
    (2, 1080, 1920, 64), (2, 540, 960, 128), (2, 270, 480, 256),
    (2, 135, 240, 512), (2, 68, 120, 512), (1, 21, 21, 3), (2, 37, 53, 5),
    (1, 40, 1920, 8), (2, 45, 70, 12), (2, 32, 32, 512), (1, 67, 120, 512),
    (3, 150, 64, 7), (65535, 21, 30, 4),
]


def _groups(c, groups, cg):
    return [(g * cg, min(c, g * cg + cg)) for g in range(groups)]


def _assert_partition(c, groups, cg, unit):
    ranges = _groups(c, groups, cg)
    assert cg % unit == 0
    assert all(lo < hi for lo, hi in ranges)
    assert ranges[0][0] == 0 and ranges[-1][1] == c
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("forced", [None, 0, tsd.NARROW])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", TSD_SHAPES)
def test_tsd_plan_covers_each_output_once(shape, dtype, forced):
    n, h, w, c = shape
    hk, wk = h - 20, w - 20
    plan = tsd._plan(n, h, w, c, dtype, shape=forced)
    assert forced is None or plan.shape == forced
    shp = tsd.SHAPES[plan.shape]
    assert 1 <= plan.tw <= shp.tw_max
    cover = torch.zeros((hk, wk), dtype=torch.int32)
    for r in range(plan.tiles_h):
        for q in range(plan.tiles_w):
            cover[r * tsd.TILE_H:(r + 1) * tsd.TILE_H, q * plan.tw:(q + 1) * plan.tw] += 1
    assert bool((cover == 1).all())
    # no tile lies wholly past the map
    assert (plan.tiles_h - 1) * tsd.TILE_H < hk and (plan.tiles_w - 1) * plan.tw < wk
    _assert_partition(c, plan.groups, plan.cg, plan.ccb)
    assert plan.tiles_h * plan.tiles_w <= GRID_X_MAX
    assert n <= GRID_YZ_MAX and plan.groups <= GRID_YZ_MAX


@pytest.mark.parametrize("dtype,c,aligned,vec,ccb", [
    (torch.bfloat16, 64, True, True, 8), (torch.bfloat16, 12, True, False, 4),
    (torch.bfloat16, 64, False, False, 4), (torch.float32, 12, True, True, 4),
    (torch.float32, 3, True, False, 4), (torch.float32, 64, False, False, 4),
    (torch.bfloat16, 3, True, False, 4),
])
def test_tsd_plan_copy_path(dtype, c, aligned, vec, ccb):
    plan = tsd._plan(2, 80, 90, c, dtype, aligned)
    assert (plan.vec, plan.ccb) == (vec, ccb)


def test_tsd_plan_shapes_and_channel_split():
    # narrow stages take the narrow shape; a stage with fewer than two waves
    # of blocks splits its channels, the 256² stages 0-2 and 1080p stages
    # 0-3 do not
    small = tsd._plan(128, 32, 32, 512)
    assert small.shape == tsd.NARROW and small.groups > 1
    assert tsd._plan(128, 64, 64, 256).shape == tsd.NARROW
    assert tsd._plan(2, 68, 120, 512).groups > 1
    for shape in [(128, 256, 256, 64), (128, 128, 128, 128), (2, 1080, 1920, 64),
                  (2, 270, 480, 256)]:
        plan = tsd._plan(*shape)
        assert plan.shape == 0 and plan.groups == 1
    # more SMs, more groups
    assert tsd._plan(2, 68, 120, 512, sms=264).groups >= tsd._plan(2, 68, 120, 512).groups


def test_tsd_taps_are_built_once():
    a = tsd._taps_array()
    assert tsd._taps_array() is a
    assert list(a) == pytest.approx(list(gaussian_taps(21, 7.0)), rel=1e-7)


# ---- the windowed γ sum (csrc/windowed_gamma.cu): the blocked stages of
# the 1080p path at batch 8, spatial ADISTS's slabs, edge shapes

GAMMA_SHAPES = [
    (8, 1080, 1920, 3), (8, 1080, 1920, 64), (8, 540, 960, 128),
    (16, 256, 256, 64), (2, 272, 480, 256), (1, 68, 120, 512), (1, 21, 21, 3),
    (2, 37, 53, 5), (1, 40, 1920, 8), (3, 150, 64, 7), (65535, 21, 30, 4),
]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", GAMMA_SHAPES)
def test_gamma_plan_covers_each_output_once(shape, dtype, aligned):
    n, h, w, c = shape
    hk, wk = h - 20, w - 20
    plan = wg._plan(n, h, w, c, dtype, aligned)
    assert 1 <= plan.tw <= wg.TW_MAX
    cover = torch.zeros((hk, wk), dtype=torch.int32)
    for r in range(plan.tiles_h):
        for q in range(plan.tiles_w):
            cover[r * wg.TILE_H:(r + 1) * wg.TILE_H, q * plan.tw:(q + 1) * plan.tw] += 1
    assert bool((cover == 1).all())
    assert (plan.tiles_h - 1) * wg.TILE_H < hk and (plan.tiles_w - 1) * plan.tw < wk
    _assert_partition(c, plan.groups, plan.cg, plan.ccb)
    vec_c = 8 if dtype == torch.bfloat16 else 4
    assert plan.vec == (aligned and c % vec_c == 0)
    assert plan.ccb == (vec_c if plan.vec else wg.LANES)
    assert plan.tiles_h * plan.tiles_w <= GRID_X_MAX
    assert n <= GRID_YZ_MAX and plan.groups <= GRID_YZ_MAX


@pytest.mark.parametrize("shape,plan", [
    # 1080p stage 0: bf16 image channels, plain loads, 19,152 blocks
    ((8, 1080, 1920, 3), wg.Plan(106, 18, 133, 1, 4, 4, False)),
    # stage 1 and 2: 16-byte copies of 8 bf16 channels, no split
    ((8, 1080, 1920, 64), wg.Plan(106, 18, 133, 1, 64, 8, True)),
    ((8, 540, 960, 128), wg.Plan(105, 9, 65, 1, 128, 8, True)),
    # a 256² stage 1 at batch 16 (not blocked at the default threshold)
    ((16, 256, 256, 64), wg.Plan(79, 3, 30, 1, 64, 8, True)),
])
def test_gamma_plan_at_the_path_shapes(shape, plan):
    got = wg._plan(*shape)
    assert got == plan
    assert got.tiles_w * got.tiles_h * shape[0] >= 2 * wg.BLOCKS_PER_SM * 132


def test_gamma_plan_splits_small_stages_only():
    # a spatial slab's coarsest windowed stage gives 6 blocks: its channels
    # split into groups of 8 until two waves fill 132 SMs
    small = wg._plan(1, 68, 120, 512)
    assert small.groups == 64 and small.cg == 8
    assert wg._plan(1, 68, 120, 512, torch.float32).groups == 64
    mid = wg._plan(2, 135, 240, 512)  # 90 blocks
    assert mid.groups == 6 and mid.cg == 88
    assert wg._plan(2, 135, 240, 512, sms=264).groups >= mid.groups
    assert wg._plan(1, 21, 21, 3).groups == 1  # one chunk cannot split


def test_gamma_taps_are_built_once():
    a = wg._taps_array()
    assert wg._taps_array() is a
    assert list(a) == pytest.approx(list(gaussian_taps(21, 7.0)), rel=1e-7)


JBU_SHAPES = [(8, 32, 32, 384), (8, 64, 64, 384), (8, 128, 128, 384),
              (8, 256, 256, 384), (4, 256, 256, 384), (1, 17, 33, 48),
              (3, 4, 5, 8), (1, 16, 16, 33), (1, 9, 7, 5), (65535, 4, 4, 64),
              (2, 300, 20, 1)]


@pytest.mark.parametrize("shape", JBU_SHAPES)
def test_jbu_plan_covers_each_output_once(shape):
    n, h, w, c = shape
    plan = jbu._plan(n, h, w, c)
    assert (plan.tiles_w - 1) * jbu.TILE < w <= plan.tiles_w * jbu.TILE
    assert (plan.tiles_h - 1) * jbu.TILE < h <= plan.tiles_h * jbu.TILE
    _assert_partition(c, plan.groups, plan.cg, jbu.CHUNK)
    assert plan.tiles_w <= GRID_X_MAX and plan.tiles_h <= GRID_YZ_MAX
    assert n * plan.groups <= GRID_YZ_MAX


def test_jbu_plan_splits_small_levels_only():
    # batch 8: the 32² and 64² levels fill less than a wave and split their
    # channels within one wave; 128² and 256² do not split
    groups = [jbu._plan(8, s, s, 384).groups for s in (32, 64, 128, 256)]
    assert groups[0] > groups[1] > 1 and groups[2] == groups[3] == 1
    for s, g in zip((32, 64), groups):
        blocks = (-(-s // jbu.TILE)) ** 2 * 8 * g
        assert blocks <= jbu.BLOCKS_PER_SM * 132


@pytest.mark.parametrize("dtype,c,aligned,vec", [
    (torch.float32, 384, True, True), (torch.float32, 33, True, False),
    (torch.float32, 384, False, False), (torch.bfloat16, 384, True, False),
])
def test_jbu_plan_copy_path(dtype, c, aligned, vec):
    assert jbu._plan(2, 40, 40, c, dtype, aligned).vec is vec


# the NR training step's backward calls (rows at batch 4) and edge shapes
CN_BWD_SHAPES = [(1024, 384), (1024, 896), (4096, 896), (16384, 640),
                 (65536, 512), (262_144, 448), (262_144, 387), (1, 1),
                 (7, 5), (8, 33), (9, 1024), (4099, 387), (33, 448)]


@pytest.mark.parametrize("blocks_per_sm", [1, 2])
@pytest.mark.parametrize("rows,c", CN_BWD_SHAPES)
def test_cn_bwd_plan_covers_each_row_once(rows, c, blocks_per_sm):
    plan = cn._bwd_plan(rows, c, 132, blocks_per_sm)
    warps = plan.blocks * cn.BWD_WARPS
    cover = torch.zeros(rows, dtype=torch.int32)
    for w in range(warps):  # warp w of the grid: rows w, w + warps, ...
        cover[w::warps] += 1
    assert bool((cover == 1).all())
    assert plan.blocks == 1 or (plan.blocks - 1) * cn.BWD_WARPS < rows  # no idle block
    # at most one resident wave; partial buffer of one (2, C) a block
    assert plan.blocks <= blocks_per_sm * 132
    assert plan.partial == (plan.blocks, 2, c)


def test_cn_bwd_plan_sizes_the_grid_to_the_call():
    # small calls take few blocks (at least BWD_MIN_ROWS rows a warp), the
    # 16,384-row and larger calls one full wave
    assert cn._bwd_plan(1, 384, 132, 2).blocks == 1
    assert cn._bwd_plan(1024, 896, 132, 2).blocks == 1024 // (8 * cn.BWD_MIN_ROWS)
    assert cn._bwd_plan(4096, 896, 132, 2).blocks == 4096 // (8 * cn.BWD_MIN_ROWS)
    assert cn._bwd_plan(4096, 896, 132, 1).blocks == 132
    for rows in (16384, 65536, 262_144):
        assert cn._bwd_plan(rows, 448, 132, 2).blocks == 264
    assert cn._bwd_plan(262_144, 448, 264, 2).blocks == 528


def test_sm_count_is_read_once_per_device(monkeypatch):
    calls = []

    def props(device):
        calls.append(device)
        return SimpleNamespace(multi_processor_count=132)

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    build.sm_count.cache_clear()
    try:
        for _ in range(3):
            assert build.sm_count(torch.device("cuda", 0)) == 132
        assert build.sm_count(torch.device("cuda", 1)) == 132
        assert calls == [torch.device("cuda", 0), torch.device("cuda", 1)]
    finally:
        build.sm_count.cache_clear()


# ---- the VGG epilogues (csrc/vgg_epilogue.cu)

EPILOGUE_SHAPES = [(2, 64, 9, 13), (1, 3, 5, 7), (3, 12, 4, 4), (2, 512, 3, 5),
                   (1, 256, 1, 1), (2, 20, 3, 3), (1, 8, 2, 2)]


def _epilogue_cover(plan, numel, *, c=None, inner=None):
    """Walk the kernel's grid-stride loop (thread t takes vectors t, t +
    stride, ...) and return how often each value is touched. With ``c``
    (the row path) check that a thread keeps its channels; with ``inner``
    (the plane path) that a vector stays inside one channel plane."""
    stride = plan.blocks * ve.THREADS
    nvec = numel // plan.vec
    count = np.zeros(numel, dtype=np.int64)
    for t in range(min(stride, nvec)):
        idx = np.arange(t, nvec, stride)[:, None] * plan.vec + np.arange(plan.vec)
        count[idx.ravel()] += 1
        if c is not None:
            assert (idx % c == (t % plan.row_vecs) * plan.vec + np.arange(plan.vec)).all()
        if inner is not None:
            assert (idx // inner == idx[:, :1] // inner).all()
    return count


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", EPILOGUE_SHAPES)
def test_vgg_epilogue_plan_covers_each_value_once(shape, dtype, layout, aligned):
    n, c, h, w = shape
    numel = n * c * h * w
    itemsize = torch.empty((), dtype=dtype).element_size()
    inner = 1 if layout == "channels_last" else h * w
    plan = ve.bias_relu_plan(numel, c, inner, itemsize, aligned, 4)
    run = c if inner == 1 else inner
    full = 16 // itemsize
    # the scalar path exactly where the pointer is unaligned or a vector
    # would cross a channel's run
    assert plan.vec == (full if aligned and run % full == 0 else 1)
    assert 1 <= plan.blocks <= GRID_X_MAX
    assert (plan.blocks * ve.THREADS) % plan.row_vecs == 0
    if inner == 1:
        count = _epilogue_cover(plan, numel, c=c)
    else:
        count = _epilogue_cover(plan, numel, inner=inner)
    assert (count == 1).all()
    pool = ve.pool_root_plan(numel, itemsize, aligned, 4)
    assert pool.vec == (full if aligned and numel % full == 0 else 1)
    assert (_epilogue_cover(pool, numel) == 1).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_vgg_epilogue_plan_at_the_pyramid_shapes(dtype):
    """A 1080p batch of 8 pairs (16 images) on 132 SMs: every call takes
    16-byte accesses, the grid fills the card once and its stride keeps
    each thread on its channels; stage 1 passes 2**31 values."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    hw = [(1080, 1920), (540, 960), (270, 480), (135, 240), (68, 120)]
    widths = [64, 128, 256, 512, 512]
    assert 16 * 64 * 1080 * 1920 < 2**31 < 2 * 16 * 64 * 1080 * 1920
    for (h, w), c in zip(hw, widths):
        numel = 16 * c * h * w
        plan = ve.bias_relu_plan(numel, c, 1, itemsize, True, 132)
        assert plan.vec == 16 // itemsize and plan.row_vecs == c // plan.vec
        assert plan.blocks == 132 * ve.BLOCKS_PER_SM
        assert (plan.blocks * ve.THREADS) % plan.row_vecs == 0
        pool = ve.pool_root_plan(numel // 4, itemsize, True, 132)
        assert pool.vec == 16 // itemsize and pool.blocks == 132 * ve.BLOCKS_PER_SM
    big = ve.bias_relu_plan(64 * 5800 * 5800, 64, 1, 2, True, 132)
    assert big.vec == 8 and big.blocks == 132 * ve.BLOCKS_PER_SM
