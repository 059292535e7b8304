"""The ``nr-v8`` configuration: the encoders' and the decoder's weights
from the seed, and the model FLOPs of scoring and of a training step, from
the sizes in ``nr-v8.json``."""
from __future__ import annotations

import torch

from portbench.harness import HERE, load_module
from portbench.weights import layer_rule, seeded_state

_dists = load_module(HERE / "configs" / "dists.py")


def model_config(spec: dict, decoder_dtype: str, stats_impl: str):
    from nerf_qa_torch.config import DISTSConfig, NRModelConfig

    d = spec["decoder"]
    return NRModelConfig(
        version=d["version"], refine_up_depth=d["refine_up_depth"],
        transformer_decoder_depth=d["transformer_decoder_depth"],
        dropout_rate=d["dropout_rate"], refine_scale1=d["refine_scale1"],
        refine_scale2=d["refine_scale2"], refine_scale3=d["refine_scale3"],
        refine_scale4=d["refine_scale4"],
        dists_pref2ref_coeff=spec["dists_pref2ref_coeff"], decoder_dtype=decoder_dtype,
        dists=DISTSConfig(compute_dtype="bfloat16", stats_impl=stats_impl))


def modules(spec: dict, cfg, render: int, sem: int, device) -> dict:
    """The port's four modules, built on ``device`` (their own initial
    values: the seeded ones are loaded after)."""
    from nerf_qa_torch.core.vgg import VGG16Pyramid
    from nerf_qa_torch.models.nr.decoder import NRDecoder
    from nerf_qa_torch.models.nr.featup import JBUStack
    from nerf_qa_torch.models.nr.vit import ViTS14

    v, d = spec["vit"], spec["decoder"]
    with torch.device(device):
        mods = {"vgg": VGG16Pyramid(),
                "vit": ViTS14(v["embed_dim"], v["depth"], v["num_heads"], v["patch_size"],
                              v["num_registers"], v["layer_scale_init"],
                              grid_size=sem // v["patch_size"]),
                "jbu": JBUStack(v["embed_dim"]),
                "decoder": NRDecoder(cfg, sem_dim=v["embed_dim"], qkv_bias=d["qkv_bias"],
                                     layer_scale=d["layer_scale"])}
    return {k: m.to(device) for k, m in mods.items()}


def states(mods: dict, gen: torch.Generator, device) -> dict:
    """Seeded weights of each module, one draw a module: He-normal VGG,
    lecun-normal ViT (position embeddings N(0, 0.02²)), JBU and decoder,
    zero biases; LayerNorms, LayerScale, tokens and the JBU's temperature
    and sigma at their constructors' values."""
    out = {}
    for name, m in mods.items():
        stds = layer_rule(2.0 if name == "vgg" else 1.0)(m)
        if name == "vit":
            stds["pos_embed"] = 0.02
        out[name] = seeded_state(m, stds, gen, device)
    return out


def vit_macs(spec: dict, sem: int) -> int:
    v = spec["vit"]
    grid = (sem // v["patch_size"]) ** 2
    t, d = grid + 1 + v["num_registers"], v["embed_dim"]
    patch = grid * 3 * v["patch_size"] ** 2 * d
    block = t * d * 3 * d + 2 * t * t * d + t * d * d + 2 * t * d * v["mlp_ratio"] * d
    return patch + v["depth"] * block


def jbu_macs(spec: dict, sem: int) -> int:
    """The range projections (two 1x1 convs at each upsampled grid) and the
    fixup 1x1 conv at each of the five levels; the filter itself and the
    bicubic and pooling resizes are not counted."""
    j, d = spec["jbu"], spec["vit"]["embed_dim"]
    g = sem // spec["vit"]["patch_size"]
    grids = [(g * 2 ** i) ** 2 for i in range(j["stages"] + 1)]
    k = j["key_dim"]
    return (sum(grids[1:]) * (j["guidance_dim"] * k + k * k) + sum(grids) * d * d)


def decoder_macs(spec: dict, render: int) -> int:
    """The mixer (two transformer blocks and trans2sem at the 16² grid) and
    the six RefineUp stages; the last stage's resample, whose output no
    v8 head reads, is not run and not counted."""
    dec, d = spec["decoder"], spec["vit"]["embed_dim"]
    chns = spec["dists"]["pyramid_channels"]
    rev = list(reversed(chns))  # [512, 512, 256, 128, 64, 3]
    g = render // 16
    t, m = g * g, rev[0] + d
    block = t * m * 3 * m + 2 * t * t * m + t * m * m + 2 * t * m * dec["mixer_mlp_ratio"] * m
    macs = dec["transformer_decoder_depth"] * block + t * 9 * m * d
    n_up = len(rev) - 2
    res = g
    for i in range(len(rev)):
        cin = rev[i] + d
        cout = (rev[i + 1] if i < len(rev) - 1 else rev[i]) + d
        macs += dec["refine_up_depth"] * res * res * 9 * cin * cin
        if i < n_up:
            macs += res * res * 9 * cin * cout  # 2x transposed conv
            res *= 2
        elif i < len(rev) - 1:
            macs += res * res * 9 * cin * cout
    return macs


def score_flops(spec: dict, render: int, sem: int) -> int:
    """FLOPs of scoring one render: ViT, JBU, VGG and decoder forwards."""
    return 2 * (vit_macs(spec, sem) + jbu_macs(spec, sem)
                + _dists.vgg_macs(spec["dists"], render, render)
                + decoder_macs(spec, render))


def train_flops(spec: dict, render: int, sem: int) -> int:
    """FLOPs of one training frame: the encoders' forwards (VGG over the
    render and the ground truth) and the decoder's forward three times
    (its backward counted as twice its forward)."""
    enc = vit_macs(spec, sem) + jbu_macs(spec, sem) + 2 * _dists.vgg_macs(
        spec["dists"], render, render)
    return 2 * (enc + 3 * decoder_macs(spec, render))


def build(spec: dict, gen: torch.Generator, device, render: int, sem: int,
          decoder_dtype: str, stats_impl: str):
    """(the port's NRModel over seeded weights, the weights by module)."""
    from nerf_qa_torch.core import dists
    from nerf_qa_torch.models.nr.model import NRModel

    cfg = model_config(spec, decoder_dtype, stats_impl)
    mods = modules(spec, cfg, render, sem, device)
    weights = states(mods, gen, device)
    for name, m in mods.items():
        m.load_state_dict(weights[name])
    model = NRModel(mods["vgg"], dists.load_pretrained_weights(cfg.dists), cfg,
                    vit=mods["vit"], jbu=mods["jbu"], decoder=mods["decoder"],
                    render_size=render, sem_size=sem)
    return model.to(device), weights
