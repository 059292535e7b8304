"""Plain PyTorch NeRF-QA NR v8, the reference of the ``nr-v8`` configuration.

model_nr_v8.py of the NeRF-QA repository (github.com/kobejean/nerf-qa),
written out over the benchmark's weights (state dictionaries in the
reference key layouts) with plain operations:

* DINOv2 ViT-S/14 with registers on the 224² render: a 14x14 patch conv,
  learned position embeddings over the patch grid, CLS and 4 register
  tokens, 12 pre-norm blocks (LayerNorm eps 1e-6, LayerScale), a final
  LayerNorm; the patch tokens as a 16² map;
* FeatUp's JBU stack: four learned joint-bilateral 2x upsamplings
  (guidance: the image average-pooled to the target grid; range kernel a
  softmax over the 7x7 neighbourhood of the temperature-scaled products
  of a 1x1-conv projection; a Gaussian spatial kernel; the normalised
  product filters the reflect-padded bicubic upsample), the 0.1-residual
  1x1 fixup at each level, the 256² level twice;
* the DISTS VGG16 pyramid of the 256² render (``reference/dists.py``);
* the decoder: two transformer blocks (8 heads, no qkv bias, no
  LayerScale, LayerNorm eps 1e-5) over the 16² mix of the VGG's top stage
  and the ViT map, ``trans2sem`` (Dropout2d, 3x3 conv, ChannelNorm, GELU)
  with the 0.1 residuals, then six RefineUp stages (blend with the render's
  DISTS feature and the JBU level, two Dropout2d-conv-ChannelNorm layers
  with GELU between, a 0.1 residual, the predicted GT feature sliced off,
  then a 2x transposed conv or a conv; the last stage's resample, which no
  v8 output reads, is not run);
* the score: DISTS of the render's features against the predicted ones;
  the ``gt`` training losses: l1 between that score and DISTS(GT, render),
  DISTS(predicted, GT) averaged over the batch, combined 0.5 / 0.5; Adam.

It imports nothing of the program. Dropout masks are drawn again from a
generator seeded as the program's, in the same order and shapes
(``torch.rand((N, C, 1, 1))`` at each Dropout2d, kept where below 0.8).

Precision: ``dtype`` is the decoder's (fp32 when scoring, its
convolutions in TF32 as cuDNN's default; bf16 in training, on fp32
master weights: convolutions, projections and ChannelNorm outputs in
bf16, statistics, attention logits and softmax, LayerNorms and the
residual stream in fp32); the VGG pyramid in bf16; matmuls without TF32.
``fp8=True`` rounds the decoder convolutions' operands to fp8 (the
control of the bf16 decoder); the VGG's ``lower`` rounds its own.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import torch
import torch.nn.functional as F

_spec = importlib.util.spec_from_file_location(
    "portbench_reference_dists_for_nr", Path(__file__).with_name("dists.py"))
dists = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(dists)

KEEP = 0.8  # 1 - the decoder's dropout rate 0.2


# ---------------------------------------------------------------- ViT

def layer_norm(x, sd, key, eps):
    return F.layer_norm(x, x.shape[-1:], sd[key + ".weight"], sd[key + ".bias"], eps)


def linear(x, sd, key, dtype=torch.float32):
    b = sd.get(key + ".bias")
    return F.linear(x.to(dtype), sd[key + ".weight"].to(dtype),
                    None if b is None else b.to(dtype))


def attention(x, sd, key, heads, dtype):
    b, n, c = x.shape
    hd = c // heads
    qkv = linear(x, sd, key + ".qkv", dtype).reshape(b, n, 3, heads, hd)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    logits = (q * hd ** -0.5).float() @ k.float().transpose(-2, -1)
    attn = torch.softmax(logits, dim=-1).to(dtype)
    out = (attn.float() @ v.float()).transpose(1, 2).reshape(b, n, c)
    return linear(out, sd, key + ".proj", dtype)


def block(x, sd, key, heads, eps, dtype=torch.float32):
    """Pre-norm transformer block; LayerScale where the weights have one."""
    a = attention(layer_norm(x, sd, key + ".norm1", eps), sd, key + ".attn", heads, dtype)
    if key + ".ls1.gamma" in sd:
        a = a * sd[key + ".ls1.gamma"]
    x = x + a.float()
    h = F.gelu(linear(layer_norm(x, sd, key + ".norm2", eps), sd, key + ".mlp.fc1", dtype))
    m = linear(h, sd, key + ".mlp.fc2", dtype)
    if key + ".ls2.gamma" in sd:
        m = m * sd[key + ".ls2.gamma"]
    return x + m.float()


def vit(sd, img224, spec):
    """NCHW image -> (N, D, gh, gw) fp32 patch-token map."""
    v = spec["vit"]
    p = v["patch_size"]
    n = img224.shape[0]
    tok = F.conv2d(img224, sd["patch_embed.proj.weight"], sd["patch_embed.proj.bias"], stride=p)
    gh, gw = tok.shape[2:]
    tok = tok.flatten(2).transpose(1, 2) + sd["pos_embed"]
    prefix = torch.cat([sd["cls_token"].expand(n, -1, -1),
                        sd["register_tokens"].expand(n, -1, -1)], dim=1)
    x = torch.cat([prefix, tok], dim=1)
    for i in range(v["depth"]):
        x = block(x, sd, f"blocks.{i}", v["num_heads"], v["norm_eps"])
    x = layer_norm(x, sd, "norm", v["norm_eps"])[:, 1 + v["num_registers"]:]
    return x.transpose(1, 2).reshape(n, -1, gh, gw)


# ---------------------------------------------------------------- JBU

def jbu(sd, key, source, guidance, radius):
    """One learned 2x joint-bilateral upsampling: NCHW source (N, C, h, w),
    guidance (N, 3, 2h, 2w) -> (N, C, 2h, 2w) fp32."""
    gh, gw = guidance.shape[2:]
    d = 2 * radius + 1
    proj = F.conv2d(guidance, sd[key + ".range_proj.0.weight"], sd[key + ".range_proj.0.bias"])
    proj = F.conv2d(F.gelu(proj), sd[key + ".range_proj.3.weight"],
                    sd[key + ".range_proj.3.bias"])
    temp = torch.clamp(torch.exp(sd[key + ".range_temp"]), 1e-4, 1e4)
    hr = F.interpolate(source, size=(gh, gw), mode="bicubic", align_corners=False)
    offs = torch.linspace(-1.0, 1.0, d, device=source.device)
    sq = (offs[:, None] ** 2 + offs[None, :] ** 2).reshape(-1)
    spatial = torch.exp(-sq / (2.0 * sd[key + ".sigma_spatial"] ** 2))
    pp = F.pad(proj, (radius,) * 4, mode="reflect")
    hp = F.pad(hr, (radius,) * 4, mode="reflect")
    logits = torch.stack([(pp[:, :, i // d:i // d + gh, i % d:i % d + gw] * proj).sum(1)
                          for i in range(d * d)], dim=1)  # (N, d², H, W)
    k = torch.softmax(temp * logits, dim=1) * spatial[None, :, None, None]
    k = k / k.sum(1, keepdim=True).clamp_min(1e-7)
    out = torch.zeros_like(hr)
    for i in range(d * d):
        out += hp[:, :, i // d:i // d + gh, i % d:i % d + gw] * k[:, i:i + 1]
    return out


def jbu_stack(sd, feats, image, spec):
    """ViT map (N, D, g, g) and the 224² image -> six NCHW fp32 levels."""
    levels = [feats]
    f = feats
    for i in range(1, spec["jbu"]["stages"] + 1):
        h, w = f.shape[2:]
        g = F.adaptive_avg_pool2d(image, (2 * h, 2 * w))
        f = jbu(sd, f"up{i}", f, g, spec["jbu"]["radius"])
        levels.append(f)
    r = spec["jbu"]["fixup_residual"]
    levels = [F.conv2d(x, sd["fixup_proj.1.weight"], sd["fixup_proj.1.bias"]) * r + x
              for x in levels]
    return levels + [levels[-1]]


# ---------------------------------------------------------------- decoder

def channel_norm(x, sd, key, gelu, eps):
    """LayerNorm over channels at each pixel, fp32 statistics, output in
    x's dtype."""
    xf = x.float()
    mean = xf.mean(1, keepdim=True)
    var = (xf - mean).square().mean(1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * sd[key + ".weight"].float()[None, :, None, None] + \
        sd[key + ".bias"].float()[None, :, None, None]
    if gelu:
        y = F.gelu(y)
    return y.to(x.dtype)


def dropout(x, gen):
    if gen is None:
        return x
    u = torch.rand((x.shape[0], x.shape[1], 1, 1), generator=gen, device=x.device)
    return torch.where(u < KEEP, x / KEEP, torch.zeros((), dtype=x.dtype, device=x.device))


def conv_layer(x, sd, key, act, dtype, gen, eps, fp8=False, transpose=False):
    """Dropout2d -> 3x3 conv (or the exact-2x transposed conv) ->
    ChannelNorm (+GELU), computed in ``dtype``."""
    x = dropout(x.to(dtype), gen)
    w = sd[key + ".conv.weight"].to(dtype)
    b = sd[key + ".conv.bias"].to(dtype)
    if fp8:
        x, w = dists.fp8_round(x), dists.fp8_round(w)
    if transpose:
        y = F.conv_transpose2d(x, w, b, stride=2, padding=1, output_padding=1)
    else:
        y = F.conv2d(x, w, b, padding=1)
    return channel_norm(y, sd, key + ".norm_layer.norm", act, eps)


def decoder(sd, dfeats, sem, pyramid, spec, dtype, gen=None, fp8=False):
    """Render DISTS levels (NCHW, [x, s1..s5]), the ViT map, the JBU levels
    -> the predicted GT levels (NCHW, in ``dtype``)."""
    dec, d = spec["decoder"], spec["vit"]["embed_dim"]
    eps = dec["norm_eps"]
    top = dfeats[-1].float()
    n, _, gh, gw = top.shape
    enc = torch.cat([top, sem], dim=1)
    tokens = enc.flatten(2).transpose(1, 2)
    for i in range(dec["transformer_decoder_depth"]):
        tokens = block(tokens, sd, f"transformer_decoder.{i}", dec["mixer_heads"], eps, dtype)
    mix_in = enc + dec["refine_scale3"] * tokens.transpose(1, 2).reshape(enc.shape)
    mixed = conv_layer(mix_in, sd, "trans2sem", True, dtype, gen, eps, fp8)
    trans = sem + dec["refine_scale4"] * mixed.float()
    fm = torch.cat([top, trans], dim=1)
    rev = list(reversed(spec["dists"]["pyramid_channels"]))
    n_up = len(rev) - 2
    preds = []
    for i in range(len(rev)):
        key = f"decoder.{i}"
        guide = torch.cat([dfeats[len(rev) - 1 - i].float(), pyramid[i].float()], dim=1)
        x = (fm * dec["refine_scale1"] + guide).to(dtype)
        h = x
        depth = dec["refine_up_depth"]
        for j in range(depth):
            h = conv_layer(h, sd, f"{key}.block.{j}", j < depth - 1, dtype, gen, eps, fp8)
        fm = dec["refine_scale2"] * h + x
        preds.append(fm[:, :rev[i]])
        if i < len(rev) - 1:
            fm = conv_layer(fm, sd, f"{key}.upsample_layer", False, dtype, gen, eps, fp8,
                            transpose=i < n_up)
    return list(reversed(preds))


# ---------------------------------------------------------------- model

class Reference:
    """The NR v8 model over the benchmark's weights (``states``: the
    ``vgg``, ``vit``, ``jbu`` and ``decoder`` state dictionaries)."""

    def __init__(self, states: dict, spec: dict, alpha_beta_path: str, device):
        self.s, self.spec = states, spec
        self.alpha, self.beta = dists.alpha_beta(alpha_beta_path, device)

    @torch.no_grad()
    def semantic(self, r224):
        """NHWC 224² renders -> (the ViT map, the JBU levels)."""
        y = r224.permute(0, 3, 1, 2).float()
        sem = vit(self.s["vit"], y, self.spec)
        return sem, jbu_stack(self.s["jbu"], sem, y, self.spec)

    @torch.no_grad()
    def score(self, r256, r224, dtype=torch.float32, lower=False, block=4):
        """NR scores of NHWC renders, ``block`` at a time; ``lower``: the
        control (VGG operands in fp8, the decoder in bf16)."""
        out = []
        with precision():
            for lo in range(0, r256.shape[0], block):
                sem, pyr = self.semantic(r224[lo:lo + block])
                x = r256[lo:lo + block].permute(0, 3, 1, 2).float()
                dfeats = dists.pyramid(self.s["vgg"], x, torch.bfloat16, lower)
                pred = decoder(self.s["decoder"], dfeats, sem, pyr, self.spec,
                               torch.bfloat16 if lower else dtype)
                out.append(dists.score_feats(dfeats, pred, self.alpha, self.beta))
        return torch.cat(out)

    def losses(self, params, gt, r256, r224, gen, lower=False, dtype=torch.bfloat16):
        """The ``gt`` objective's losses of one batch, the decoder's weights
        taken from ``params`` (a ``dtype`` decoder on fp32 master weights)."""
        n = r256.shape[0]
        x = torch.cat([r256, gt]).permute(0, 3, 1, 2).float()
        with torch.no_grad():
            both = dists.pyramid(self.s["vgg"], x, torch.bfloat16, lower)
        sem, pyr = self.semantic(r224)
        rfeats = [f[:n] for f in both]
        gfeats = [f[n:] for f in both]
        with torch.no_grad():
            gt_score = dists.score_feats(gfeats, rfeats, self.alpha, self.beta)
        pred = decoder(params, rfeats, sem, pyr, self.spec, dtype, gen, fp8=lower)
        score = dists.score_feats(rfeats, pred, self.alpha, self.beta)
        l1 = (score - gt_score).abs().mean()
        pref2ref = dists.score_feats(pred, gfeats, self.alpha, self.beta).mean()
        c = self.spec["dists_pref2ref_coeff"]
        return {"l1": l1, "dists_pref2ref": pref2ref,
                "combined": c * pref2ref + (1.0 - c) * l1}

    def train(self, batches, gen, lower=False, dtype=torch.bfloat16, start=None):
        """Adam on the decoder over ``batches`` of (gt, r256, r224), from the
        initial weights with Adam's state at zero, or from ``start``: the
        decoder's ``params``, Adam's ``exp_avg`` and ``exp_avg_sq`` by leaf
        and its ``step`` count. Returns (the losses of each step as floats,
        the first step's gradient norm of each leaf, each leaf's change norm
        after the last step)."""
        t = self.spec["train"]
        lr, (b1, b2), eps = t["lr"], t["betas"], t["eps"]
        init = start["params"] if start else self.s["decoder"]
        params = {k: v.detach().clone().requires_grad_(True) for k, v in init.items()}

        def moment(key, k):
            got = start[key].get(k) if start else None
            return torch.zeros_like(params[k]) if got is None else got.clone()

        m = {k: moment("exp_avg", k) for k in params}
        v2 = {k: moment("exp_avg_sq", k) for k in params}
        first = (start["step"] if start else 0) + 1
        losses, grad_norms = [], {}
        with precision():
            for step, (gt, r256, r224) in enumerate(batches, start=first):
                out = self.losses(params, gt, r256, r224, gen, lower, dtype)
                grads = torch.autograd.grad(out["combined"], list(params.values()),
                                            allow_unused=True)
                losses.append({k: float(v.detach()) for k, v in out.items()})
                with torch.no_grad():
                    for (k, p), g in zip(params.items(), grads):
                        if g is None:
                            continue
                        if step == first:
                            grad_norms[k] = float(g.norm())
                        m[k].mul_(b1).add_(g, alpha=1 - b1)
                        v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                        mh = m[k] / (1 - b1 ** step)
                        vh = v2[k] / (1 - b2 ** step)
                        p.sub_(lr * mh / (vh.sqrt() + eps))
        change = {k: float((params[k].detach() - init[k]).norm()) for k in params}
        return losses, grad_norms, change


class precision:
    """Matmuls in true fp32; cuDNN convolutions at its default (TF32 for
    fp32), the precision the configuration states."""

    def __enter__(self):
        self.prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.prev
