"""Explicit config dataclasses, and the device rule of every entry point.

Counterpart of ``nerf_qa_tpu/config.py`` (a copy, not an import). This
carries ``DISTSConfig``, ``ADISTSConfig``, ``NRModelConfig`` and
``TrainConfig``; ``FRModelConfig`` comes with FR training.
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class DISTSConfig:
    """DISTS metric configuration (covers the reference's three variants).

    variant='main'     -> DISTS_pt.py       (raw α/β, joint-sum norm)
    variant='original' -> DISTS_pt_original (clamped load, norm modes)
    variant='softmax'  -> DISTS_pt_softmax  (α/β stored as logits)
    """

    variant: str = "main"
    # '+'-combinable tokens: 'relu', 'w_sum_detach'
    # (DISTS_pt_original.py:111-119); ignored by variant='softmax'.
    weight_norm: str = ""
    detach_beta: bool = False
    # load-time clamping for variant='original' (DISTS_pt_original.py:69-72)
    weight_lower_bound: float = 0.0
    alpha_beta_ratio: float = 1.0
    # execution knobs (no reference equivalent)
    compute_dtype: str = "float32"  # 'bfloat16' for tensor-core convs
    # 'eager' (two-pass oracle) | 'kernel' (fused CUDA moments)
    stats_impl: str = "eager"
    c1: float = 1e-6
    c2: float = 1e-6

    def replace(self, **kw) -> "DISTSConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ADISTSConfig:
    """ADISTS metric configuration (ADISTS/ADISTS.py:34-69)."""

    window_size: int = 21
    compute_dtype: str = "float32"
    # full-resolution execution knobs (no reference equivalent): gamma of
    # a stage with more than block_pixels_threshold pixels is summed over
    # channel blocks of channel_block, so the VALID moment maps never
    # exist at full channel width (one fp32 stage-1 map at 1080p, batch
    # 2, is ~1 GB); the plain T/S version is always channel-blocked
    block_pixels_threshold: int = 448 * 448
    channel_block: int = 16
    # the windowed T/S map: True sends CUDA tensors to the CUDA kernel
    # (ops/cuda/windowed_tsd.py) and CPU tensors to its plain version;
    # False gives the plain version on any device (the reference the
    # kernel is held against)
    fused_tsd: bool = True

    def replace(self, **kw) -> "ADISTSConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class NRModelConfig:
    """No-reference model family (model_nr.py .. model_nr_v8.py).

    ``version`` selects the architecture generation; v1-v7 differ from the
    v8 flagship only in norm type, channel schedules, residual scales and
    auxiliary heads (SURVEY §2 #9-16), so they are config points of one
    parameterized decoder rather than copied modules. The port builds the
    v7/v8 ChannelNorm generations; the others raise (ROADMAP Queue 1
    item 11).
    """

    version: int = 8
    vit_model: str = "dinov2"  # semantic backbone family
    refine_up_depth: int = 2
    transformer_decoder_depth: int = 2
    dropout_rate: float = 0.2
    refine_scale1: float = 1.0
    refine_scale2: float = 0.1
    refine_scale3: float = 0.1
    refine_scale4: float = 0.1
    dists_pref2ref_coeff: float = 0.5
    # auxiliary score-regression head of the v3-v6 generations:
    # 0 = off (v7/v8); 1 = score residual (v4, model_nr_v4.py:179-188);
    # 2 = (+ mae map, v5:181-184); 4 = (+ pred_std, pred_mean,
    # v6:188-203 with reg_activation calibration)
    score_reg_channels: int = 0
    reg_activation: str = "linear"  # 'linear' | 'relu' | 'sigmoid'
    score_reg_scale: float = 1.0  # v3's wandb.config.score_reg_scale
    # v3's RefineDown manifold consistency (model_nr_v3.py:65-93,256-267):
    # re-encode the predicted image through the frozen pyramid and pull
    # the predicted features toward it. 0 = off (v8 default).
    re_encode_coeff: float = 0.0
    # score-map objective weight (mode='score-map' batches: predicted
    # ADISTS map vs the decoded -log10 map, nerf_nr_qa_prep_4.py:101-135)
    score_map_coeff: float = 1.0
    # execution knobs (no reference equivalent)
    decoder_dtype: str = "float32"  # 'bfloat16': bf16 decoder convs and
    # products with fp32 master weights and optimizer state (cast at use)
    remat: bool = False  # activation checkpointing: not ported, raises
    dists: DISTSConfig = field(default_factory=DISTSConfig)

    @property
    def reg_channels(self) -> int:
        """Effective score-regression channel count: explicit override or
        the version's canonical head (v3/v4: 1, model_nr_v3.py:229-232 /
        model_nr_v4.py:179-188; v5: 2, model_nr_v5.py:163-166; v6: 4,
        model_nr_v6.py:167-170; otherwise none)."""
        if self.score_reg_channels > 0:
            return self.score_reg_channels
        return {3: 1, 4: 1, 5: 2, 6: 4}.get(self.version, 0)

    @property
    def norm_type(self) -> str:
        """BatchNorm+ReLU blocks for v1-v6, ChannelNorm+GELU for v7/v8
        (model_nr_v7.py:18-51 swap)."""
        return "channel" if self.version >= 7 else "batch"

    def replace(self, **kw) -> "NRModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer/schedule settings shared by FR/NR trainers
    (run_final.py:54-75, train-nr.py:180-203)."""

    lr: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    epochs: int = 10
    batch_size: int = 32  # settings_fr.py DEVICE_BATCH_SIZE=32; NR uses 4
    optimizer: str = "adam"
    schedule: str = "exp"  # 'exp' | 'cosine' | 'constant'
    gamma: float = 0.95  # ExponentialLR decay (run_final.py:264)
    warmup_epochs: int = 1
    entropy_loss_coeff: float = 0.0
    project_weights: bool = False
    seed: int = 0
    folds: int = 4  # GroupKFold CV (run_final.py:231-239)
    # accumulate gradients over N micro-batches before each optimizer step
    # (run.py:138-167 accumulates a whole epoch, weighted 1/frame_count)
    grad_accum_steps: int = 0

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


@contextlib.contextmanager
def true_fp32():
    """Run fp32 convolutions and matmuls in full fp32 inside the block.

    cuDNN takes fp32 convolutions through TF32 by default
    (``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
    decimal digits; the fp32 parity path must not. The flags are set here,
    locally, and restored on exit; importing the package flips nothing.
    """
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def torch_dtype(name: str) -> torch.dtype:
    """'bfloat16' -> torch.bfloat16, anything else -> torch.float32 (the
    JAX package's reading of ``compute_dtype``)."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another. With no CUDA and no explicit device this raises; it never
    carries on on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: nerf_qa_torch runs on the GPU unless the caller "
            "passes device='cpu' (--device cpu on the command line)")
    return torch.device("cuda")
