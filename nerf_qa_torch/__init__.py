"""nerf_qa_torch — the PyTorch/CUDA port of the JAX package (``nerf_qa_tpu/``) for
NVIDIA Hopper.

A second package beside the JAX one, file for file (``core``, ``ops``,
``models``, ``eval``, ``compat``, ``data``, ``tools``). It imports ``torch`` and
nothing of JAX or of the JAX package. Plain tensor work is PyTorch; each
Pallas TPU kernel on a ported path is a CUDA C++ kernel for ``sm_90a``
under ``csrc/``, built with nvcc at first use (``ops/cuda/build.py``).

Ported so far:

* FR DISTS frame scoring: resize -> VGG16 pyramid with L2 pooling -> five
  moments per stage (the ``moments`` kernel) -> score -> per-video mean;
* NR v8 no-reference scoring: ViT-S/14 -> JBU semantic pyramid (the
  ``jbu`` kernel) and the VGG16 pyramid -> transformer mixer and RefineUp
  decoder (ChannelNorm, the ``channelnorm`` kernel) -> DISTS of the
  render against the predicted features -> per-video mean;
* ADISTS scoring at 256² and full resolution: VGG16 pyramid -> entropy
  channel weights -> per stage, γ and the ps cascade -> the windowed T/S
  map (the ``windowed_tsd`` kernel) -> 1 − Σ stage means.

Entry points run on the card unless the caller passes ``device='cpu'``.
"""

__version__ = "0.1.0"
