"""The benchmark of nerf_qa_torch on NVIDIA GPUs (see harness.py)."""
