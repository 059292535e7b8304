"""One process of the port's multi-process FR step (spawned by
tests/test_torch_parallel_multiprocess.py on the CPU, and by
chip_smoke.py on the card; the port of tests/multihost_worker.py).

It joins the world of ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` /
``PROCESS_ID`` through ``parallel.distributed.maybe_initialize``, takes
its slice of four pairs through ``HostShardedSampler``, and runs one
data-parallel FR step (fp32) on ``WORKER_DEVICE`` (default cpu) with a
mesh that carries the world's group, so the gradient is summed across
the processes. Prints machine-checkable lines:

  BACKEND <name> <world size>
  SHARD <rank> <indices>          the process's sampler slice
  LOSS <value>                    the step's (global) loss
  PARAMS <leaf>=<sum>/<abs sum>   per-leaf float64 checksums after the step

Every process of a world must print the same LOSS and PARAMS lines.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nerf_qa_torch.parallel.distributed import (  # noqa: E402
    HostShardedSampler,
    host_info,
    maybe_initialize,
)

N_GLOBAL = 4


def global_batch():
    """The four pairs, their targets and the head-init data, from seed 0."""
    rng = np.random.default_rng(0)
    dist = rng.random((N_GLOBAL, 32, 32, 3)).astype(np.float32)
    ref = np.clip(dist + 0.05, 0, 1).astype(np.float32)
    targets = rng.uniform(1, 5, N_GLOBAL).astype(np.float32)
    fx = rng.uniform(0.1, 0.6, 16)
    return dist, ref, targets, fx, 5.0 - 4.0 * fx


def make_trainer(device, mesh=None):
    import torch

    from nerf_qa_torch.config import DISTSConfig, FRModelConfig, TrainConfig
    from nerf_qa_torch.core.dists import load_pretrained_weights
    from nerf_qa_torch.core.vgg import VGG16Pyramid, init_he_normal
    from nerf_qa_torch.train.fr_train import FRTrainer

    dcfg = DISTSConfig(compute_dtype="float32", stats_impl="kernel")
    return FRTrainer(init_he_normal(VGG16Pyramid(), torch.Generator().manual_seed(0)),
                     FRModelConfig(regression_type="linear", dists=dcfg),
                     TrainConfig(lr=1e-3, schedule="constant", batch_size=N_GLOBAL),
                     steps_per_epoch=1, dists_weights=load_pretrained_weights(dcfg),
                     device=device, mesh=mesh)


def param_lines(params) -> list[str]:
    leaves = {f"head.{k}": v for k, v in params["head"].items()}
    leaves["dists.alpha"] = params["dists"].alpha
    leaves["dists.beta"] = params["dists"].beta
    out = []
    for name, leaf in leaves.items():
        val = leaf.detach().cpu().double().numpy()
        out.append(f"PARAMS {name}={float(val.sum())!r}/{float(np.abs(val).sum())!r}")
    return out


def main() -> int:
    if not maybe_initialize():
        raise SystemExit("cluster environment variables missing")
    import torch.distributed as dist

    from nerf_qa_torch.parallel.mesh import create_mesh

    rank, world = host_info()
    print(f"BACKEND {dist.get_backend()} {world}", flush=True)
    dist_imgs, ref, targets, fx, fy = global_batch()
    idx = np.asarray(list(HostShardedSampler(range(N_GLOBAL))), np.int64)
    print(f"SHARD {rank} {idx.tolist()}", flush=True)
    device = os.environ.get("WORKER_DEVICE", "cpu")
    trainer = make_trainer(device, create_mesh([device], group=dist.group.WORLD))
    params, opt_state = trainer.init(fx, fy)
    params, opt_state, loss, _ = trainer.train_step(params, opt_state, dist_imgs[idx],
                                                    ref[idx], targets[idx])
    print(f"LOSS {float(loss)!r}", flush=True)
    for line in param_lines(params):
        print(line, flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
