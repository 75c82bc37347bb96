"""Worker process of the multi-process sharded BA (port of
``orbslam2_tpu.parallel.smoke_worker``).

    python -m orbslam2_tpu_torch.parallel.smoke_worker <rank> <world> \\
        <init_method> <problem.npz> <out.npz> [--device cpu|cuda] \\
        [--backend nccl|gloo] [--iters 8]

Each process joins the group (``distributed.initialize``, at most 60 s for
the rendezvous and each collective), takes its landmark range of the
problem and runs the sharded BA with the others. ``problem.npz`` holds the
reference's camera and BA problem as ``cam_<field>`` and ``prob_<field>``
arrays (``tests/test_distributed_2proc.py``'s payload). Rank 0 writes
``out.npz``, rank r > 0 ``out.rank<r>.npz``: the poses, the cost, this
rank's points and inliers and the world size. ``--device cuda`` puts rank r
on card r modulo the cards; the backend is NCCL there and ``gloo`` on the
CPU unless ``--backend`` says otherwise (ranks that share a card need
``gloo``). On a machine with several cards, one worker a card:

    for r in 0 1 2 3; do python -m orbslam2_tpu_torch.parallel.smoke_worker \\
        $r 4 file:///tmp/ba_rendezvous prob.npz out.npz --device cuda & done
"""

from __future__ import annotations

import argparse
import os


def out_path(out: str, rank: int) -> str:
    """Where rank ``rank`` writes its result."""
    if rank == 0:
        return out
    stem, ext = os.path.splitext(out)
    return f"{stem}.rank{rank}{ext}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("init_method")
    ap.add_argument("problem")
    ap.add_argument("out")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from ..device import resolve
    from ..models.camera import Camera
    from ..ops.ba import BAProblem
    from ..utils.convert import ba_problem_from_numpy, camera_from_numpy
    from . import distributed, sharded_ba

    torch.set_num_threads(1)
    device = resolve(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", args.rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
    distributed.initialize(args.init_method, args.world, args.rank, backend)
    with np.load(args.problem) as data:
        cam = camera_from_numpy({f: data[f"cam_{f}"] for f in Camera._fields})
        prob = ba_problem_from_numpy(
            {f: data[f"prob_{f}"] for f in BAProblem._fields}, device)
    mesh = distributed.global_landmark_mesh(device)
    shards = distributed.shard_problem_global(mesh, prob)
    res = sharded_ba.make_sharded_ba(mesh, iters=args.iters)(cam, shards)
    np.savez(out_path(args.out, args.rank), poses=res.poses.cpu().numpy(),
             cost=float(res.cost), points=res.points.cpu().numpy(),
             obs_inlier=res.obs_inlier.cpu().numpy(), world=mesh.size)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
