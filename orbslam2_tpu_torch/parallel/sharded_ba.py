"""Landmark-sharded bundle adjustment over an in-process mesh of devices
(port of ``orbslam2_tpu.parallel.sharded_ba``).

The reference shards the map axis over a ``jax.sharding.Mesh``: each device
builds its landmarks' part of the reduced camera system S and its RHS, one
``psum`` adds them, every device solves the (small, replicated) camera
system and back-substitutes its own landmarks. Here a mesh is a list of
devices, one shard each (a card may appear more than once). From one host
thread and without waiting, ``ops.ba.schedule`` launches kernels E and G of
each shard on its device, writing S | b_S and the cost into the shard's row
of a packed (n, L) buffer on the first device (rows of other cards are
peer-copied in), sums the rows with kernel ``shard_reduce`` in shard order,
solves once (F) and hands the trial poses to every shard (G, H). On CPU
tensors the plain versions run. The result is the same on every call.

Communication per LM iteration: (6K)^2 + 6K floats a shard, then one
float, whatever the number of landmarks.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..kernels import shard_reduce
from ..models.camera import Camera
from ..ops import ba


class LandmarkMesh:
    """Shards of the landmark axis, one a device of ``devices``, all in
    this process."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a landmark mesh needs at least one device")

    @property
    def size(self) -> int:
        """The number of landmark shards."""
        return len(self.devices)

    def reduction(self, K: int, plain: bool = False) -> "_MeshReduction":
        return _MeshReduction(self.devices, K, plain)

    def gather(self, results: List[ba.BAResult]) -> ba.BAResult:
        """The shards' results as one: the first shard's poses and cost,
        the points and inliers in the original landmark order."""
        dev = self.devices[0]
        return ba.BAResult(
            poses=results[0].poses,
            points=torch.cat([r.points.to(dev) for r in results]),
            obs_inlier=torch.cat([r.obs_inlier.to(dev) for r in results]),
            cost=results[0].cost)


class _MeshReduction:
    """``ops.ba.Reduction`` of one solve over a mesh: packed row buffers on
    the first device, summed by kernel shard_reduce (its plain version for
    ``plain`` or CPU tensors)."""

    def __init__(self, devices, K: int, plain: bool):
        self.devices = devices
        self.n6 = 6 * K
        self.reduce = (shard_reduce.shard_reduce_plain if plain
                       else shard_reduce.shard_reduce)
        n, f32 = len(devices), dict(dtype=torch.float32, device=devices[0])
        self.rows = torch.empty((n, self.n6 * self.n6 + self.n6), **f32)
        self.cost_rows = torch.empty((n, 1), **f32)
        # a shard on another device writes into its own row there first
        self.staged = {i: (torch.empty(self.rows.shape[1:], **dict(f32, device=d)),
                           torch.empty(1, **dict(f32, device=d)))
                       for i, d in enumerate(devices) if d != devices[0]}

    def _split(self, row):
        nn = self.n6 * self.n6
        return row[:nn].view(self.n6, self.n6), row[nn:]

    def system_rows(self, i):
        return self._split(self.staged[i][0] if i in self.staged else self.rows[i])

    def cost_row(self, i):
        return self.staged[i][1] if i in self.staged else self.cost_rows[i]

    def system(self, lins):
        for i, (row, _) in self.staged.items():
            self.rows[i].copy_(row)
        return self._split(self.reduce(self.rows))

    def cost(self, costs) -> List[torch.Tensor]:
        for i, (_, c) in self.staged.items():
            self.cost_rows[i].copy_(c)
        total = self.reduce(self.cost_rows)
        # every shard's kernel H updates its own copy in place
        return [total] + [total.to(d, copy=True) for d in self.devices[1:]]


def make_landmark_mesh(devices=None) -> LandmarkMesh:
    """A mesh over ``devices`` (a list such as ``["cpu"] * 8`` or
    ``["cuda:0"] * 4``); by default every visible CUDA device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_landmark_mesh: no CUDA device is visible; "
                               "pass the devices (e.g. ['cpu'] * 8)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return LandmarkMesh(devices)


def _block(M: int, n: int) -> int:
    if M % n:
        raise ValueError(f"the landmark axis ({M}) must divide by the mesh "
                         f"size ({n}); pad it with ops.ba.pad_problem")
    return M // n


def _shard(prob: ba.BAProblem, lo: int, hi: int, device) -> ba.BAProblem:
    """Cameras whole, landmarks [lo, hi), on ``device``."""
    cams = {"poses", "opt_mask"}
    return ba.BAProblem(*(
        (t if f in cams else t[lo:hi]).to(device, copy=True).contiguous()
        for f, t in zip(ba.BAProblem._fields, prob)))


def shard_problem(mesh: LandmarkMesh, prob: ba.BAProblem) -> List[ba.BAProblem]:
    """``prob`` placed on the mesh: the cameras on every shard, the landmark
    axis cut into equal contiguous blocks, shard i's on ``mesh.devices[i]``.
    M must divide by the mesh size."""
    b = _block(prob.points.shape[0], mesh.size)
    return [_shard(prob, i * b, (i + 1) * b, d) for i, d in enumerate(mesh.devices)]


def make_sharded_ba(mesh: LandmarkMesh, iters: int = 10, outlier_rounds: int = 1,
                    fix_points: bool = False, plain: bool = False):
    """A callable ``(cam, shards) -> BAResult`` with ``ops.ba.optimize_ba``'s
    semantics over ``shards = shard_problem(mesh, prob)`` (or, for a
    ``distributed.global_landmark_mesh``, ``shard_problem_global``): the
    kernels E-H and shard_reduce, or with ``plain`` their plain versions on
    any device (the kernels' yardstick on the card)."""
    steps = ba.PLAIN_STEPS if plain else ba.KERNEL_STEPS

    def solve(cam: Camera, shards: Sequence[ba.BAProblem]) -> ba.BAResult:
        if len(shards) != len(mesh.devices):
            raise ValueError(f"{len(shards)} shards for a mesh of "
                             f"{len(mesh.devices)} local devices")
        K = shards[0].poses.shape[0]
        results = ba.schedule(cam, shards, iters, outlier_rounds, fix_points,
                              steps, mesh.reduction(K, plain))
        return mesh.gather(results)

    return solve
