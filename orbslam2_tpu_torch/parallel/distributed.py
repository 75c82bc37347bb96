"""Multi-process runtime: torch.distributed and the landmark-sharded BA
across ranks (port of ``orbslam2_tpu.parallel.distributed``).

The reference runs JAX's multi-controller runtime: one process per host,
a global mesh over every chip, and the sharded BA with XLA's collectives.
The port runs one process per card, as is usual in torch: ``initialize``
joins the group, ``global_landmark_mesh`` is the group as a mesh whose
shard is this rank's landmark range (``shard_problem_global``), and the
same ``ops.ba.schedule`` runs over it, its sums one
``torch.distributed.all_reduce`` of each packed buffer (S | b_S once an LM
iteration, then the cost): the counterpart of XLA's ``psum`` collective.
The all-reduce gives every rank the same sum, so every rank solves the same
system and holds the same poses, bit for bit. NCCL needs a card a rank;
``gloo`` runs on the CPU, and on CUDA tensors where ranks share a card.

``parallel/smoke_worker.py`` is the launch recipe; on a machine with
several cards: one worker a card, ``--device cuda`` (rank r on card r),
NCCL, and a ``file://`` or ``tcp://host:port`` rendezvous.
"""

from __future__ import annotations

from datetime import timedelta
from typing import List, Optional

import torch
import torch.distributed as dist

from ..ops import ba
from .sharded_ba import LandmarkMesh, _block, _shard, shard_problem

RENDEZVOUS_S = 60.0   # the limit of a rendezvous and of each collective


def initialize(init_method: str, world_size: int, rank: int,
               backend: Optional[str] = None):
    """Join the process group (a no-op for one process, as the reference's
    ``initialize``): ``init_method`` ``file:///path`` or
    ``tcp://host:port``; ``backend`` NCCL where CUDA is available, else
    ``gloo``; every rendezvous and collective waits at most
    ``RENDEZVOUS_S`` seconds, then raises."""
    if world_size <= 1:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=RENDEZVOUS_S))


class DistributedMesh(LandmarkMesh):
    """The process group as a landmark mesh: ``world`` shards, this rank's
    on ``device``; its sums are all-reduces over the group."""

    def __init__(self, device):
        super().__init__([device])
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()

    @property
    def size(self) -> int:
        return self.world

    def reduction(self, K: int, plain: bool = False) -> "_AllReduce":
        return _AllReduce(self.devices[0], K)

    def gather(self, results: List[ba.BAResult]) -> ba.BAResult:
        """This rank's result: the poses and cost every rank holds, the
        points and inliers of its own landmark range."""
        return results[0]


class _AllReduce:
    """``ops.ba.Reduction`` of one solve over the group: kernel E writes S |
    b_S into one packed buffer, kernel G the cost into another, each summed
    in place by one all-reduce."""

    def __init__(self, device, K: int):
        f32 = dict(dtype=torch.float32, device=device)
        self.n6 = 6 * K
        self.packed = torch.empty(self.n6 * self.n6 + self.n6, **f32)
        self.cost_buf = torch.empty(1, **f32)

    def system_rows(self, i):
        nn = self.n6 * self.n6
        return self.packed[:nn].view(self.n6, self.n6), self.packed[nn:]

    def cost_row(self, i):
        return self.cost_buf

    def system(self, lins):
        dist.all_reduce(self.packed)
        return self.system_rows(0)

    def cost(self, costs):
        dist.all_reduce(self.cost_buf)
        # kernel H updates the phase's cost in place: a copy of its own
        return [self.cost_buf.clone()]


def global_landmark_mesh(device=None) -> LandmarkMesh:
    """The mesh over every rank of the group, this rank's shard on
    ``device`` (by default the current CUDA device); without a group (one
    process), a one-shard mesh on ``device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("global_landmark_mesh: no CUDA device; pass "
                               "device='cpu'")
        device = torch.device("cuda", torch.cuda.current_device())
    if not (dist.is_available() and dist.is_initialized()):
        return LandmarkMesh([device])
    return DistributedMesh(device)


def shard_problem_global(mesh: LandmarkMesh, prob: ba.BAProblem
                         ) -> List[ba.BAProblem]:
    """This process's shards of ``prob`` (every process holds the whole
    problem, as the reference's): the cameras, and this rank's contiguous
    block of the landmark axis, which must divide by the group's size."""
    if not isinstance(mesh, DistributedMesh):
        return shard_problem(mesh, prob)
    b = _block(prob.points.shape[0], mesh.world)
    return [_shard(prob, mesh.rank * b, (mesh.rank + 1) * b, mesh.devices[0])]
