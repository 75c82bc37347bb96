"""Kernel shard_reduce wrapper: the landmark shards' partial sums of the
sharded bundle adjustment added in shard order.

Replaces the ``psum`` over the "landmarks" mesh axis inside one process:
``orbslam2_tpu/ops/ba.py:345`` (S and b_S, once an LM iteration) and
``:219`` (the robust cost). CUDA source: ``csrc/shard_reduce.cu`` (a
grid-stride loop, a float4 of the row a thread, the shards summed in a
register). The shards' partials are the rows of one (n, L) float32 buffer
on one card; row i's values are added in the order 0, 1, ..., n - 1, so
the sum is the same on every run and bit-exact against the plain version,
which adds the rows in the same order in a Python loop (``sum(dim=0)``
does not fix its order).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build

NAME = "shard_reduce"
FUNCTION = "shard_reduce"  # its __global__ functions shard_reduce4 / shard_reduce1
SOURCE = "orbslam2_tpu_torch/kernels/csrc/shard_reduce.cu"
REPLACES = "orbslam2_tpu/ops/ba.py:345"
launches = 0


def shard_reduce_plain(x: torch.Tensor, out: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """(L,) the rows of ``x`` (n, L) added in row order."""
    s = x[0].clone()
    for i in range(1, x.shape[0]):
        s = s + x[i]
    return s if out is None else out.copy_(s)


def shard_reduce(x: torch.Tensor, out: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Kernel shard_reduce on a CUDA tensor, the plain version on a CPU
    tensor: (L,) float32, the rows of the (n, L) float32 ``x`` added in
    row order, written into ``out`` when given."""
    if x.device.type == "cpu":
        return shard_reduce_plain(x, out)
    dev = x.device
    n, L = x.shape
    build.expect(NAME, dev, (("x", x, torch.float32, (n, L)),))
    if out is None:
        out = torch.empty(L, dtype=torch.float32, device=dev)
    build.expect(NAME, dev, (("out", out, torch.float32, (L,)),))
    err = build.library().osl_shard_reduce(x.data_ptr(), n, L, out.data_ptr(),
                                           build.stream_handle(dev))
    build.check(err, NAME)
    build.count_launch(__name__)
    return out
