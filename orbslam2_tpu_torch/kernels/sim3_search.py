"""Kernel M wrapper, its search launches: guided matching of the loop's two
keyframes under S12 (SearchBySim3).

Replaces ``orbslam2_tpu/ops/sim3_opt.py``: ``search_by_sim3`` (both
directions of Sim3 projection with the radius 7.5 sf^pred and the octave
window [pred - 1, pred + 1], TH_HIGH, no ratio, then the agreement check).
CUDA source: ``csrc/sim3_opt.cu`` (``sim3_search_kernel``: a warp per source
row of both directions, as kernel C, no (P, N) matrix stored;
``sim3_search_agree``: a thread per feature of image 1). Each warp derives
its direction's (s, R, t) from S12 with ``csrc/sim3.cuh``, as the plain
version (``ops/sim3_opt.search_parts``) writes it term by term; idx2 and
mutual are bit-exact against it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build, scale
from ..models.camera import Camera
from ..ops import sim3_opt

NAME = "sim3_search"
FUNCTION = "sim3_search"  # both its __global__ functions hold this name
SOURCE = "orbslam2_tpu_torch/kernels/csrc/sim3_opt.cu"
REPLACES = "orbslam2_tpu/ops/sim3_opt.py:143"
launches = 0


def search_by_sim3_plain(cam: Camera, S12, pos1, desc1, valid1, dmax1, xy1,
                         oct1, pos2, desc2, valid2, dmax2, xy2, oct2,
                         scale_factor: float, n_levels: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    return sim3_opt.search_by_sim3(cam, S12, pos1, desc1, valid1, dmax1, xy1,
                                   oct1, pos2, desc2, valid2, dmax2, xy2, oct2,
                                   scale_factor, n_levels)


def search_by_sim3(cam: Camera, S12, pos1, desc1, valid1, dmax1, xy1, oct1,
                   pos2, desc2, valid2, dmax2, xy2, oct2, scale_factor: float,
                   n_levels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel M's search on CUDA tensors, the plain version on CPU tensors:
    (idx2 (N1,) int32, -1 where the directions disagree; mutual (N1,))."""
    if pos1.device.type == "cpu":
        return search_by_sim3_plain(cam, S12, pos1, desc1, valid1, dmax1, xy1,
                                    oct1, pos2, desc2, valid2, dmax2, xy2, oct2,
                                    scale_factor, n_levels)
    dev = pos1.device
    n1, n2 = pos1.shape[0], pos2.shape[0]
    specs = [("S12", S12, torch.float32, (8,))]
    for tag, n, (pos, desc, valid, dmax, xy, octv) in (
            ("1", n1, (pos1, desc1, valid1, dmax1, xy1, oct1)),
            ("2", n2, (pos2, desc2, valid2, dmax2, xy2, oct2))):
        specs += [("pos" + tag, pos, torch.float32, (n, 3)),
                  ("desc" + tag, desc, torch.uint8, (n, 32)),
                  ("valid" + tag, valid, torch.bool, (n,)),
                  ("dmax" + tag, dmax, torch.float32, (n,)),
                  ("xy" + tag, xy, torch.float32, (n, 2)),
                  ("oct" + tag, octv, torch.int32, (n,))]
    build.expect(NAME, dev, specs)
    i32 = dict(dtype=torch.int32, device=dev)
    idx12, idx21 = torch.empty(n1, **i32), torch.empty(n2, **i32)
    idx2 = torch.empty(n1, **i32)
    mutual = torch.empty(n1, dtype=torch.bool, device=dev)
    err = build.library().osl_sim3_search(
        pos1.data_ptr(), desc1.data_ptr(), valid1.data_ptr(), dmax1.data_ptr(),
        xy1.data_ptr(), oct1.data_ptr(), n1, pos2.data_ptr(), desc2.data_ptr(),
        valid2.data_ptr(), dmax2.data_ptr(), xy2.data_ptr(), oct2.data_ptr(), n2,
        S12.data_ptr(), cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
        scale.log_sf(scale_factor),
        scale.table(scale_factor, "pow", dev, sim3_opt.RADIUS_MULT).data_ptr(),
        int(n_levels), idx12.data_ptr(), idx21.data_ptr(), idx2.data_ptr(),
        mutual.data_ptr(), build.stream_handle(dev))
    build.check(err, NAME)
    build.count_launch(__name__)
    return idx2, mutual
