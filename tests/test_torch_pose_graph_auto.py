"""The port's essential graph through ``solver="auto"`` just past the
dense limit, where both packages take the matrix-free CG solver, against
the JAX package (its own file: the JAX compile of the CG program takes
about a minute on the CPU)."""

import jax.numpy as jnp
import numpy as np
import torch

from orbslam2_tpu.ops import pose_graph as jpose_graph
from orbslam2_tpu_torch.kernels import pose_graph
from orbslam2_tpu_torch.ops import pose_graph as pg_ops
from orbslam2_tpu_torch.utils.synthetic import pose_graph_ring

torch.set_num_threads(2)


def test_auto_past_the_dense_limit_matches_reference():
    """A drifted 385-keyframe ring (utils/synthetic.pose_graph_ring, scale
    fixed), one slot past DENSE_MAX_K: ``solver="auto"`` takes CG in both
    packages, and the port's pose vectors are within 1e-4 of the JAX
    package's (measured 6.2e-6 at K = 400)."""
    K = pg_ops.DENSE_MAX_K + 1
    args, _ = pose_graph_ring(K)
    calls = []
    solve = pg_ops.cg_solve

    def counted(*a, **k):
        calls.append(1)
        return solve(*a, **k)

    pg_ops.cg_solve = counted
    try:
        rt = pose_graph.optimize_pose_graph(*args, fix_scale=True)
    finally:
        pg_ops.cg_solve = solve
    assert len(calls) == 20, "auto did not take the CG solver past the dense limit"
    rj = jpose_graph.optimize_pose_graph(*(jnp.asarray(a.numpy()) for a in args),
                                         iters=20, fix_scale=True)
    np.testing.assert_allclose(rt.poses.numpy(), np.asarray(rj.poses), atol=1e-4)
