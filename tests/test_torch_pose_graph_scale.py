"""The reference's 2000-vertex essential-graph tests on the port's plain CG
(``kernels/pose_graph.py`` on CPU tensors, ``solver="auto"``), with their
assertions, on the graphs utils/synthetic.scale_graph builds with numpy:
tests/test_capacity_scale.py::TestEssentialGraphScale here (its CG meets
the 600-iteration cap in most LM iterations, about a minute on the CPU)
and tests/test_bow_posegraph.py::test_large_graph_cg in
tests/test_torch_capacity_scale.py."""

import numpy as np
import torch

from orbslam2_tpu_torch.kernels import pose_graph
from orbslam2_tpu_torch.ops import geometry as geo
from orbslam2_tpu_torch.utils.synthetic import scale_graph

torch.set_num_threads(2)


def _optimize(kind):
    args, S_true = scale_graph(kind)
    res = pose_graph.optimize_pose_graph(*(torch.from_numpy(a) for a in args),
                                         iters=20)
    return args[0], res.poses, torch.from_numpy(S_true)


def _centre(S):
    R, t, s = geo.sim3_R(S), geo.sim3_t(S), geo.sim3_s(S)
    return (-(R.transpose(-1, -2) @ t[..., None])[..., 0] / s[..., None]).numpy()


def test_odometry_chain_with_loop():
    """The drifted 2000-vertex corridor chain with its loop closure edge
    converges through the CG solver, the write-back's division by scale
    stays finite, the drifted scale is removed and the far end's error
    falls below a fifth of its start."""
    S_init, S_opt, S_true = _optimize("corridor")
    K = S_true.shape[0]
    assert torch.isfinite(S_opt).all()
    assert np.abs(np.log(geo.sim3_s(S_opt).numpy())).max() < 0.05
    e_init = np.linalg.norm(_centre(torch.from_numpy(S_init[K - 1]))
                            - _centre(S_true[K - 1]))
    e_opt = np.linalg.norm(_centre(S_opt[K - 1]) - _centre(S_true[K - 1]))
    assert e_opt < 0.2 * e_init, (e_init, e_opt)
