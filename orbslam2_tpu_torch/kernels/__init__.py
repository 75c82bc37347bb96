"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain twins.

One module per kernel, each holding the wrapper, the plain PyTorch version
of the same function, ``FUNCTION``, the name of the ``__global__`` function
it launches, and ``launches``, a plain integer the wrapper adds one to each
time it launches the CUDA kernel (``build.count_launch``, under a lock: the
asynchronous system launches from several threads):

  fast_score      A  FAST score + border + 3x3 NMS   (ops/orb.py detect_level)
  describe        B  IC angle + steered BRIEF         (ops/orb.py)
  hamming         C  gated Hamming top-2              (ops/matching.py, tracking)
  pose_lm         D  motion-only LM, 40 iterations    (ops/pose_opt.py)
  ba_linearize    E  BA linearisation + Schur system  (ops/ba.py)
  ba_solve        F  BA damped Cholesky + pose step   (ops/ba.py)
  ba_update_cost  G  BA back-substitution + cost      (ops/ba.py)
  ba_accept       H  BA LM accept / reject            (ops/ba.py)
  pyramid         I  pyramid level: resize + blur     (ops/image.py, ops/orb.py)
  orb_select      J  cell top-8 + round-robin select  (ops/orb.py)
  rgbd_depth      L  depth sample, u_r, undistortion  (tracking.py)
  point_attrs     N  distinctive desc, normal, band   (map/state.py)
  project_gate    O  projection, frustum, PredictScale (tracking.py)
  claim_resolve   Q  match gates, keypoint claims     (tracking.py)
  cascade_pack    R  pass choice, census, packed codes (tracking.py)
  triangulate     S  epipolar match + DLT + gates     (local_mapping.py)
  fuse_match      T  fuse projection search           (local_mapping.py)
  match_rot       U  mutual, rotation-checked matcher (tracking.py)
  stereo_match    V  stereo row-band descriptor match (ops/stereo.py)
  stereo_sad      W  stereo 11x11 SAD subpixel        (tracking.py)
  two_view        X  two-view H/F initializer         (ops/initializer.py)
  bow_words       Y  BoW words + TF-IDF vector        (ops/bow.py)
  pnp_ransac      Z  EPnP RANSAC + refine             (ops/pnp.py, tracking.py)
  sim3_ransac     K  Sim3 RANSAC (Horn) + refit       (ops/sim3_solver.py, loop_closing.py)
  sim3_opt        M  Sim3 LM refinement, 5 + 10 its   (ops/sim3_opt.py, loop_closing.py)
  sim3_search     M  SearchBySim3, both directions    (ops/sim3_opt.py, loop_closing.py)
  pose_graph      P  essential graph, dense LM        (ops/pose_graph.py, loop_closing.py)
  pose_graph_cg   P' essential graph, CG, K > 384     (ops/pose_graph.py, loop_closing.py)
  ba_solve_blocked F' blocked multi-block Cholesky     (ops/ba.py past 6K = 384, kernel P)
  pose_chain      R' pipelined pose chain: prediction, link (tracking.py)

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel (built by ``build.library()`` at first use) or raises.
"""

from . import (ba_accept, ba_linearize, ba_solve, ba_solve_blocked,
               ba_update_cost, bow_words, build, cascade_pack, claim_resolve,
               describe, fast_score, fuse_match, hamming, match_rot,
               orb_select, pnp_ransac, point_attrs, pose_chain, pose_graph,
               pose_graph_cg, pose_lm, project_gate, pyramid, rgbd_depth,
               sim3_opt, sim3_ransac, sim3_search, stereo_match, stereo_sad,
               triangulate, two_view)

KERNELS = (fast_score, describe, hamming, pose_lm, ba_linearize, ba_solve,
           ba_update_cost, ba_accept, pyramid, orb_select, rgbd_depth,
           point_attrs, project_gate, claim_resolve, cascade_pack,
           triangulate, fuse_match, match_rot, stereo_match, stereo_sad,
           two_view, bow_words, pnp_ransac, sim3_ransac, sim3_opt,
           sim3_search, pose_graph, ba_solve_blocked, pose_graph_cg,
           pose_chain)


def reset_launches():
    with build.launch_lock:
        for mod in KERNELS:
            mod.launches = 0


def launch_counts() -> dict:
    with build.launch_lock:
        return {mod.NAME: mod.launches for mod in KERNELS}
