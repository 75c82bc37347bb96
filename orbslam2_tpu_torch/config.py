"""Configuration tree, loadable from the reference's YAML settings files.

Own copy of ``orbslam2_tpu.config`` (framework-free): the port must not
import the JAX package, whose ``__init__`` imports JAX.

The reference parses per-dataset YAML with cv::FileStorage in the Tracking
constructor (†src/Tracking.cc ctor: Camera.{fx..}, ThDepth, DepthMapFactor,
ORBextractor.*, Viewer.*). We accept those exact files unchanged (including
the `%YAML:1.0` header OpenCV emits, which PyYAML rejects) and expose one
typed dataclass tree covering camera / frontend / mapping / loop / runtime.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

try:
    import yaml
except ImportError:  # pragma: no cover
    yaml = None


# ---------------------------------------------------------------------------
# Dataclasses
# ---------------------------------------------------------------------------

@dataclass
class CameraConfig:
    fx: float = 500.0
    fy: float = 500.0
    cx: float = 320.0
    cy: float = 240.0
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 640
    height: int = 480
    fps: float = 30.0
    bf: float = 0.0              # fx * baseline (stereo/RGB-D)
    rgb: bool = True             # input channel order flag (reference Camera.RGB)
    th_depth: float = 35.0       # close/far stereo gate multiplier (ThDepth)
    depth_map_factor: float = 1.0  # depth png scaling (DepthMapFactor)


@dataclass
class ExtractorConfig:
    """ORB frontend parameters (reference ORBextractor.* YAML keys)."""

    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    # Static padded keypoint capacity per frame. Must be >= n_features;
    # rounded to a multiple of 128.
    max_keypoints: int = 0  # 0 => auto = round_up(n_features, 128)
    # Upright BRIEF: skip the intensity-centroid rotation of the descriptor.
    # For rigs with negligible in-plane roll (wheeled, level handheld) this
    # is strictly more discriminative — the IC angle is pure noise on
    # weak-gradient patches. Default False = reference (rBRIEF) behavior.
    upright: bool = False

    def __post_init__(self):
        if self.max_keypoints <= 0:
            self.max_keypoints = ((self.n_features + 127) // 128) * 128

    @property
    def scale_factors(self):
        return [self.scale_factor ** i for i in range(self.n_levels)]

    @property
    def level_sigma2(self):
        return [s * s for s in self.scale_factors]


@dataclass
class MatcherConfig:
    """ORBmatcher gates (†include/ORBmatcher.h TH_LOW/TH_HIGH/HISTO_LENGTH)."""

    th_low: int = 50
    th_high: int = 100
    histo_length: int = 30
    check_orientation: bool = True


@dataclass
class TrackingConfig:
    """Tracking-thread thresholds (†src/Tracking.cc, SURVEY §2.9)."""

    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 0      # 0 => fps
    min_inliers_track: int = 10         # motion-model / ref-KF success
    min_inliers_local_map: int = 30
    min_inliers_after_reloc: int = 50
    motion_model_radius: float = 15.0   # mono search window th (7 stereo)
    local_map_size: int = 80            # max local keyframes
    # Padded device capacity of the tracked local-point buffer (the
    # reference's local map is unbounded). Overflow drops the weakest-
    # covisibility points with a log line; the packed per-frame result is
    # 20+cap floats (one code per point).
    local_map_point_cap: int = 12288


@dataclass
class MappingConfig:
    """Local-mapping / culling thresholds (SURVEY §2.9)."""

    mp_cull_found_ratio: float = 0.25
    kf_cull_redundancy: float = 0.9
    covisibility_threshold: int = 15
    essential_graph_weight: int = 100
    triangulation_neighbors: int = 20   # 10 for stereo


@dataclass
class LoopConfig:
    """Loop-closing thresholds (†src/LoopClosing.cc, SURVEY §2.8/2.9)."""

    covisibility_consistency_th: int = 3
    min_bow_matches: int = 20
    min_sim3_inliers: int = 20
    min_total_matches: int = 40
    kfs_between_loops: int = 10


@dataclass
class MapCapacityConfig:
    """Static capacities of the array map (no reference analog — the
    reference grows an unbounded pointer graph)."""

    max_keyframes: int = 512
    max_map_points: int = 40960
    max_obs_per_point: int = 32
    covisibility_top_k: int = 32


@dataclass
class RuntimeConfig:
    seed: int = 0
    # RGB-D depth map subsampling stride before upload: keypoints read the
    # nearest sample of depth[::stride, ::stride]. Kept at the reference
    # package's default of 2 so both packages sample the same depths; set 1
    # for exact per-pixel sampling.
    depth_upload_stride: int = 2
    # Pipelined tracking is not part of the port yet; the fields stay so a
    # config object is interchangeable between the two packages.
    pipeline_depth: int = 2
    pipeline_depth_max: int = 2
    # local BA window capacities (gathered compact buffers, SURVEY §7.3.1)
    local_ba_max_kfs: int = 32
    local_ba_max_fixed_kfs: int = 32
    local_ba_max_points: int = 4096
    pose_opt_rounds: int = 4
    pose_opt_iters: int = 10
    local_ba_iters: int = 15   # 5 + 10 schedule in reference
    global_ba_iters: int = 10
    essential_graph_iters: int = 20
    # shard the essential-graph edges over all visible devices (not ported)
    mesh_essential_graph: bool = False


@dataclass
class SlamConfig:
    sensor: str = "monocular"  # monocular | stereo | rgbd
    camera: CameraConfig = field(default_factory=CameraConfig)
    extractor: ExtractorConfig = field(default_factory=ExtractorConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    capacity: MapCapacityConfig = field(default_factory=MapCapacityConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    vocabulary_path: Optional[str] = None
    # Raw-camera stereo rectification blocks (reference EuRoC.yaml format:
    # LEFT./RIGHT. {K, D, R, P, width, height} — †Examples/Stereo/
    # stereo_euroc.cc ≈L60-110 reads these and builds remap tables). None
    # when the settings file describes an already-rectified rig.
    stereo_rectify: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        if self.tracking.max_frames_between_kf == 0:
            self.tracking.max_frames_between_kf = int(round(self.camera.fps)) or 30


# ---------------------------------------------------------------------------
# YAML loading (OpenCV-FileStorage flavored)
# ---------------------------------------------------------------------------

def _load_opencv_yaml(path: str) -> Dict[str, Any]:
    """Parse an OpenCV FileStorage YAML file into a flat dict.

    Handles the `%YAML:1.0` directive and `!!opencv-matrix` tags that PyYAML
    chokes on, so the reference settings files (†Examples/*/TUM1.yaml etc.)
    load unchanged.
    """
    with open(path, "r") as f:
        text = f.read()
    text = re.sub(r"^%YAML:.*$", "", text, flags=re.M)
    text = text.replace("!!opencv-matrix", "")
    if yaml is None:  # pragma: no cover
        raise RuntimeError("pyyaml unavailable")
    data = yaml.safe_load(text) or {}
    return data


def _get(d: Dict[str, Any], key: str, default):
    v = d.get(key, default)
    return default if v is None else v


def load_config(path: str, sensor: str = "monocular") -> SlamConfig:
    """Build a SlamConfig from a reference-format YAML settings file."""
    d = _load_opencv_yaml(path)
    cam = CameraConfig(
        fx=float(_get(d, "Camera.fx", 500.0)),
        fy=float(_get(d, "Camera.fy", 500.0)),
        cx=float(_get(d, "Camera.cx", 320.0)),
        cy=float(_get(d, "Camera.cy", 240.0)),
        k1=float(_get(d, "Camera.k1", 0.0)),
        k2=float(_get(d, "Camera.k2", 0.0)),
        p1=float(_get(d, "Camera.p1", 0.0)),
        p2=float(_get(d, "Camera.p2", 0.0)),
        k3=float(_get(d, "Camera.k3", 0.0)),
        width=int(_get(d, "Camera.width", 640)),
        height=int(_get(d, "Camera.height", 480)),
        fps=float(_get(d, "Camera.fps", 30.0)),
        bf=float(_get(d, "Camera.bf", 0.0)),
        rgb=bool(int(_get(d, "Camera.RGB", 1))),
        th_depth=float(_get(d, "ThDepth", 35.0)),
        depth_map_factor=float(_get(d, "DepthMapFactor", 1.0)),
    )
    if cam.depth_map_factor != 0:
        cam.depth_map_factor = abs(cam.depth_map_factor)
    ext = ExtractorConfig(
        n_features=int(_get(d, "ORBextractor.nFeatures", 1000)),
        scale_factor=float(_get(d, "ORBextractor.scaleFactor", 1.2)),
        n_levels=int(_get(d, "ORBextractor.nLevels", 8)),
        ini_th_fast=int(_get(d, "ORBextractor.iniThFAST", 20)),
        min_th_fast=int(_get(d, "ORBextractor.minThFAST", 7)),
    )
    cfg = SlamConfig(sensor=sensor, camera=cam, extractor=ext)
    cfg.stereo_rectify = _parse_rectify_blocks(d)
    return cfg


def _parse_rectify_blocks(d: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Extract the reference's LEFT./RIGHT. rectification matrices if present.

    The reference EuRoC stereo settings embed per-camera raw intrinsics K,
    radial-tangential D, rectifying rotation R, and rectified projection P
    as opencv-matrix blocks plus LEFT/RIGHT.{width,height}; its example
    builds cv::initUndistortRectifyMap tables from them. Returns
    {"left": {...}, "right": {...}} of numpy arrays, or None when absent.
    """
    import numpy as _np

    if "LEFT.K" not in d or "RIGHT.K" not in d:
        return None

    def mat(key):
        v = d[key]
        return _np.asarray(v["data"], dtype=_np.float64).reshape(
            int(v["rows"]), int(v["cols"])
        )

    out = {}
    for side in ("LEFT", "RIGHT"):
        out[side.lower()] = dict(
            K=mat(f"{side}.K"),
            D=mat(f"{side}.D").ravel(),
            R=mat(f"{side}.R"),
            P=mat(f"{side}.P"),
            width=int(d.get(f"{side}.width", d.get("Camera.width", 0))),
            height=int(d.get(f"{side}.height", d.get("Camera.height", 0))),
        )
    return out


def config_to_dict(cfg: SlamConfig) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)
