"""Configuration layer: typed dataclasses with validation + YAML overrides.

Defaults mirror the reference's config/como.yml hyperparameters; unlike
the reference (raw dicts passed down, several sigmas hard-coded at call
sites), every knob lives here, is validated on load, and the sigma values
that the reference buries in Mapping.iterate (gp_ml sigma=1e0,
log_depth_prior sigma_first=1e0, pixel prior sigmas 1e-2/3.33e-1,
distill sigma_median=5e-2) are first-class fields.

PyTorch port: a copy of como_tpu/config.py, so that the port loads the
same configs/*.yml unchanged without importing the JAX package.  Every
port entry point takes an explicit `device` argument (default "cuda") that
fixes the device type; the `tracking.device` / `mapping.device` fields
give each stage's index on that type (runtime/placement.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import yaml


@dataclass
class PyrConfig:
    start_level: int = 0
    end_level: int = 3
    depth_interp_mode: str = "nearest_neighbor"


@dataclass
class TermCriteria:
    max_iter: int = 50
    delta_norm: float = 1e-3
    rel_tol: float = 1e-3
    grad_norm: float = 1.0
    abs_tol: float = 1e-6  # absolute robust-cost floor (converged below it)


@dataclass
class KeyframingConfig:
    kf_depth_motion_ratio: float = 0.12
    kf_num_pixels_frac: float = 0.75
    one_way_freq: int = 3
    # rotation-aware motion criterion (0 = the reference's translation-
    # only rule, Tracking.py:114-132): fold depth*rot_angle into the
    # keyframe distance — rotation sweeps points sideways like a baseline
    # of that length, so rotation-dominant viewpoint change (orbits)
    # triggers keyframes as predictably as translation does
    kf_rot_weight: float = 0.0
    # How the rotation term combines with translation: "sum" adds
    # kf_rot_weight * depth * angle to |t| (every rotation nudges the
    # trigger earlier — measured to perturb keyframe timing on
    # translation-dominant worlds); "max" takes the larger of the two
    # (rotation drives the trigger only when it DOMINATES the viewpoint
    # change, leaving translation-dominant timing bit-identical to the
    # reference's rule)
    kf_rot_mode: str = "max"
    # EMA smoothing of the decision median depth (0 = off): decouples
    # keyframe timing from single-frame median flicker on occluded worlds.
    # DEFAULT 0.5 (round 5): cut the bench world's worst seed 31.1 ->
    # 14.4 cm with no regression elsewhere (NOTES_ROUND5.md).
    stat_ema: float = 0.5
    # Insert the NEWEST dispatched frame when a keyframe decision fires
    # (False = insert the frame whose stats triggered, the reference's
    # behavior at dispatch depth 0).  With dispatch depth d the trigger
    # frame is d frames stale by the time the insertion lands; promoting
    # the pipeline head restores the reference's decide-on-the-current-
    # frame semantics (Tracking.py:114-167) and absorbs trigger-timing
    # jitter (any trigger within a window inserts ~the same frame).
    # DEFAULT ON (round 5): with stat_ema + auto anticipation it is the
    # measured robust point across fast-translation AND orbit worlds
    # (NOTES_ROUND5.md keyframing table).
    kf_promote_latest: bool = True
    # Anticipate the dispatch lag in the keyframe motion criterion:
    # extrapolate the per-frame motion rate `n` frames ahead before
    # comparing against the threshold, so the trigger fires when the
    # *pipeline head* (not the lag-old resolved frame) crosses it.
    # 0 = off.  -1 = AUTO: n = dispatch_depth when dispatch_depth <= 2,
    # else 0 — rate extrapolation is only trustworthy over a short
    # horizon (measured: ant=2 at dispatch depth 6 moved a bench seed
    # 14.3 -> 20.9 cm, ant=6 -> 19.5 cm, while ant=depth at depth 1-2
    # cut the 400-frame orbit 63.7 -> 25.5 cm); at deep batched dispatch
    # kf_promote_latest already absorbs the staleness.
    kf_anticipate: int = -1


@dataclass
class TrackingConfig:
    device: str = "tpu:0"
    dtype: str = "float32"
    color: str = "gray"
    pyr: PyrConfig = field(default_factory=PyrConfig)
    term_criteria: TermCriteria = field(default_factory=TermCriteria)
    use_motion_model: bool = False  # constant-velocity IC warm start
    keyframing: KeyframingConfig = field(default_factory=KeyframingConfig)
    # ablation switch: False freezes the per-frame affine-brightness states
    # at zero in the IC solve (tests prove they are load-bearing on
    # photometrically real data; the reference always estimates them)
    estimate_affine: bool = True


@dataclass
class GraphConfig:
    num_keyframes: int = 9
    num_one_way_frames: int = 24


@dataclass
class PhotoConstructionConfig:
    """Covisibility-graph construction (reference photo_construction cfg).

    radius/degrees > 0 enables radius keyframe edges + the one-way
    nearest+radius attach mode (reference graph_pair_construction.py:
    37-84, 136-152) and grows the static pair capacity accordingly.
    The reference's pairwise_batch_size has no analog here: the whole
    linearization is one fused program over all pairs, not 128-pair
    chunks."""
    nonmax_suppression_window: int = 4
    radius_thresh: float = 0.0
    degrees_thresh: float = 0.0


@dataclass
class SigmasConfig:
    # (no `photo` sigma: like the reference, the photometric sigma is the
    # per-iteration MAD estimate — photo.py:124-128 — not a config value)
    mean_depth_prior: float = 1e-2
    scale_prior: float = 1e-4
    pose_prior: float = 1e-6
    # call-site sigmas the reference hard-codes (Mapping.py:821,836-852):
    gp_prior: float = 1e0
    log_depth_first: float = 1e0
    log_depth_all: float = 1e0
    pixel_first: float = 1e-2
    pixel_all: float = 3.33e-1
    distill_median: float = 5e-2
    # prior gating modes (reference depth_prior.py / pixel_prior.py)
    log_depth_mode: str = "first_mean"
    pixel_mode: str = "first"
    # robustness guards beyond the reference (gn_step._scaffold/_finish):
    # far-depth landmark reinit threshold (x median depth) and per-iteration
    # landmark trust region (x scene scale)
    far_depth_ratio: float = 50.0
    lm_step_frac: float = 0.25
    # occlusion-aware photometric association: gate dense residuals whose
    # warped point lies > thresh (log-depth) behind the target KF's own GP
    # surface (gn_step._photo; 0 disables)
    occlusion_thresh: float = 0.1


@dataclass
class SamplingConfig:
    mode: str = "greedy_conditional_entropy"
    max_num_coords: int = 64
    max_stdev_thresh: float = 1e-2
    border: int = 3
    fixed_var: float = 0.0
    dist_thresh: float = 1e-1


@dataclass
class CorrConfig:
    corr_mode: str = "logz"
    corr_thresh: float = 3e-2
    distill_with_prior: bool = True
    min_obs_depth: float = 0.0
    logz_grad_mag_thresh: float = 7e-2


@dataclass
class InitConfig:
    start_level: int = 0
    end_level: int = 3
    max_iter: int = 50
    delta_norm: float = 1e-4
    rel_tol: float = 1e-4
    kf_depth_motion_ratio: float = 0.04
    kf_num_pixels_frac: float = 0.75


@dataclass
class MappingConfig:
    device: str = "tpu:0"
    dtype: str = "float32"  # f32 (+ damping) instead of the reference's f64
    color: str = "gray"
    model_path: str = ""    # empty -> analytic structure-tensor prior
    prior: str = "analytic"  # "analytic" | "unet"
    track_ref_num_keyframes: int = 1
    # read for config compatibility; the port ignores it (eager PyTorch
    # compiles no programs, so there is nothing to warm at setup).
    warm_start: bool = True
    graph: GraphConfig = field(default_factory=GraphConfig)
    photo_construction: PhotoConstructionConfig = field(default_factory=PhotoConstructionConfig)
    # grad_norm=0.0 disables the gradient-norm stop for mapping: the BA
    # gradient's scale (D ~ 1.9k stacked residual systems) has nothing to
    # do with TermCriteria's tracking-tuned 1.0 default, so convergence is
    # decided by delta_norm / rel_tol / abs_tol (a deliberate knob, not an
    # inherited one).
    term_criteria: TermCriteria = field(
        default_factory=lambda: TermCriteria(max_iter=20, delta_norm=1e-8,
                                             rel_tol=1e-6, abs_tol=1e-6,
                                             grad_norm=0.0)
    )
    sigmas: SigmasConfig = field(default_factory=SigmasConfig)
    sampling: SamplingConfig = field(default_factory=SamplingConfig)
    corr: CorrConfig = field(default_factory=CorrConfig)
    init: InitConfig = field(default_factory=InitConfig)
    gn_damping: float = 1e-6  # Tikhonov damping on H (f32 safety)
    # multi-device BA: N >= 2 shards the mapping GN step's pair batch over
    # N devices.  0/1 = single-device, the only setting ported so far.
    mesh_devices: int = 0
    # ablation switch mirroring tracking.estimate_affine: False zeroes the
    # affine Jacobian columns in the photometric BA term, freezing all
    # frames' affine states at zero
    estimate_affine: bool = True


@dataclass
class ComoConfig:
    name: str = "como_tpu"
    img_size: List[int] = field(default_factory=lambda: [192, 256])
    # Frames of dispatch depth before a keyframe/one-way decision is
    # resolved (runtime/seq.py): each in-flight frame lets the host enqueue
    # the next frame's work before reading the decision stats, at the cost
    # of decisions landing that many frames later.  1 = the reference's
    # decide-immediately behavior, one frame late.
    dispatch_depth: int = 1
    # resolve the keyframe/one-way decisions of `resolve_stride`
    # dispatched frames in one burst every stride-th frame, at fixed
    # depths [dispatch_depth, dispatch_depth+stride-1] (deterministic).
    # 1 = off.
    resolve_stride: int = 1
    # 2 tracks two consecutive frames plus two mapping GN iterations per
    # dispatch, resolving decisions in pair units.  1 = off.
    frame_batch: int = 1
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)

    def validate(self) -> "ComoConfig":
        assert 1 <= self.dispatch_depth <= 8, "dispatch_depth in [1, 8]"
        assert 1 <= self.resolve_stride <= 4, "resolve_stride in [1, 4]"
        assert self.frame_batch in (1, 2), "frame_batch in {1, 2}"
        if self.frame_batch == 2:
            assert self.dispatch_depth % 2 == 0, \
                "frame_batch 2 resolves decisions in pair units: " \
                "dispatch_depth must be even (pairs in flight = depth/2)"
            assert self.resolve_stride == 1, \
                "frame_batch 2 already bursts decision resolution per " \
                "pair; resolve_stride must stay 1"
        assert self.tracking.pyr.start_level >= 0
        assert self.tracking.pyr.end_level > self.tracking.pyr.start_level
        assert self.mapping.graph.num_keyframes >= 2
        assert self.mapping.sampling.max_num_coords >= 1
        assert self.img_size[0] % (2 ** (self.tracking.pyr.end_level - 1)) == 0, \
            "img height must be divisible by pyramid decimation"
        assert self.img_size[1] % (2 ** (self.tracking.pyr.end_level - 1)) == 0
        assert self.mapping.color in ("gray", "rgb")
        # the reference's float64 mapping is f32 + GN damping here, as in
        # como_tpu; the parity tests hold the port to it in f32.
        assert self.tracking.dtype == "float32", \
            "tracking.dtype: only float32 is supported"
        assert self.mapping.dtype == "float32", \
            "mapping.dtype: the reference's float64 is redesigned as " \
            "float32 + GN damping (see MappingConfig)"
        assert self.mapping.corr.corr_mode in ("z", "logz", "3d")
        assert self.mapping.sampling.mode in ("greedy_conditional_entropy",
                                              "random_uniform")
        assert self.tracking.keyframing.kf_rot_mode in ("sum", "max")
        assert self.tracking.keyframing.kf_anticipate >= -1, \
            "kf_anticipate: -1 (auto), 0 (off), or a positive horizon"
        pc = self.mapping.photo_construction
        assert (pc.radius_thresh > 0.0) == (pc.degrees_thresh > 0.0), \
            "radius mode needs BOTH radius_thresh and degrees_thresh > 0"
        return self


def _merge_dataclass(obj, overrides: Dict[str, Any]):
    for k, v in overrides.items():
        if not hasattr(obj, k):
            raise KeyError(f"unknown config key '{k}' for {type(obj).__name__}")
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _merge_dataclass(cur, v)
        else:
            setattr(obj, k, v)
    return obj


def load_config(path: Optional[str] = None,
                overrides: Optional[Dict[str, Any]] = None) -> ComoConfig:
    """Defaults <- YAML file <- dict overrides, then validate."""
    cfg = ComoConfig()
    if path is not None:
        with open(path) as f:
            data = yaml.safe_load(f) or {}
        _merge_dataclass(cfg, data)
    if overrides:
        _merge_dataclass(cfg, overrides)
    return cfg.validate()
