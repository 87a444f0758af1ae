"""Typed configuration (counterpart of `tpuslam.runtime.config`).

The same frozen dataclass with the same fields and defaults as the JAX
package, so a configuration reads identically in both. Fields whose
behaviour this port does not implement yet are still accepted here;
`frontend.keyframe.perform_keyframe` refuses them by name.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

from tpuslam_torch import compat
from tpuslam_torch.backend.graph import GraphCapacity


@dataclass(frozen=True)
class SlamConfig:
    # --- reference CLI flags ---
    cid: int = 111
    sender_id: int = 120
    detect_cone_id: int = 118
    estimation_id: int = 114
    gathering_time_ms: float = 10.0
    same_cone_threshold: float = 1.2      # association gate [m]
    ref_latitude: float = 57.714787
    ref_longitude: float = 11.948313
    time_between_keyframes_ms: float = 500.0
    cone_mapping_threshold: float = 50.0  # max range to create a landmark [m]
    cones_per_packet: int = 20

    # --- promoted reference constants ---
    odo_info: float = compat.REF_ODOMETRY_INFO
    lm_info: float = compat.REF_LANDMARK_INFO
    loop_closure_radius: float = compat.REF_LOOP_CLOSURE_RADIUS
    loop_closure_min_index: int = compat.REF_LOOP_CLOSURE_MIN_INDEX
    lidar_to_cog: float = compat.REF_LIDAR_TO_COG
    yaw_rate_scale: float = compat.REF_YAW_RATE_SCALE
    gn_iterations: int = compat.REF_GN_ITERATIONS
    gps_outlier_bound: float = compat.REF_GPS_OUTLIER_BOUND

    # --- behavior switches (see tpuslam.runtime.config for each one) ---
    reference_compat: bool = True
    association: str = "first"            # 'first', 'nearest', 'mahalanobis'
    localizer_type_bug: bool = True
    localizer_refine: bool = False
    periodic_gn_every: int = 0
    periodic_gn_iterations: int = 3
    periodic_gn_window: int = 0
    periodic_gn_edge_window: int = 1024
    periodic_gn_window_landmarks: bool = True
    mahalanobis_gate: float = 9.21
    obs_noise_std: float = 0.3
    obs_noise_az_deg: float = 0.3
    vectorized_mapping: bool = True
    mapping_publish_refine: bool = False
    publish_refine_obs_info: float = 25.0
    use_pallas_association: bool = False  # route association through the
                                          # hand-written kernel
                                          # (ops/assoc_kernel.py);
                                          # 'nearest'/'mahalanobis' only
    in_frame_dup_depth: int = 4
    use_ekf_fusion: bool = False
    use_gps_prior: bool = False
    gps_prior_std: float = 0.15
    heading_prior_std: float = 0.05
    gn_matmul_precision: str = "highest"
    gn_early_exit_tol: float = 1e-4

    # --- capacities ---
    capacity: GraphCapacity = field(default_factory=GraphCapacity)
    max_obs_per_frame: int = 64

    def with_(self, **kw) -> "SlamConfig":
        return replace(self, **kw)

    @classmethod
    def improved(cls, **kw) -> "SlamConfig":
        """The JAX package's beats-the-reference configuration, field for
        field (see `tpuslam.runtime.config.SlamConfig.improved`)."""
        base = dict(reference_compat=False, association="nearest",
                    localizer_type_bug=False, localizer_refine=True,
                    use_gps_prior=True, lm_info=100.0, odo_info=1.0,
                    periodic_gn_every=16, periodic_gn_window=64,
                    mapping_publish_refine=True)
        base.update(kw)
        if base["periodic_gn_every"] == 0 and \
                "mapping_publish_refine" not in kw:
            base["mapping_publish_refine"] = False
        return cls(**base)

    @classmethod
    def from_cli_args(cls, args: dict) -> "SlamConfig":
        """Build from reference-style --key=value flags (strings)."""
        m = {
            "cid": ("cid", int), "id": ("sender_id", int),
            "detectConeId": ("detect_cone_id", int),
            "estimationId": ("estimation_id", int),
            "gatheringTimeMs": ("gathering_time_ms", float),
            "sameConeThreshold": ("same_cone_threshold", float),
            "refLatitude": ("ref_latitude", float),
            "refLongitude": ("ref_longitude", float),
            "timeBetweenKeyframes": ("time_between_keyframes_ms", float),
            "coneMappingThreshold": ("cone_mapping_threshold", float),
            "conesPerPacket": ("cones_per_packet", int),
        }
        kw = {}
        for k, v in args.items():
            if k in m:
                name, conv = m[k]
                kw[name] = conv(v)
        return cls(**kw)

    @property
    def gps_reference(self):
        return (self.ref_latitude, self.ref_longitude)
