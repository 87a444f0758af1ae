"""Reference-compatibility constants and quirk transforms. A copy of
`tpuslam.compat` (numpy only), so that the port imports nothing of the JAX
package; `tests/test_torch_sim.py` holds the two equal.

The reference implementation has several numerically quirky behaviors that
define the trajectory we must match (SURVEY.md §7 "Behavioral spec notes").
They are isolated here so the clean math elsewhere stays clean; the engine
applies them only when ``SlamConfig.reference_compat`` is set.

Quirks reproduced (with reference file:line provenance):
- DEG2RAD is the slightly-off constant 0.017453292522222, not pi/180
  (reference src/slam.hpp:134).
- PI is the double-ified float literal 3.14159265f (reference src/slam.hpp:136),
  used in the heading remap and the lidar->CoG lever-arm law of cosines.
- Incoming north heading is remapped by -PI and wrapped to (-PI, PI]
  (reference src/slam.cpp:179-181).
- IMU yaw rate is scaled by 1/4 (reference src/slam.cpp:216) and *subtracted*
  over the elapsed time when 0 < dt < 1 s (reference src/slam.cpp:315-317).
- Outbound azimuth mixes units: atan2 in radians * RAD2DEG minus
  heading/RAD2DEG (reference src/cone.cpp:37-39).
"""
from __future__ import annotations

import numpy as np

# reference src/slam.hpp:134-136
REF_DEG2RAD = 0.017453292522222
REF_RAD2DEG = 57.295779513082325
REF_PI = float(np.float32(3.14159265))  # 3.1415927410125732; double(3.14159265f)

# Hard-coded reference magic numbers, promoted to config fields in
# tpuslam_torch.runtime.config but with these defaults:
REF_ODOMETRY_INFO = 5.0          # Matrix3d::Identity()*5   (src/slam.cpp:456)
REF_LANDMARK_INFO = 0.01         # Matrix2d::Identity()*0.01 (src/slam.cpp:546)
REF_LOOP_CLOSURE_RADIUS = 1.0    # (src/slam.cpp:702)
REF_LOOP_CLOSURE_MIN_INDEX = 20  # (src/slam.cpp:702)
REF_LIDAR_TO_COG = 1.5           # meters (src/slam.cpp:514)
REF_YAW_RATE_SCALE = 0.25        # angularVelocityZ/4 (src/slam.cpp:216)
REF_GN_ITERATIONS = 10           # optimize(10) (src/slam.cpp:481)
REF_GPS_OUTLIER_BOUND = 200.0    # |x|,|y| guard (src/slam.cpp:300-303)


def remap_north_heading(heading):
    """Reference heading remap: h - PI wrapped to (-PI, PI].

    reference src/slam.cpp:179-181 (uses the float-precision PI).
    """
    h = heading - REF_PI
    h = np.where(h > REF_PI, h - 2 * REF_PI, h)
    h = np.where(h < -REF_PI, h + 2 * REF_PI, h)
    return h


def outbound_azimuth_deg(cone_xy, pose):
    """Reference outbound azimuth with its rad/deg unit mixture.

    reference src/cone.cpp:34-44: azimuth = atan2(dy,dx)*RAD2DEG - heading/RAD2DEG
    (the heading term is heading*(1/RAD2DEG), i.e. treated as if converting
    deg->rad even though the pose heading is radians).
    """
    dx = cone_xy[..., 0] - pose[..., 0]
    dy = cone_xy[..., 1] - pose[..., 1]
    return np.arctan2(dy, dx) * REF_RAD2DEG - pose[..., 2] / REF_RAD2DEG
