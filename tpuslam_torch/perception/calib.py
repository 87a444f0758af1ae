"""Velodyne calibration XML parser (the reference's usecase/VLP-16.xml).

A copy of `tpuslam.perception.calib` (pure Python), so that the port imports nothing of
the JAX package.

The reference ships a boost-serialized Velodyne calibration consumed by the
proxy-velodyne16 service (reference usecase/docker-compose.yml:19-28,
usecase/VLP-16.xml — 1,709 lines): a `DB` record with the distance LSB in
centimeters, sensor mounting position/orientation, and 64 per-laser `px`
records (rotCorrection_, vertCorrection_, distCorrection_, offsets...); a
VLP-16 uses the first 16. This module parses that exact format so real
calibrations drive the point-cloud decode instead of the transcribed
constants in tpuslam_torch.perception.vlp16.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np

__all__ = ["Vlp16Calibration", "load_calibration", "nominal_vlp16_db_xml",
           "write_nominal_calibration", "default_calibration_path"]


@dataclass
class Vlp16Calibration:
    dist_lsb_m: float                    # meters per distance count
    position_xyz: np.ndarray             # [3] sensor mounting position
    orientation_rpy: np.ndarray          # [3] sensor mounting orientation
    laser_id: np.ndarray                 # [K] int
    rot_correction_deg: np.ndarray       # [K]
    vert_correction_deg: np.ndarray      # [K]
    dist_correction_m: np.ndarray        # [K]
    vert_offset_m: np.ndarray            # [K]
    horiz_offset_m: np.ndarray           # [K]
    min_intensity: np.ndarray = field(default_factory=lambda: np.zeros(0))
    max_intensity: np.ndarray = field(default_factory=lambda: np.zeros(0))

    @property
    def n_lasers(self) -> int:
        return len(self.laser_id)

    def elevations_for_channels(self, channels: int = 16) -> np.ndarray:
        """Vertical angles in *firing order* for the first `channels` lasers
        (VLP-16 packets index channels by firing order = laser id)."""
        order = np.argsort(self.laser_id[:channels])
        return self.vert_correction_deg[:channels][order]


def _floats(node, tag):
    sub = node.find(tag)
    if sub is None:
        return np.zeros(0)
    return np.array([float(i.text) for i in sub.findall("item")
                     if i.text is not None])


def nominal_vlp16_db_xml(lasers: int = 64) -> str:
    """Regenerate the nominal (factory-default) Velodyne DB calibration XML.

    The reference's shipped usecase/VLP-16.xml carries no per-unit data at
    all: distLSB 0.2 cm, zero mounting position/orientation, zero rot/dist/
    offset corrections, min/max intensity 0/255, and the standard VLP-16
    vertical angle set (-15..+15 deg interleaved, in firing order) on lasers
    0-15 and again on 16-31, zeros beyond — i.e. the stock sensor datasheet
    values in the boost-serialization DB schema the proxy consumes. This
    emitter re-derives that file from the datasheet constants
    (tpuslam_torch.perception.vlp16.VLP16_ELEVATIONS_DEG) so the repo is
    standalone; `load_calibration` round-trips it bit-for-bit on every field
    it reads (tests/test_perception.py cross-checks against the reference
    copy when one is present).
    """
    vert = np.zeros(lasers)
    n16 = VLP16_FIRING_ORDER_DEG.shape[0]
    for base in (0, 16):
        if base + n16 <= min(lasers, 32):
            vert[base:base + n16] = VLP16_FIRING_ORDER_DEG
    out = [
        '<?xml version="1.0" encoding="UTF-8" standalone="yes" ?>',
        "<!DOCTYPE boost_serialization>",
        "<!-- nominal VLP-16 calibration REGENERATED from datasheet "
        "constants by tpuslam.perception.calib.nominal_vlp16_db_xml "
        "(stock sensor values in the boost-serialization DB schema; "
        "field-parity with the reference's shipped copy is tested) -->",
        '<boost_serialization signature="serialization::archive" '
        'version="4">',
        '<DB class_id="0" tracking_level="1" version="0" object_id="_0">',
        "\t<distLSB_>0.2</distLSB_>",
    ]

    def vec3(tag, inner, cid):
        out.append(f'\t<{tag} class_id="{cid}" tracking_level="0" '
                   'version="0">')
        out.append(f"\t\t<{inner}>")
        out.append("\t\t\t<count>3</count>")
        for _ in range(3):
            out.append("\t\t\t<item>0</item>")
        out.append(f"\t\t</{inner}>")
        out.append(f"\t</{tag}>")

    vec3("position_", "xyz", 1)
    vec3("orientation_", "rpy", 2)

    def scalar_list(tag, value):
        out.append(f"\t<{tag}>")
        out.append(f"\t\t<count>{lasers}</count>")
        out.append("\t\t<item_version>0</item_version>")
        for _ in range(lasers):
            out.append(f"\t\t<item>{value}</item>")
        out.append(f"\t</{tag}>")

    scalar_list("minIntensity_", 0)
    scalar_list("maxIntensity_", 255)

    out.append('\t<points_ class_id="7" tracking_level="0" version="0">')
    out.append(f"\t\t<count>{lasers}</count>")
    out.append("\t\t<item_version>1</item_version>")
    for i in range(lasers):
        if i == 0:
            out.append('\t\t<item class_id="8" tracking_level="0" '
                       'version="1">')
            out.append('\t\t\t<px class_id="9" tracking_level="1" '
                       f'version="1" object_id="_{i + 1}">')
        else:
            out.append("\t\t<item>")
            out.append('\t\t\t<px class_id_reference="9" '
                       f'object_id="_{i + 1}">')
        v = vert[i]
        vtxt = str(int(v)) if float(v).is_integer() else repr(float(v))
        out.append(f"\t\t\t\t<id_>{i}</id_>")
        out.append("\t\t\t\t<rotCorrection_>0</rotCorrection_>")
        out.append(f"\t\t\t\t<vertCorrection_>{vtxt}</vertCorrection_>")
        for tag in ("distCorrection_", "distCorrectionX_",
                    "distCorrectionY_", "vertOffsetCorrection_",
                    "horizOffsetCorrection_", "focalDistance_",
                    "focalSlope_"):
            out.append(f"\t\t\t\t<{tag}>0</{tag}>")
        out.append("\t\t\t</px>")
        out.append("\t\t</item>")
    out.append("\t</points_>")
    out.append("</DB>")
    out.append("</boost_serialization>")
    return "\n".join(out) + "\n"


#: the VLP-16's 16 vertical angles in firing order (datasheet; matches
#: tpuslam_torch.perception.vlp16.VLP16_ELEVATIONS_DEG)
VLP16_FIRING_ORDER_DEG = np.array(
    [-15, 1, -13, 3, -11, 5, -9, 7, -7, 9, -5, 11, -3, 13, -1, 15],
    dtype=np.float64)


def write_nominal_calibration(path: str, lasers: int = 64) -> None:
    with open(path, "w") as f:
        f.write(nominal_vlp16_db_xml(lasers))


def default_calibration_path() -> str:
    """The vendored nominal VLP-16 calibration shipped with the package
    (regenerated from datasheet constants — see nominal_vlp16_db_xml)."""
    return os.path.join(os.path.dirname(__file__), "data", "VLP-16.xml")


def load_calibration(path: str) -> Vlp16Calibration:
    """Parse a boost-serialized Velodyne calibration XML."""
    root = ET.parse(path).getroot()
    db = root.find("DB")
    if db is None:
        raise ValueError("not a Velodyne calibration file (no DB node)")
    dist_lsb_cm = float(db.findtext("distLSB_", default="0.2"))

    pos = db.find("position_/xyz")
    position = np.array([float(i.text) for i in pos.findall("item")]) \
        if pos is not None else np.zeros(3)
    rpy = db.find("orientation_/rpy")
    orientation = np.array([float(i.text) for i in rpy.findall("item")]) \
        if rpy is not None else np.zeros(3)

    ids, rot, vert, dist, voff, hoff = [], [], [], [], [], []
    points = db.find("points_")
    if points is not None:
        for item in points.findall("item"):
            px = item.find("px")
            if px is None:
                continue
            ids.append(int(px.findtext("id_", default="0")))
            rot.append(float(px.findtext("rotCorrection_", default="0")))
            vert.append(float(px.findtext("vertCorrection_", default="0")))
            # distance corrections are centimeters in the Velodyne format
            dist.append(float(px.findtext("distCorrection_", default="0")) / 100.0)
            voff.append(float(px.findtext("vertOffsetCorrection_", default="0")) / 100.0)
            hoff.append(float(px.findtext("horizOffsetCorrection_", default="0")) / 100.0)

    min_i = _floats(db, "minIntensity_")
    max_i = _floats(db, "maxIntensity_")
    return Vlp16Calibration(
        dist_lsb_m=dist_lsb_cm / 100.0,
        position_xyz=position, orientation_rpy=orientation,
        laser_id=np.asarray(ids, np.int32),
        rot_correction_deg=np.asarray(rot),
        vert_correction_deg=np.asarray(vert),
        dist_correction_m=np.asarray(dist),
        vert_offset_m=np.asarray(voff),
        horiz_offset_m=np.asarray(hoff),
        min_intensity=min_i, max_intensity=max_i,
    )
