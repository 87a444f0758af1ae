"""The vendored OpenDLV standard message set v0.9.5 — all 62 messages.

A copy of `tpuslam.io.standard_message_set` (pure Python), so that the port imports nothing of
the JAX package.

The reference vendors the ODVD schema file and compiles it to C++ classes
at build time via cluon-msc (reference CMakeLists.txt:57-70, schema
src/opendlv-standard-message-set-v0.9.5.odvd:1-362). tpuslam ships the
same specification as this generated data table (message name, numeric id,
field (name, id, odvd type) triples — wire-compatibility constants), so a
standalone deployment can decode/encode, JSON-convert, and `slamctl msc`
every standard message without the reference checkout.

Regenerate: parse the upstream .odvd with tpuslam_torch.io.odvd.parse_odvd and
dump the (name, id, fields) triples; `standard_odvd_text()` emits the spec
back out through the ODVD emitter (round-trips through parse_odvd).
"""
from __future__ import annotations

VERSION = "0.9.5"

# (long_name, message_id, ((field_name, field_id, odvd_type), ...))
STANDARD_MESSAGES = (
    ("opendlv.sim.Frame", 1001, (
        ("x", 1, "float"),
        ("y", 2, "float"),
        ("z", 3, "float"),
        ("roll", 4, "float"),
        ("pitch", 5, "float"),
        ("yaw", 6, "float"),
    )),
    ("opendlv.sim.KinematicState", 1002, (
        ("vx", 1, "float"),
        ("vy", 2, "float"),
        ("vz", 3, "float"),
        ("rollRate", 4, "float"),
        ("pitchRate", 5, "float"),
        ("yawRate", 6, "float"),
    )),
    ("opendlv.body.ComponentInfo", 1021, (
        ("description", 1, "string"),
        ("x", 2, "float"),
        ("y", 3, "float"),
        ("z", 4, "float"),
    )),
    ("opendlv.body.ActuatorInfo", 1022, (
        ("description", 1, "string"),
        ("x", 2, "float"),
        ("y", 3, "float"),
        ("z", 4, "float"),
        ("signalId", 5, "uint32"),
        ("minValue", 6, "float"),
        ("maxValue", 7, "float"),
    )),
    ("opendlv.body.SensorInfo", 1023, (
        ("description", 1, "string"),
        ("x", 2, "float"),
        ("y", 3, "float"),
        ("z", 4, "float"),
        ("signalId", 5, "uint32"),
        ("accuracyStd", 6, "float"),
        ("minFrequency", 7, "uint16"),
    )),
    ("opendlv.body.SignalInfo", 1024, (
        ("description", 1, "string"),
        ("signalId", 2, "uint32"),
        ("accuracyStd", 3, "float"),
        ("minFrequency", 4, "uint16"),
    )),
    ("opendlv.proxy.AccelerationReading", 1030, (
        ("accelerationX", 1, "float"),
        ("accelerationY", 2, "float"),
        ("accelerationZ", 3, "float"),
    )),
    ("opendlv.proxy.AngularVelocityReading", 1031, (
        ("angularVelocityX", 1, "float"),
        ("angularVelocityY", 2, "float"),
        ("angularVelocityZ", 3, "float"),
    )),
    ("opendlv.proxy.MagneticFieldReading", 1032, (
        ("magneticFieldX", 1, "float"),
        ("magneticFieldY", 2, "float"),
        ("magneticFieldZ", 3, "float"),
    )),
    ("opendlv.proxy.AltitudeReading", 1033, (
        ("altitude", 1, "float"),
    )),
    ("opendlv.proxy.PressureReading", 1034, (
        ("pressure", 1, "float"),
    )),
    ("opendlv.proxy.TemperatureReading", 1035, (
        ("temperature", 1, "float"),
    )),
    ("opendlv.proxy.TorqueReading", 1036, (
        ("torque", 1, "float"),
    )),
    ("opendlv.proxy.VoltageReading", 1037, (
        ("voltage", 1, "float"),
    )),
    ("opendlv.proxy.AngleReading", 1038, (
        ("angle", 1, "float"),
    )),
    ("opendlv.proxy.DistanceReading", 1039, (
        ("distance", 1, "float"),
    )),
    ("opendlv.proxy.SwitchStateReading", 1040, (
        ("state", 1, "int16"),
    )),
    ("opendlv.proxy.PedalPositionReading", 1041, (
        ("position", 1, "float"),
    )),
    ("opendlv.proxy.GroundSteeringReading", 1045, (
        ("groundSteering", 1, "float"),
    )),
    ("opendlv.proxy.GroundSpeedReading", 1046, (
        ("groundSpeed", 1, "float"),
    )),
    ("opendlv.proxy.WheelSpeedReading", 1047, (
        ("wheelSpeed", 1, "float"),
    )),
    ("opendlv.proxy.WeightReading", 1050, (
        ("weight", 1, "float"),
    )),
    ("opendlv.proxy.GeodeticHeadingReading", 1051, (
        ("northHeading", 1, "float"),
    )),
    ("opendlv.proxy.GeodeticWgs84Reading", 19, (
        ("latitude", 1, "double"),
        ("longitude", 3, "double"),
    )),
    ("opendlv.proxy.ImageReadingShared", 14, (
        ("name", 1, "string"),
        ("size", 2, "uint32"),
        ("width", 3, "uint32"),
        ("height", 4, "uint32"),
        ("bytesPerPixel", 5, "uint32"),
    )),
    ("opendlv.proxy.PointCloudReading", 49, (
        ("startAzimuth", 1, "float"),
        ("endAzimuth", 2, "float"),
        ("entriesPerAzimuth", 3, "uint8"),
        ("distances", 4, "bytes"),
        ("numberOfBitsForIntensity", 5, "uint8"),
    )),
    ("opendlv.proxy.PointCloudReadingShared", 28, (
        ("name", 1, "string"),
        ("size", 2, "uint32"),
        ("width", 3, "uint32"),
        ("height", 4, "uint32"),
        ("numberOfComponentsPerPoint", 5, "uint8"),
    )),
    ("opendlv.proxy.PressureRequest", 1080, (
        ("pressure", 1, "float"),
    )),
    ("opendlv.proxy.TemperatureRequest", 1081, (
        ("temperature", 1, "float"),
    )),
    ("opendlv.proxy.TorqueRequest", 1082, (
        ("torque", 1, "float"),
    )),
    ("opendlv.proxy.VoltageRequest", 1083, (
        ("voltage", 1, "float"),
    )),
    ("opendlv.proxy.AngleRequest", 1084, (
        ("angle", 1, "float"),
    )),
    ("opendlv.proxy.SwitchStateRequest", 1085, (
        ("state", 1, "int16"),
    )),
    ("opendlv.proxy.PedalPositionRequest", 1086, (
        ("position", 1, "float"),
    )),
    ("opendlv.proxy.PulseWidthModulationRequest", 1087, (
        ("dutyCycleNs", 1, "uint32"),
    )),
    ("opendlv.proxy.GroundSteeringRequest", 1090, (
        ("groundSteering", 1, "float"),
    )),
    ("opendlv.proxy.GroundSpeedRequest", 1091, (
        ("groundSpeed", 1, "float"),
    )),
    ("opendlv.proxy.GroundAccelerationRequest", 1092, (
        ("groundAcceleration", 1, "float"),
    )),
    ("opendlv.proxy.GroundDecelerationRequest", 1093, (
        ("groundDeceleration", 1, "float"),
    )),
    ("opendlv.proxy.WheelSpeedRequest", 1094, (
        ("wheelSpeed", 1, "float"),
    )),
    ("opendlv.system.SignalStatusMessage", 1100, (
        ("code", 1, "int32"),
        ("description", 2, "string"),
    )),
    ("opendlv.system.SystemOperationState", 1101, (
        ("code", 1, "int32"),
        ("description", 2, "string"),
    )),
    ("opendlv.system.NetworkStatusMessage", 1102, (
        ("code", 1, "int32"),
        ("description", 2, "string"),
    )),
    ("opendlv.logic.sensation.Direction", 1110, (
        ("azimuthAngle", 1, "float"),
        ("zenithAngle", 2, "float"),
    )),
    ("opendlv.logic.sensation.Point", 1111, (
        ("azimuthAngle", 1, "float"),
        ("zenithAngle", 2, "float"),
        ("distance", 3, "float"),
    )),
    ("opendlv.logic.sensation.Geolocation", 1116, (
        ("latitude", 1, "double"),
        ("longitude", 2, "double"),
        ("altitude", 3, "float"),
        ("heading", 4, "float"),
    )),
    ("opendlv.logic.sensation.Equilibrioception", 1017, (
        ("vx", 1, "float"),
        ("vy", 2, "float"),
        ("vz", 3, "float"),
        ("rollRate", 4, "float"),
        ("pitchRate", 5, "float"),
        ("yawRate", 6, "float"),
    )),
    ("opendlv.logic.perception.Object", 1130, (
        ("objectId", 1, "uint32"),
    )),
    ("opendlv.logic.perception.ObjectType", 1131, (
        ("objectId", 1, "uint32"),
        ("type", 2, "uint32"),
    )),
    ("opendlv.logic.perception.ObjectProperty", 1132, (
        ("objectId", 1, "uint32"),
        ("property", 2, "string"),
    )),
    ("opendlv.logic.perception.ObjectDirection", 1133, (
        ("objectId", 1, "uint32"),
        ("azimuthAngle", 2, "float"),
        ("zenithAngle", 3, "float"),
    )),
    ("opendlv.logic.perception.ObjectDistance", 1134, (
        ("objectId", 1, "uint32"),
        ("distance", 2, "float"),
    )),
    ("opendlv.logic.perception.ObjectAngularBlob", 1135, (
        ("objectId", 1, "uint32"),
        ("width", 2, "float"),
        ("height", 3, "float"),
    )),
    ("opendlv.logic.perception.GroundSurface", 1140, (
        ("surfaceId", 1, "uint32"),
    )),
    ("opendlv.logic.perception.GroundSurfaceType", 1141, (
        ("surfaceId", 1, "uint32"),
        ("type", 2, "uint32"),
    )),
    ("opendlv.logic.perception.GroundSurfaceProperty", 1142, (
        ("surfaceId", 1, "uint32"),
        ("property", 2, "string"),
    )),
    ("opendlv.logic.perception.GroundSurfaceArea", 1143, (
        ("surfaceId", 1, "uint32"),
        ("x1", 2, "float"),
        ("y1", 3, "float"),
        ("x2", 4, "float"),
        ("y2", 5, "float"),
        ("x3", 6, "float"),
        ("y3", 7, "float"),
        ("x4", 8, "float"),
        ("y4", 9, "float"),
    )),
    ("opendlv.logic.action.AimDirection", 1171, (
        ("azimuthAngle", 1, "float"),
        ("zenithAngle", 2, "float"),
    )),
    ("opendlv.logic.action.AimPoint", 1172, (
        ("azimuthAngle", 1, "float"),
        ("zenithAngle", 2, "float"),
        ("distance", 3, "float"),
    )),
    ("opendlv.logic.action.PreviewPoint", 1173, (
        ("azimuthAngle", 1, "float"),
        ("zenithAngle", 2, "float"),
        ("distance", 3, "float"),
    )),
    ("opendlv.logic.cognition.GroundSteeringLimit", 1191, (
        ("steeringLimit", 1, "float"),
    )),
    ("opendlv.logic.cognition.GroundSpeedLimit", 1192, (
        ("speedLimit", 1, "float"),
    )),
)


def to_specs():
    """Materialize tpuslam_torch.io.odvd.MessageSpec objects from the table."""
    from tpuslam_torch.io.odvd import MessageSpec, _TYPE_MAP
    out = []
    for name, ident, fields in STANDARD_MESSAGES:
        fs = [(fid, _TYPE_MAP[t][0], fname, None) for fname, fid, t in fields]
        types = {fname: t for fname, fid, t in fields}
        out.append(MessageSpec(name=name, ident=ident, fields=fs,
                               odvd_types=types))
    return out


def build_classes(register: bool = False):
    """Proto-codable dataclasses for every standard message.

    With register=True, ids not already claimed by the hand-written
    tpuslam_torch.io.messages classes are added to MESSAGE_REGISTRY (the hand
    specs win: they carry convenience constructors the generated ones lack;
    test_io.py::test_standard_set_consistency proves they are
    field-identical to this table).
    """
    from tpuslam_torch.io.odvd import build_message_classes
    return build_message_classes(to_specs(), register=register)


def standard_odvd_text() -> str:
    """The full .odvd specification text, regenerated through the ODVD
    emitter (tpuslam_torch.io.odvd.message_to_odvd). Round-trips through
    parse_odvd; feed it to `slamctl msc` or EnvelopeConverter standalone."""
    from tpuslam_torch.io.odvd import message_to_odvd
    classes = build_classes(register=False)
    return "\n".join(message_to_odvd(c) for c in classes.values())
