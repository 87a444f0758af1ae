"""OpenDLV message types used by the SLAM service, with wire schemas: a
copy of `tpuslam.io.messages` (pure Python), so that the port imports
nothing of the JAX package; `tests/test_torch_io.py` holds the two
byte-equal.

The reference compiles these from the ODVD DSL at build time via cluon-msc
(reference CMakeLists.txt:57-70, schema
src/opendlv-standard-message-set-v0.9.5.odvd). Here each message is a plain
dataclass plus a field-spec table that drives the generic proto codec in
tpuslam_torch.io.proto — same wire format, no codegen step.

Field numbers/types are transcribed from the schema:
- ObjectDirection [1133] (odvd:294-298), ObjectDistance [1134] (:300-303),
  ObjectType [1131] (:284-287), Geolocation [1116] (:262-267),
  GeodeticWgs84Reading [19] (:145-148), GeodeticHeadingReading [1051]
  (:141-143), AngularVelocityReading [1031] (:77-81).
- cluon internal: TimeStamp [12], Envelope [1]
  (reference src/cluon-complete-build.hpp:8199, 8234).
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import ClassVar

# wire kinds understood by the codec
VARINT_SIGNED = "varint_signed"   # zigzag varint (int8..int64)
VARINT_UNSIGNED = "varint_unsigned"
FLOAT = "float"                   # 4-byte LE, wire type 5
DOUBLE = "double"                 # 8-byte LE, wire type 1
STRING = "string"                 # length-delimited, wire type 2
MESSAGE = "message"               # nested message, length-delimited

MESSAGE_REGISTRY: dict[int, type] = {}

# fallback declared-ODVD-type per wire kind, for message classes without an
# ODVD_TYPES entry (shared by the ODVD emitter and the LCM codec so the
# emitted spec text and the LCM hash can never diverge)
WIRE_KIND_TO_ODVD = {VARINT_SIGNED: "int32", VARINT_UNSIGNED: "uint32",
                     FLOAT: "float", DOUBLE: "double", STRING: "string"}


def register(cls):
    MESSAGE_REGISTRY[cls.ID] = cls
    return cls


def spec(cls):
    """(field_number, wire_kind, attr_name, nested_type|None) per field."""
    return cls.FIELDS


@register
@dataclass
class TimeStamp:
    ID: ClassVar[int] = 12
    LONG_NAME: ClassVar[str] = "cluon.data.TimeStamp"
    ODVD_TYPES: ClassVar = {"seconds": "int32", "microseconds": "int32"}
    FIELDS: ClassVar = [(1, VARINT_SIGNED, "seconds", None),
                        (2, VARINT_SIGNED, "microseconds", None)]
    seconds: int = 0
    microseconds: int = 0

    @classmethod
    def from_micros(cls, us: int) -> "TimeStamp":
        return cls(seconds=int(us // 1_000_000), microseconds=int(us % 1_000_000))

    @property
    def micros(self) -> int:
        return self.seconds * 1_000_000 + self.microseconds


@register
@dataclass
class Envelope:
    ID: ClassVar[int] = 1
    LONG_NAME: ClassVar[str] = "cluon.data.Envelope"
    ODVD_TYPES: ClassVar = {"dataType": "int32", "serializedData": "bytes",
                            "senderStamp": "uint32"}
    FIELDS: ClassVar = [(1, VARINT_SIGNED, "dataType", None),
                        (2, STRING, "serializedData", None),
                        (3, MESSAGE, "sent", TimeStamp),
                        (4, MESSAGE, "received", TimeStamp),
                        (5, MESSAGE, "sampleTimeStamp", TimeStamp),
                        (6, VARINT_UNSIGNED, "senderStamp", None)]
    dataType: int = 0
    serializedData: bytes = b""
    sent: TimeStamp = field(default_factory=TimeStamp)
    received: TimeStamp = field(default_factory=TimeStamp)
    sampleTimeStamp: TimeStamp = field(default_factory=TimeStamp)
    senderStamp: int = 0


@register
@dataclass
class GeodeticWgs84Reading:
    ID: ClassVar[int] = 19
    LONG_NAME: ClassVar[str] = "opendlv.proxy.GeodeticWgs84Reading"
    ODVD_TYPES: ClassVar = {"latitude": "double", "longitude": "double"}
    FIELDS: ClassVar = [(1, DOUBLE, "latitude", None),
                        (3, DOUBLE, "longitude", None)]
    latitude: float = 0.0
    longitude: float = 0.0


@register
@dataclass
class AngularVelocityReading:
    ID: ClassVar[int] = 1031
    LONG_NAME: ClassVar[str] = "opendlv.proxy.AngularVelocityReading"
    ODVD_TYPES: ClassVar = {"angularVelocityX": "float",
                            "angularVelocityY": "float",
                            "angularVelocityZ": "float"}
    FIELDS: ClassVar = [(1, FLOAT, "angularVelocityX", None),
                        (2, FLOAT, "angularVelocityY", None),
                        (3, FLOAT, "angularVelocityZ", None)]
    angularVelocityX: float = 0.0
    angularVelocityY: float = 0.0
    angularVelocityZ: float = 0.0


@register
@dataclass
class GeodeticHeadingReading:
    ID: ClassVar[int] = 1051
    LONG_NAME: ClassVar[str] = "opendlv.proxy.GeodeticHeadingReading"
    ODVD_TYPES: ClassVar = {"northHeading": "float"}
    FIELDS: ClassVar = [(1, FLOAT, "northHeading", None)]
    northHeading: float = 0.0


@register
@dataclass
class Geolocation:
    ID: ClassVar[int] = 1116
    LONG_NAME: ClassVar[str] = "opendlv.logic.sensation.Geolocation"
    ODVD_TYPES: ClassVar = {"latitude": "double", "longitude": "double",
                            "altitude": "float", "heading": "float"}
    FIELDS: ClassVar = [(1, DOUBLE, "latitude", None),
                        (2, DOUBLE, "longitude", None),
                        (3, FLOAT, "altitude", None),
                        (4, FLOAT, "heading", None)]
    latitude: float = 0.0
    longitude: float = 0.0
    altitude: float = 0.0
    heading: float = 0.0


@register
@dataclass
class ObjectType:
    ID: ClassVar[int] = 1131
    LONG_NAME: ClassVar[str] = "opendlv.logic.perception.ObjectType"
    ODVD_TYPES: ClassVar = {"objectId": "uint32", "type": "uint32"}
    FIELDS: ClassVar = [(1, VARINT_UNSIGNED, "objectId", None),
                        (2, VARINT_UNSIGNED, "type", None)]
    objectId: int = 0
    type: int = 0


@register
@dataclass
class ObjectDirection:
    ID: ClassVar[int] = 1133
    LONG_NAME: ClassVar[str] = "opendlv.logic.perception.ObjectDirection"
    ODVD_TYPES: ClassVar = {"objectId": "uint32", "azimuthAngle": "float",
                            "zenithAngle": "float"}
    FIELDS: ClassVar = [(1, VARINT_UNSIGNED, "objectId", None),
                        (2, FLOAT, "azimuthAngle", None),
                        (3, FLOAT, "zenithAngle", None)]
    objectId: int = 0
    azimuthAngle: float = 0.0
    zenithAngle: float = 0.0


@register
@dataclass
class ObjectDistance:
    ID: ClassVar[int] = 1134
    LONG_NAME: ClassVar[str] = "opendlv.logic.perception.ObjectDistance"
    ODVD_TYPES: ClassVar = {"objectId": "uint32", "distance": "float"}
    FIELDS: ClassVar = [(1, VARINT_UNSIGNED, "objectId", None),
                        (2, FLOAT, "distance", None)]
    objectId: int = 0
    distance: float = 0.0


@register
@dataclass
class PointCloudReading:
    """opendlv.proxy.PointCloudReading [49] (odvd:160-166): compact per-
    azimuth distance blocks from the VLP-16 proxy."""
    ID: ClassVar[int] = 49
    LONG_NAME: ClassVar[str] = "opendlv.proxy.PointCloudReading"
    ODVD_TYPES: ClassVar = {"startAzimuth": "float", "endAzimuth": "float",
                            "entriesPerAzimuth": "uint8",
                            "distances": "bytes",
                            "numberOfBitsForIntensity": "uint8"}
    FIELDS: ClassVar = [(1, FLOAT, "startAzimuth", None),
                        (2, FLOAT, "endAzimuth", None),
                        (3, VARINT_UNSIGNED, "entriesPerAzimuth", None),
                        (4, STRING, "distances", None),
                        (5, VARINT_UNSIGNED, "numberOfBitsForIntensity", None)]
    startAzimuth: float = 0.0
    endAzimuth: float = 0.0
    entriesPerAzimuth: int = 0
    distances: bytes = b""
    numberOfBitsForIntensity: int = 0


@register
@dataclass
class PlayerCommand:
    """cluon.data.PlayerCommand [9]: remote control of a .rec replay
    (reference src/cluon-complete-build.hpp:4110-4162, 8300; handled by
    cluon-replay at :15888-16035). command: 1=play, 2=pause, 3=seekTo."""
    ID: ClassVar[int] = 9
    LONG_NAME: ClassVar[str] = "cluon.data.PlayerCommand"
    ODVD_TYPES: ClassVar = {"command": "uint8", "seekTo": "float"}
    FIELDS: ClassVar = [(1, VARINT_UNSIGNED, "command", None),
                        (2, FLOAT, "seekTo", None)]
    command: int = 0
    seekTo: float = 0.0


@register
@dataclass
class PlayerStatus:
    """cluon.data.PlayerStatus [10]: replay progress report (reference
    src/cluon-complete-build.hpp:4274-4335, 8335; emitted by Player every
    10th replayed envelope at :13600-13618). state: 1=loading, 2=playback."""
    ID: ClassVar[int] = 10
    LONG_NAME: ClassVar[str] = "cluon.data.PlayerStatus"
    ODVD_TYPES: ClassVar = {"state": "uint8", "numberOfEntries": "uint32",
                            "currentEntryForPlayback": "uint32"}
    FIELDS: ClassVar = [(1, VARINT_UNSIGNED, "state", None),
                        (2, VARINT_UNSIGNED, "numberOfEntries", None),
                        (3, VARINT_UNSIGNED, "currentEntryForPlayback", None)]
    state: int = 0
    numberOfEntries: int = 0
    currentEntryForPlayback: int = 0


@dataclass
class GenericMessage:
    """Runtime-typed fallback for unknown dataTypes (cluon GenericMessage
    analogue, reference src/cluon-complete-build.hpp:7245)."""
    dataType: int = 0
    values: dict = field(default_factory=dict)
