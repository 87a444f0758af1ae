"""VLP-16 lidar decoding: raw UDP packets and PointCloudReading messages.
A copy of `tpuslam.perception.vlp16` (numpy only). The loader of the
calibration XML (`tpuslam/perception/calib.py`) is not ported yet.

The reference pipeline's point clouds come from a `proxy-velodyne16` service
(reference usecase/docker-compose.yml:19-28) configured by a boost-serialized
calibration (usecase/VLP-16.xml — distance LSB 0.2 cm, zero mounting offsets)
and are shipped either via shared memory or as compact
`opendlv.proxy.PointCloudReading` messages (odvd:160-166: per-azimuth
distance blocks for 16 beams, optional intensity bits).

Decoders here are NumPy (host ingest); the downstream cone detection
(tpuslam_torch.perception.attention) is PyTorch and runs on the card.

VLP-16 wire format (public Velodyne manual): 1206-byte payloads of 12 data
blocks; each block = 0xFFEE flag + 2-byte azimuth (centi-degrees) + 32
(distance uint16 [2 mm], intensity uint8) records = two 16-beam firing
sequences; beams interleave elevations -15..+15 degrees in 2-degree steps.
"""
from __future__ import annotations

import struct

import numpy as np

# Firing order of the 16 beams (channel index -> elevation degrees)
VLP16_ELEVATIONS_DEG = np.array([
    -15, 1, -13, 3, -11, 5, -9, 7, -7, 9, -5, 11, -3, 13, -1, 15,
], dtype=np.float64)

PACKET_SIZE = 1206
BLOCKS_PER_PACKET = 12
CHANNELS = 16
DISTANCE_RESOLUTION_M = 0.002  # 2 mm per count


def decode_packet(payload: bytes):
    """One 1206-byte packet -> (azimuth_deg [24,16], elev_deg [16],
    distance_m [24,16], intensity [24,16]).

    24 firing sequences (2 per block); azimuth for the second firing of each
    block is interpolated as the sensor's own decoding software does.
    """
    if len(payload) < PACKET_SIZE:
        raise ValueError(f"short packet: {len(payload)}")
    raw = np.frombuffer(payload[:1200], dtype=np.uint8).reshape(12, 100)
    flags = raw[:, 0].astype(np.uint16) | (raw[:, 1].astype(np.uint16) << 8)
    if not np.all(flags == 0xEEFF):
        raise ValueError("bad block flags")
    az = (raw[:, 2].astype(np.float64) + raw[:, 3].astype(np.float64) * 256) / 100.0
    records = raw[:, 4:].reshape(12, 2, 16, 3)
    dist = (records[..., 0].astype(np.float64)
            + records[..., 1].astype(np.float64) * 256) * DISTANCE_RESOLUTION_M
    inten = records[..., 2].astype(np.float64)

    # interpolate the second firing's azimuth
    az_next = np.roll(az, -1)
    gap = (az_next - az) % 360.0
    gap[-1] = gap[-2] if len(gap) > 1 else 0.0
    az2 = (az + gap / 2.0) % 360.0
    azimuths = np.stack([az, az2], axis=1).reshape(24)  # [24]
    return (np.repeat(azimuths[:, None], CHANNELS, axis=1),
            VLP16_ELEVATIONS_DEG.copy(),
            dist.reshape(24, 16), inten.reshape(24, 16))


def encode_packet(azimuths_deg, distances_m, intensities=None) -> bytes:
    """Inverse of decode_packet for the simulator: 12 blocks from 24 firings."""
    az = np.asarray(azimuths_deg, dtype=np.float64).reshape(24, 16)
    dist = np.asarray(distances_m, dtype=np.float64).reshape(24, 16)
    inten = np.zeros((24, 16)) if intensities is None else \
        np.asarray(intensities).reshape(24, 16)
    out = bytearray()
    for b in range(12):
        out += struct.pack("<H", 0xEEFF)
        out += struct.pack("<H", int(round(az[2 * b, 0] * 100)) % 36000)
        for f in range(2):
            for c in range(16):
                d = int(round(dist[2 * b + f, c] / DISTANCE_RESOLUTION_M))
                out += struct.pack("<HB", min(d, 0xFFFF), int(inten[2 * b + f, c]))
    out += b"\x00" * 6  # timestamp + factory bytes (unused)
    assert len(out) == PACKET_SIZE
    return bytes(out)


def spherical_to_xyz(azimuth_deg, elevation_deg, distance_m):
    """Velodyne convention: azimuth clockwise from +y in the sensor frame;
    we map to the vehicle convention used by the attention service
    (x forward, y left): x = d*cos(el)*cos(az), y = d*cos(el)*sin(-az)."""
    az = np.radians(np.asarray(azimuth_deg, dtype=np.float64))
    el = np.radians(np.asarray(elevation_deg, dtype=np.float64))
    d = np.asarray(distance_m, dtype=np.float64)
    ce = np.cos(el)
    x = d * ce * np.cos(az)
    y = -d * ce * np.sin(az)
    z = d * np.sin(el)
    return np.stack([x, y, z], axis=-1)


def packet_to_points(payload: bytes, min_range=0.5):
    """Packet -> (points [N,3], intensity [N]) with zero/short returns dropped."""
    az, elev, dist, inten = decode_packet(payload)
    elev_full = np.broadcast_to(elev[None, :], dist.shape)
    pts = spherical_to_xyz(az, elev_full, dist)
    keep = dist.reshape(-1) > min_range
    return pts.reshape(-1, 3)[keep], inten.reshape(-1)[keep]


def decode_point_cloud_reading(msg, elevations=VLP16_ELEVATIONS_DEG,
                               calib=None):
    """opendlv.proxy.PointCloudReading -> (points [N,3], intensity [N]|None).

    Compact format (odvd:160-166): `distances` holds interleaved uint16
    distance counts (0.2 cm LSB per the usecase calibration, usecase/
    VLP-16.xml distLSB_=0.2) for `entriesPerAzimuth` beams per azimuth step,
    azimuth linearly spaced start..end. Pass `calib`
    (perception.calib.load_calibration of the real XML) to take the distance
    LSB and per-laser vertical angles from the shipped calibration instead
    of the transcribed constants.
    """
    data = msg.distances
    if isinstance(data, str):
        data = data.encode("latin-1")
    n_beams = int(msg.entriesPerAzimuth) or 16
    dist_lsb_m = DISTANCE_RESOLUTION_M
    if calib is not None:
        dist_lsb_m = calib.dist_lsb_m
        elevations = calib.elevations_for_channels(n_beams)
    counts = np.frombuffer(data, dtype=">u2").astype(np.float64)
    n_az = len(counts) // n_beams
    counts = counts[: n_az * n_beams].reshape(n_az, n_beams)
    dist_m = counts * dist_lsb_m
    az = np.linspace(msg.startAzimuth, msg.endAzimuth, n_az)
    elev = elevations[:n_beams]
    pts = spherical_to_xyz(np.repeat(az[:, None], n_beams, 1),
                           np.broadcast_to(elev[None, :], dist_m.shape), dist_m)
    keep = dist_m.reshape(-1) > 0.5
    return pts.reshape(-1, 3)[keep], None
