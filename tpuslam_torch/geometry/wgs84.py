"""WGS84 <-> local Cartesian via the reference's Mercator-style projection
(counterpart of `tpuslam.geometry.wgs84`): its float64 numpy functions
copied as they are, and the on-device forward in PyTorch.

Re-implements the math of reference src/WGS84toCartesian.hpp:
- `to_cartesian`: closed-form forward projection (WGS84 ellipsoid meridional
  arc series, reference :39-110). Host numpy in float64 — geodetic inputs
  need ~1e-9 deg resolution which float32 cannot carry, so this runs on the
  host; the SLAM engine itself works entirely in the local Cartesian frame.
- `from_cartesian`: the reference uses an iterative 1e-5-deg hill climb to
  ~1 cm (reference :117-146). We provide (a) `from_cartesian` — a fast
  Newton/secant inverse accurate to <1e-10 deg, and (b)
  `from_cartesian_compat` — a faithful re-expression of the reference's
  stepping loop for parity testing.

A torch forward (`to_cartesian_torch`, the JAX package's
`to_cartesian_jnp`) and the float32-safe `local_projector` exist for
fully-on-device pipelines where centimeter resolution near the reference
point suffices.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["to_cartesian", "from_cartesian", "from_cartesian_compat", "to_cartesian_torch",
           "local_projector"]

_DEG2RAD = np.pi / 180.0
_EQUATOR_RADIUS = 6378137.0
_FLATTENING = 1.0 / 298.257223563
_ES = 2.0 * _FLATTENING - _FLATTENING * _FLATTENING  # squared eccentricity

# Meridional-arc series coefficients (reference src/WGS84toCartesian.hpp:54-73)
_C02, _C04, _C06, _C08 = 0.25, 0.046875, 0.01953125, 0.01068115234375
_C22, _C44 = 0.75, 0.46875
_C46, _C48 = 0.01302083333333333333, 0.00712076822916666666
_C66, _C68 = 0.36458333333333333333, 0.00569661458333333333
_C88 = 0.3076171875

_R0 = 1.0 - _ES * (_C02 + _ES * (_C04 + _ES * (_C06 + _ES * _C08)))
_R1 = _ES * (_C22 - _ES * (_C04 + _ES * (_C06 + _ES * _C08)))
_R2T = _ES * _ES
_R2 = _R2T * (_C44 - _ES * (_C46 + _ES * _C48))
_R3T = _R2T * _ES
_R3 = _R3T * (_C66 - _ES * _C68)
_R4 = _R3T * _ES * _C88


def _mlfn(lat, xp):
    sin_phi = xp.sin(lat)
    cos_phi = xp.cos(lat) * sin_phi
    s2 = sin_phi * sin_phi
    return _R0 * lat - cos_phi * (_R1 + s2 * (_R2 + s2 * (_R3 + s2 * _R4)))


def _forward(ref_lat_deg, ref_lon_deg, lat_deg, lon_deg, xp):
    """Shared forward-projection body (numpy or torch)."""
    ml0 = _mlfn(ref_lat_deg * _DEG2RAD, xp)
    lat = lat_deg * _DEG2RAD
    lon = (lon_deg - ref_lon_deg) * _DEG2RAD
    sin_lat = xp.sin(lat)
    # ms = cos(lat)/sqrt(1-es*sin^2)/sin(lat); guard the lat≈0 singular branch
    safe_sin = xp.where(xp.abs(sin_lat) > 1e-10, sin_lat, 1.0)
    ms = xp.cos(lat) / xp.sqrt(1.0 - _ES * sin_lat * sin_lat) / safe_sin
    lon_s = lon * sin_lat
    x_curved = _EQUATOR_RADIUS * ms * xp.sin(lon_s)
    y_curved = _EQUATOR_RADIUS * ((_mlfn(lat, xp) - ml0) + ms * (1.0 - xp.cos(lon_s)))
    # lat == 0 limit: equatorial plate carree
    x_flat = _EQUATOR_RADIUS * lon
    y_flat = _EQUATOR_RADIUS * (-ml0) * xp.ones_like(x_flat)
    near_equator = xp.abs(lat) < 1e-10
    x = xp.where(near_equator, x_flat, x_curved)
    y = xp.where(near_equator, y_flat, y_curved)
    return x, y


def to_cartesian(reference, position):
    """WGS84 (lat, lon) -> local Cartesian (x, y) meters about `reference`.

    Bit-parity with reference src/WGS84toCartesian.hpp:39-110 for positions
    within the projection's valid range (|lon offset| <= 10 rad).
    """
    ref = np.asarray(reference, dtype=np.float64)
    pos = np.asarray(position, dtype=np.float64)
    x, y = _forward(ref[..., 0], ref[..., 1], pos[..., 0], pos[..., 1], np)
    return np.stack([x, y], axis=-1)


def _cos_phi_term(lat, xp):
    """The oscillatory part of the meridional arc: mlfn(lat) = R0*lat - this."""
    sin_phi = xp.sin(lat)
    cos_phi = xp.cos(lat) * sin_phi
    s2 = sin_phi * sin_phi
    return cos_phi * (_R1 + s2 * (_R2 + s2 * (_R3 + s2 * _R4)))


def local_projector(reference):
    """Host factory -> float32-safe on-device WGS84 forward projection.

    A naive f32 evaluation of the meridional arc cancels 6.4e6-scale terms and
    loses ~0.6 m. This factory precomputes the reference-latitude terms in
    float64 on the host and returns a closure over *offsets*
    (dlat_deg, dlon_deg) that only ever combines O(1e4)-magnitude quantities,
    keeping f32 error at the centimeter level. The closure takes tensors
    (of any device) and computes in their dtype.
    """
    lat0_deg = float(np.asarray(reference, dtype=np.float64)[0])
    lat0 = lat0_deg * _DEG2RAD
    cterm0 = float(_cos_phi_term(np.float64(lat0), np))

    def project(dlat_deg, dlon_deg):
        """Offsets in degrees from the reference -> local (x, y) meters."""
        dlat = dlat_deg * _DEG2RAD
        lon = dlon_deg * _DEG2RAD
        lat = lat0 + dlat
        sin_lat = torch.sin(lat)
        safe_sin = torch.where(torch.abs(sin_lat) > 1e-10, sin_lat, 1.0)
        ms = torch.cos(lat) / torch.sqrt(1.0 - _ES * sin_lat * sin_lat) / safe_sin
        lon_s = lon * sin_lat
        x = _EQUATOR_RADIUS * ms * torch.sin(lon_s)
        mlfn_diff = _R0 * dlat + (cterm0 - _cos_phi_term(lat, torch))
        y = _EQUATOR_RADIUS * (mlfn_diff + ms * (1.0 - torch.cos(lon_s)))
        return torch.stack([x, y], dim=-1)

    return project


def to_cartesian_torch(reference, position):
    """torch forward projection (float precision follows inputs; the JAX
    package's `to_cartesian_jnp`).

    For float32 device pipelines prefer `local_projector` — this direct form
    cancels 6.4e6-scale meridional-arc terms and is only ~1 m accurate in f32.
    """
    ref = torch.as_tensor(reference)
    pos = torch.as_tensor(position, device=ref.device)
    x, y = _forward(ref[..., 0], ref[..., 1], pos[..., 0], pos[..., 1], torch)
    return torch.stack([x, y], dim=-1)


def from_cartesian(reference, cartesian, tol=1e-12, max_iter=8):
    """Local Cartesian (x, y) -> WGS84 (lat, lon) via damped secant iteration.

    Replaces the reference's 1e-5-deg fixed-step hill climb (~1 cm, ~O(10^4)
    projection evaluations for 100 m offsets — reference
    src/WGS84toCartesian.hpp:117-146) with a secant solve per axis that
    converges to <1e-10 deg in a handful of evaluations.
    """
    ref = np.asarray(reference, dtype=np.float64)
    target = np.asarray(cartesian, dtype=np.float64)
    guess = ref.copy().astype(np.float64)
    # y depends almost purely on lat, x on lon; alternate secant solves per
    # axis, two rounds to absorb the weak cross-coupling.
    for _round in range(2):
        for axis, coord in ((0, 1), (1, 0)):  # (lat from y), (lon from x)
            step = 1e-5
            for _ in range(max_iter):
                f0 = to_cartesian(ref, guess)[..., coord] - target[..., coord]
                probe = guess.copy()
                probe[..., axis] = probe[..., axis] + step
                f1 = to_cartesian(ref, probe)[..., coord] - target[..., coord]
                denom = np.where(np.abs(f1 - f0) < 1e-15, 1e-15, f1 - f0)
                delta = -f0 * step / denom
                guess[..., axis] = guess[..., axis] + delta
                if np.all(np.abs(delta) < tol):
                    break
    return guess


def from_cartesian_compat(reference, cartesian, eps=1e-2, inc=1e-5):
    """Reference-faithful iterative inverse (1e-5-deg steps to ~1 cm).

    Mirrors reference src/WGS84toCartesian.hpp:117-146 exactly, including the
    stop condition `(d < dPrev) && (d > eps)` and per-axis stepping order
    (latitude from y first, then longitude from x).
    """
    ref = np.asarray(reference, dtype=np.float64)
    cart = np.asarray(cartesian, dtype=np.float64)
    sign_lon = -1 if cart[0] < 0 else 1
    sign_lat = -1 if cart[1] < 0 else 1
    approx = ref.copy()
    result = to_cartesian(ref, approx)

    d_prev, d = np.inf, abs(cart[1] - result[1])
    while d < d_prev and d > eps:
        approx[0] += sign_lat * inc
        result = to_cartesian(ref, approx)
        d_prev, d = d, abs(cart[1] - result[1])

    d_prev, d = np.inf, abs(cart[0] - result[0])
    while d < d_prev and d > eps:
        approx[1] += sign_lon * inc
        result = to_cartesian(ref, approx)
        d_prev, d = d, abs(cart[0] - result[0])
    return approx
