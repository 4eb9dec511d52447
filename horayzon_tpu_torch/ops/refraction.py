# Copyright (c) 2026
# MIT License
"""Atmospheric refraction of the sun vector (Saemundsson 1986) in torch.

Counterpart of :mod:`horayzon_tpu.ops.refraction`: the reference's
refraction path (shadow_comp.cpp:135-159 ``atmos_refrac``, :109-132
``vec_rot`` Rodrigues rotation, and the reference atmosphere constants of
CppTerrain::initialise, shadow_comp.cpp:348-354).  Elementwise float32 on
the device of the input tensors, in the reference's operation order.  Every
division is a tensor over a tensor (:func:`_div`): torch forms
``scalar / tensor`` as ``tensor.reciprocal() * scalar`` and, on CUDA,
``tensor / scalar`` as a product with the scalar's reciprocal, each of
which rounds twice where the reference's division rounds once.
"""

import math

import torch

# Reference atmosphere (shadow_comp.cpp:348-354)
TEMPERATURE_REF = 283.15     # reference sea-level temperature [K]
PRESSURE_REF = 101.0         # reference sea-level pressure [kPa]
LAPSE_RATE = 0.0065          # temperature lapse rate [K m-1]
_G = 9.81                    # gravity [m s-2]
_R_D = 287.0                 # gas constant for dry air [J K-1 kg-1]
BAROMETRIC_EXP = _G / (_R_D * LAPSE_RATE)

_DEG2RAD = math.pi / 180.0
_RAD2DEG = 180.0 / math.pi


def _div(num, den):
    """``num / den`` rounded once: a Python number on either side becomes
    a 0-dim float32 tensor on the other side's device."""
    if not isinstance(num, torch.Tensor):
        num = torch.tensor(num, dtype=torch.float32, device=den.device)
    if not isinstance(den, torch.Tensor):
        den = torch.tensor(den, dtype=torch.float32, device=num.device)
    return num / den


def dot3(a, b):
    """Sum over the last axis (of length 3) of ``a * b``, in index order."""
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


def atmos_refrac(elev_ang_true_deg, temp_degc, pressure_kpa):
    """Refraction correction [degree] (shadow_comp.cpp:135-159).

    Saemundsson's formula with the pressure/temperature scaling of Meeus
    (1998, p. 106); input elevation angle clamped to [-1, 90] degrees.
    Tensors or numbers; float32 tensors stay float32."""
    e = torch.clamp(torch.as_tensor(elev_ang_true_deg, dtype=torch.float32),
                    -1.0, 90.0)
    temp_degc, pressure_kpa = (
        torch.as_tensor(v, dtype=torch.float32, device=e.device)
        for v in (temp_degc, pressure_kpa))
    refrac = _div(1.02, torch.tan((e + _div(10.3, e + 5.11)) * _DEG2RAD))
    refrac = refrac + 0.0019279   # R = 0 at h = 90 degrees
    refrac = refrac * _div(pressure_kpa, 101.0) \
        * _div(283.0, 273.0 + temp_degc)
    return _div(refrac, 60.0)


def reference_atmosphere(elevation):
    """Temperature [K] and pressure [kPa] of the reference atmosphere at
    ``elevation`` [metre] (shadow_comp.cpp:348-354)."""
    temperature = TEMPERATURE_REF - LAPSE_RATE * elevation
    pressure = PRESSURE_REF * _div(temperature, TEMPERATURE_REF) \
        ** BAROMETRIC_EXP
    return temperature, pressure


def rodrigues_rotate(k, theta, v):
    """Rotate vectors ``v`` about unit axes ``k`` by angle ``theta`` [radian].

    Vectorised Rodrigues rotation (shadow_comp.cpp:109-132); ``k`` and ``v``
    have components in the last dimension, ``theta`` broadcasts."""
    cos_t = torch.cos(theta)[..., None]
    sin_t = torch.sin(theta)[..., None]
    kdotv = dot3(k, v)[..., None]
    return (v * cos_t + _cross(k, v) * sin_t
            + k * kdotv * (1.0 - cos_t))


def refract_sun_vector(sun_vec, vec_norm, elevation):
    """Apply atmospheric refraction to per-cell sun unit vectors.

    Mirrors the in-loop refraction of shadow_comp.cpp:430-446: the true
    solar elevation from the surface-normal dot product, the reference
    atmosphere's temperature and pressure at the cell's elevation, and the
    sun vector rotated upwards (about ``sun x norm``) by the refraction
    angle.

    ``sun_vec`` (..., 3) unit vectors towards the sun, ``vec_norm`` (..., 3)
    surface-normal unit vectors, ``elevation`` (...,) orthometric elevation
    [metre]."""
    dot_ns = dot3(vec_norm, sun_vec)
    elev_true = 90.0 - torch.arccos(torch.clamp(dot_ns, -1.0, 1.0)) \
        * _RAD2DEG
    temperature, pressure = reference_atmosphere(elevation)
    refrac_deg = atmos_refrac(elev_true, temperature - 273.15, pressure)
    axis = _cross(sun_vec, vec_norm)
    norm = torch.sqrt(dot3(axis, axis).double()).float()[..., None]
    axis = axis / torch.clamp_min(norm, 1.0e-20)
    return rodrigues_rotate(axis, refrac_deg * _DEG2RAD, sun_vec)
