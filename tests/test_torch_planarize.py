"""The planarisation on the pipeline's device (``ops/planarize.py``) and the
curved lattice formed from it, on the CPU.

* The wrapper's CPU route is, bit for bit, the JAX package's
  ``horayzon_tpu.regrid.planarize`` (a NumPy module) and the port's copy
  of it, its fields as tensors, and launches nothing.  The three meshes
  are those on which the card's tier holds the kernel to the port's copy
  (the JAX package does not run on the card), so the kernel is held to
  the reference on the same inputs.
* ``horizon.curved_lattice``'s box, normals, ramps and lattice mask equal,
  bit for bit, the lattice that the port formed in NumPy on the host
  before it moved to the device (:func:`_numpy_lattice`, kept here as the
  oracle), without a mask and with one.
* ``Terrain.initialise``, ``horizon_locations`` and ``horizon_gridded``
  (``engine="sweep"`` and the fused route) on curved meshes give what the
  NumPy lattice gives: the same fields and results bit for bit.

The kernel is held to ``regrid.planarize`` on the card
(``tests/test_torch_cuda.py -k planariz``).  Imports the JAX package for
its NumPy ``regrid``; about 15 s on one core.
"""

import dataclasses

import numpy as np
import pytest
import torch

from horayzon_tpu import regrid as regrid_ref
from horayzon_tpu_torch import auxiliary, horizon, regrid, shadow
from horayzon_tpu_torch.ops import locations, planarize

from torch_scenes import (PLANARIZE_MESHES, bumps, curved_setup,
                          curved_terrain_inputs, planarize_mesh)

#: The curved scene of the lattice tests: its offset and inner size.
OFFSET, INNER = 24, 64


def _same_bits(got, want):
    """``got`` (a CPU tensor) holds ``want``'s dtype and bits."""
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype != np.bool_:
        got, want = got.view(f"u{got.itemsize}"), want.view(
            f"u{want.itemsize}")
    np.testing.assert_array_equal(got, want)


def _numpy_lattice(x, y, z, vec_norm, offset_0, offset_1, mask=None):
    """``horizon.curved_lattice`` as the port formed it on the host, in
    NumPy float64 from ``regrid.planarize``: the oracle."""
    in0, in1 = vec_norm.shape[:2]
    pg = regrid.planarize(x, y, z)
    hr, wr = pg.grid.shape
    x_in = x[offset_0:offset_0 + in0, offset_1:offset_1 + in1]
    y_in = y[offset_0:offset_0 + in0, offset_1:offset_1 + in1]
    fi_in, fj_in = pg.to_regular_indices(x_in, y_in)
    if mask is not None and (mask == 1).any():
        sel = mask == 1
        fi_b, fj_b = fi_in[sel], fj_in[sel]
    else:
        fi_b, fj_b = fi_in, fj_in
    i_lo = max(int(np.floor(fi_b.min())) - 1, 0)
    i_hi = min(int(np.ceil(fi_b.max())) + 2, hr)
    j_lo = max(int(np.floor(fj_b.min())) - 1, 0)
    j_hi = min(int(np.ceil(fj_b.max())) + 2, wr)
    rin0, rin1 = i_hi - i_lo, j_hi - j_lo
    fi_src = np.clip(pg.fi[i_lo:i_hi, j_lo:j_hi] - offset_0, 0.0, in0 - 1.0)
    fj_src = np.clip(pg.fj[i_lo:i_hi, j_lo:j_hi] - offset_1, 0.0, in1 - 1.0)
    norm_r = regrid._bilinear(vec_norm.astype(np.float64), fi_src, fj_src)
    norm_r /= np.linalg.norm(norm_r, axis=-1, keepdims=True)
    ramp = ((norm_r[..., 0] / norm_r[..., 2]).astype(np.float32),
            (norm_r[..., 1] / norm_r[..., 2]).astype(np.float32))
    lat_mask = None
    if mask is not None and (mask == 1).any():
        lat_mask = np.zeros((rin0, rin1), dtype=np.uint8)
        i0m = np.floor(np.clip(fi_b - i_lo, 0.0, rin0 - 1.0)).astype(np.int64)
        j0m = np.floor(np.clip(fj_b - j_lo, 0.0, rin1 - 1.0)).astype(np.int64)
        for di in (0, 1):
            for dj in (0, 1):
                lat_mask[np.clip(i0m + di, 0, rin0 - 1),
                         np.clip(j0m + dj, 0, rin1 - 1)] = 1
    elif mask is not None:
        lat_mask = np.zeros((rin0, rin1), dtype=np.uint8)
    return dict(pg=pg, box=(i_lo, i_hi, j_lo, j_hi), norm_r=norm_r,
                ramp=ramp, lat_mask=lat_mask, fi=fi_in, fj=fj_in)


def _numpy_lattice_as_tensors(x, y, z, vec_norm, offset_0, offset_1,
                              mask=None, pg=None, *, device="cuda"):
    """:func:`_numpy_lattice` in ``curved_lattice``'s form, taking its
    arguments (``pg`` and ``device`` unused) and returning its fields as
    CPU tensors: what the callers received from the NumPy lattice."""
    lat = _numpy_lattice(x, y, z, vec_norm, offset_0, offset_1, mask)
    pg = lat["pg"]
    lat["pg"] = regrid.PlanarizedGrid(
        grid=pg.grid, **{k: torch.from_numpy(getattr(pg, k))
                         for k in ("z", "valid", "fi", "fj")})
    lat["norm_r"] = torch.from_numpy(lat["norm_r"])
    lat["ramp"] = tuple(torch.from_numpy(r) for r in lat["ramp"])
    if lat["lat_mask"] is not None:
        lat["lat_mask"] = torch.from_numpy(lat["lat_mask"])
    return lat


def _scene(seed=4):
    s = curved_setup(bumps(seed), n=112)
    sl = (slice(OFFSET, OFFSET + INNER),) * 2
    return s, sl


def _island():
    yy, xx = np.mgrid[:INNER, :INNER]
    return ((yy - 30) ** 2 + (xx - 36) ** 2 < 18 ** 2).astype(np.uint8)


# ---------------------------------------------------------------------------
# The wrapper's CPU route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PLANARIZE_MESHES))
def test_cpu_route_is_regrid_planarize(name):
    x, y, z, spacing = planarize_mesh(name)
    n0 = planarize.KERNEL_LAUNCHES
    got = planarize.planarize(x, y, z, spacing, device="cpu")
    assert planarize.KERNEL_LAUNCHES == n0
    for want in (regrid_ref.planarize(x, y, z, spacing),
                 regrid.planarize(x, y, z, spacing)):
        assert dataclasses.astuple(got.grid) == \
            dataclasses.astuple(want.grid)
        for key in ("z", "valid", "fi", "fj"):
            _same_bits(getattr(got, key), getattr(want, key))
        # the corners of the lattice lie outside the warped mesh
        assert 0.9 < want.valid.mean() < 1.0


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, y, z, _ = planarize_mesh("wgs84_north_down", n0=8, n1=9)
    with pytest.raises(ValueError, match="no planarisation"):
        planarize.planarize(x, y, z, device="meta")
    with pytest.raises(ValueError, match="Inconsistent"):
        planarize.planarize(x, y, z[:-1], device="cpu")


# ---------------------------------------------------------------------------
# The curved lattice against the NumPy lattice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_curved_lattice_bit_equal_to_numpy_lattice(masked):
    s, sl = _scene()
    mask = _island() if masked else None
    vec_norm = s["vec_norm"][sl].astype(np.float32)
    got = horizon.curved_lattice(s["x"], s["y"], s["z"], vec_norm, OFFSET,
                                 OFFSET, mask, device="cpu")
    want = _numpy_lattice(s["x"], s["y"], s["z"], vec_norm, OFFSET, OFFSET,
                          mask)
    assert got["box"] == want["box"]
    _same_bits(got["norm_r"], want["norm_r"])
    for a, b in zip(got["ramp"], want["ramp"]):
        _same_bits(a, b)
    if masked:
        _same_bits(got["lat_mask"], want["lat_mask"])
        assert 0 < want["lat_mask"].mean() < 1
    else:
        assert got["lat_mask"] is None
    for key in ("fi", "fj"):
        np.testing.assert_array_equal(got[key], want[key])
    for key in ("z", "fi", "fj"):
        _same_bits(getattr(got["pg"], key), getattr(want["pg"], key))


# ---------------------------------------------------------------------------
# The callers against the NumPy lattice
# ---------------------------------------------------------------------------

def _terrain(s):
    a = curved_terrain_inputs(s, (OFFSET, OFFSET), (INNER, INNER))
    t = shadow.Terrain()
    t.initialise(a["vert_grid"], *a["dem_dim"], OFFSET, OFFSET,
                 a["vec_tilt"], a["vec_norm"], a["surf_enl_fac"],
                 a["elevation"], a["mask"], device="cpu")
    return t


def test_terrain_initialise_curved_as_from_numpy_lattice(monkeypatch):
    s, _ = _scene()
    got = _terrain(s)
    monkeypatch.setattr(horizon, "curved_lattice", _numpy_lattice_as_tensors)
    want = _terrain(s)
    assert got.planarize_s > 0.0
    assert (got.offset, got.comp_shape, got.grid) == (
        want.offset, want.comp_shape, want.grid)
    assert torch.equal(got._z_outer, want._z_outer)
    for key in ("z_org_r", "z_inner_r", "norm_r_z", "xr", "yr"):
        _same_bits(got._fields[key], want._fields[key].numpy())
    for a, b in zip(got._back, want._back):
        assert torch.equal(a, b)
    suns = np.array([[3.0e7, 1.0e7, 1.5e7], [-2.0e7, 2.0e7, 0.8e7]],
                    dtype=np.float32)
    _same_bits(got.sw_dir_cor_batch(suns), want.sw_dir_cor_batch(suns)
               .numpy())


@pytest.mark.parametrize("engine", ["sweep", "auto"])
def test_horizon_gridded_curved_as_from_numpy_lattice(engine, monkeypatch):
    s, sl = _scene()
    n0, n1 = s["z"].shape
    kw = dict(dist_search=1.0, azim_num=4, verbose=False, device="cpu",
              engine=engine, mask=_island() if engine == "auto" else None)
    args = (auxiliary.rearrange_pad_buffer(s["x"], s["y"], s["z"]), n0, n1,
            s["vec_norm"][sl], s["vec_north"][sl], OFFSET, OFFSET)
    got, _ = horizon.horizon_gridded(*args, **kw)
    monkeypatch.setattr(horizon, "curved_lattice", _numpy_lattice_as_tensors)
    want, _ = horizon.horizon_gridded(*args, **kw)
    _same_bits(got, want.numpy())


def test_horizon_locations_curved_as_from_numpy_lattice():
    s, _ = _scene()
    n0, n1 = s["z"].shape
    cells = [(40, 44), (60, 70), (75, 52)]
    coords = np.array([[s["x"][c], s["y"][c], s["z"][c]] for c in cells],
                      dtype=np.float32)
    vn = np.array([s["vec_norm"][c] for c in cells], dtype=np.float32)
    vno = np.array([s["vec_north"][c] for c in cells], dtype=np.float32)
    vg = auxiliary.rearrange_pad_buffer(s["x"], s["y"], s["z"])
    hori, dist, azim = horizon.horizon_locations(
        vg, n0, n1, coords, vn, vno, 4.0, azim_num=16, hori_dist_out=True,
        device="cpu")
    # the NumPy route: regrid.planarize's lattice to the sweep
    x, y, z = (a.astype(np.float32) for a in (s["x"], s["y"], s["z"]))
    pg = regrid.planarize(x, y, z)
    want = locations.horizon_locations_sweep(
        torch.from_numpy(pg.z), pg.grid, coords, vn, vno,
        horizon.azimuth_angles(16), 4000.0, 0.25, -89.98,
        np.full(len(cells), 0.01, np.float32))
    assert torch.equal(hori, want[0]) and torch.equal(dist, want[1])
    assert azim.shape == (16,)
