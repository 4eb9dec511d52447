"""The TIN far field on the card (``ops/tin_raster.py``, kernel R1 in
``csrc/tin_raster.cu``), on the CPU.

* A NumPy model of R1's decomposition, :func:`r1_model`, on the wrapper's
  host scalars (``tin_raster.lattice``), is bit-equal to
  ``multires.coarse_grid_from_tin``: every (triangle, raster point) pair
  takes its float32 height straight into its coarse cell, with no raster;
  each triangle scatters its own three vertices; then the fine overlay;
  the triangles in a shuffled order.  Ratios 1-4 (``sub`` below ``r`` at
  3 and 4), an odd fine shape, a regular two-per-quad TIN and an
  irregular one with slivers, ``|d| < 1e-12`` triangles, triangles larger
  than the lattice, partly or wholly outside it.
* ``tin_raster.lattice`` gives the raster's origin, spacing and shape that
  ``coarse_grid_from_tin`` hands ``rasterize_tin``, and its offset; where
  the 2e8 cap lowers ``sub``, too (shown without a raster).
* ``horizon``'s TIN route on the CPU still calls
  ``multires.coarse_grid_from_tin`` (and not the card's wrapper), with the
  triangles cut to ``num_tri_simp``, on which the model is bit-equal too.
* The parameter block mirrors the kernel's struct; the wrapper refuses a
  device other than CUDA and what the kernel cannot take.

The kernel itself is held to ``coarse_grid_from_tin`` on the card
(``tests/test_torch_cuda.py -k tin_raster``).  Imports no JAX; about 10 s
on one core.
"""

import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

from horayzon_tpu_torch import auxiliary, horizon
from horayzon_tpu_torch.ops import mip, multires, tin_raster
from horayzon_tpu_torch.terrain import GridSpec

from torch_scenes import TIN_KINDS, tin_far_field_scene


def _same_bits(got, want):
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def r1_model(vert_simp, tri_ind_simp, lat, z_fine, order):
    """R1 and its overlay in NumPy float64, as the kernel decomposes the
    work: the triangles in ``order``; each scatters its three vertices into
    their coarse cells and takes the float32 height of each raster point
    of its box that lies inside it straight into the point's coarse cell
    (``np.maximum.at``); then the fine grid's max-pooled blocks over their
    window.  Every expression is the kernel's, on the scalars of
    ``lat`` (a ``tin_raster.Lattice``)."""
    verts = np.asarray(vert_simp, dtype=np.float32).reshape(-1, 3)
    tris = np.asarray(tri_ind_simp).reshape(-1, 3)
    v64 = verts.astype(np.float64)
    x0, y0 = lat.corner
    sx, sy = lat.spacing
    cx, cy = lat.coarse_spacing
    sub = lat.sub
    h, w = lat.n_i * sub, lat.n_j * sub
    zc = np.full((lat.n_i, lat.n_j), mip.PAD_VALUE, dtype=np.float32)
    for t in order:
        k = tris[t]
        vi = (v64[k, 1] - y0) / sy
        vj = (v64[k, 0] - x0) / sx
        fi = np.floor((v64[k, 1] - y0) / cy)
        fj = np.floor((v64[k, 0] - x0) / cx)
        ok = (fi >= 0) & (fi < lat.n_i) & (fj >= 0) & (fj < lat.n_j)
        np.maximum.at(zc, (fi[ok].astype(int), fj[ok].astype(int)),
                      verts[k[ok], 2])
        i_lo = max(np.ceil(vi.min() - 1.0e-9), 0.0)
        i_hi = min(np.floor(vi.max() + 1.0e-9), h - 1.0)
        j_lo = max(np.ceil(vj.min() - 1.0e-9), 0.0)
        j_hi = min(np.floor(vj.max() + 1.0e-9), w - 1.0)
        if i_hi < i_lo or j_hi < j_lo:
            continue
        dib, djb = vi[1] - vi[0], vj[1] - vj[0]
        dic, djc = vi[2] - vi[0], vj[2] - vj[0]
        d = dib * djc - djb * dic
        if abs(d) < 1.0e-12:
            continue
        ii, jj = np.meshgrid(np.arange(int(i_lo), int(i_hi) + 1),
                             np.arange(int(j_lo), int(j_hi) + 1),
                             indexing="ij")
        di = ii - vi[0]
        dj = jj - vj[0]
        wb = (di * djc - dj * dic) / d
        wc = (dj * dib - di * djb) / d
        wa = (1.0 - wb) - wc
        inside = (wa >= -1.0e-6) & (wb >= -1.0e-6) & (wc >= -1.0e-6)
        z = ((wa * v64[k[0], 2] + wb * v64[k[1], 2])
             + wc * v64[k[2], 2]).astype(np.float32)
        np.maximum.at(zc, (ii[inside] // sub, jj[inside] // sub),
                      z[inside])
    r = lat.r
    hf, wf = z_fine.shape
    hp, wp = hf - hf % r, wf - wf % r
    pooled = z_fine[:hp, :wp].reshape(hp // r, r, wp // r, r).max(
        axis=(1, 3))
    c = lat.pad_c
    zc[c:c + hp // r, c:c + wp // r] = np.maximum(
        zc[c:c + hp // r, c:c + wp // r], pooled)
    return zc


def _copy(verts, tris, grid, z_fine, ratio_log2, dist_search=300.0):
    return multires.coarse_grid_from_tin(
        verts, tris, grid=grid, fine_shape=z_fine.shape, z_fine=z_fine,
        ratio_log2=ratio_log2, dist_search=dist_search)


@pytest.mark.parametrize("ratio_log2", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", TIN_KINDS)
def test_r1_model_bit_equal_to_the_copy(kind, ratio_log2):
    verts, tris, grid, z_fine = tin_far_field_scene(kind, ratio_log2)
    want, offset = _copy(verts, tris, grid, z_fine, ratio_log2)
    lat = tin_raster.lattice(grid, z_fine.shape, ratio_log2, 300.0)
    assert lat.offset == offset and want.shape == (lat.n_i, lat.n_j)
    assert lat.sub == min(lat.r, 4)
    order = np.random.default_rng(ratio_log2).permutation(len(tris) // 3)
    got = r1_model(verts, tris, lat, z_fine, order)
    _same_bits(got, want)
    # the scene reaches every part of the rule: cells the triangles
    # raised, cells only the fill holds, the overlay's window
    assert (want > mip.PAD_VALUE).mean() > 0.5
    assert (want == np.float32(mip.PAD_VALUE)).any() or kind == "irregular"


def _captured_raster(monkeypatch, raise_it=False):
    """``multires.rasterize_tin`` replaced by a recorder of its keywords
    (raising before any raster if ``raise_it``)."""
    seen = []

    class Stop(Exception):
        pass

    def record(vert_simp, tri_ind_simp, **kw):
        seen.append(kw)
        if raise_it:
            raise Stop
        return np.full(kw["shape"], mip.PAD_VALUE, dtype=np.float32)

    monkeypatch.setattr(multires, "rasterize_tin", record)
    return seen, Stop


@pytest.mark.parametrize("ratio_log2", [1, 2, 3, 4])
def test_lattice_is_the_copys(monkeypatch, ratio_log2):
    verts, tris, grid, z_fine = tin_far_field_scene("regular", ratio_log2,
                                                    fine_shape=(41, 30))
    seen, _ = _captured_raster(monkeypatch)
    _, offset = _copy(verts, tris, grid, z_fine, ratio_log2, 470.0)
    lat = tin_raster.lattice(grid, z_fine.shape, ratio_log2, 470.0)
    assert seen == [dict(origin_xy=lat.corner, spacing_xy=lat.spacing,
                         shape=(lat.n_i * lat.sub, lat.n_j * lat.sub))]
    assert offset == lat.offset == (lat.pad_c * lat.r,) * 2
    assert lat.coarse_spacing == (grid.dx * lat.r, grid.dy * lat.r)


@pytest.mark.parametrize("ratio_log2, sub", [(2, 2), (3, 1)])
def test_cap_lowers_sub_as_the_copy_does(monkeypatch, ratio_log2, sub):
    """A search distance whose raster at 4 x 4 points a coarse cell would
    pass 2e8 points: ``sub`` halves as in the copy, which is stopped
    before it allocates its raster."""
    grid = GridSpec(x0=2600001.0, y0=1199999.0, dx=1.0, dy=-1.0,
                    shape=(64, 64))
    dist = {2: 8000.0, 3: 30000.0}[ratio_log2]
    seen, stop = _captured_raster(monkeypatch, raise_it=True)
    with pytest.raises(stop):
        multires.coarse_grid_from_tin(
            np.zeros(9, np.float32), np.arange(3, dtype=np.int32),
            grid=grid, fine_shape=(64, 64), z_fine=None,
            ratio_log2=ratio_log2, dist_search=dist)
    lat = tin_raster.lattice(grid, (64, 64), ratio_log2, dist)
    assert lat.sub == sub < 4
    assert seen == [dict(origin_xy=lat.corner, spacing_xy=lat.spacing,
                         shape=(lat.n_i * lat.sub, lat.n_j * lat.sub))]
    assert (lat.n_i * lat.sub) ** 2 <= tin_raster.MAX_RASTER_POINTS


def _tin_run(num_tri_simp):
    """``horizon_gridded`` on the CPU over a small fine grid (96^2 at 25
    m, 16^2 inner cells) and the regular far-field scene, its TIN cut to
    ``num_tri_simp`` triangles.  Returns the whole index list."""
    n, inner, off = 96, 16, 40
    verts, tris, grid, _ = tin_far_field_scene("regular", 2,
                                               fine_shape=(n, n), dx=25.0,
                                               dist_search=600.0)
    z = np.random.default_rng(3).uniform(0.0, 300.0, (n, n)).astype(
        np.float32)
    xx, yy = np.meshgrid(
        (grid.x0 + grid.dx * np.arange(n)).astype(np.float32),
        (grid.y0 + grid.dy * np.arange(n)).astype(np.float32))
    vec_norm = np.zeros((inner, inner, 3), np.float32)
    vec_norm[..., 2] = 1.0
    vec_north = np.zeros((inner, inner, 3), np.float32)
    vec_north[..., 1] = 1.0
    horizon.horizon_gridded(
        auxiliary.rearrange_pad_buffer(xx, yy, z), n, n, vec_norm,
        vec_north, off, off, 0.6, azim_num=4, hori_acc=2.0, verbose=False,
        device="cpu", vert_simp=verts, num_vert_simp=len(verts) // 3,
        tri_ind_simp=tris, num_tri_simp=num_tri_simp)
    return tris


def test_cpu_route_calls_the_copy_with_the_cut_triangles(monkeypatch):
    calls = []
    orig = multires.coarse_grid_from_tin

    def spy(verts, tris, **kw):
        out = orig(verts, tris, **kw)
        calls.append((verts, tris, kw, out))
        return out

    def refuse(*args, **kwargs):
        raise AssertionError("the CPU route launched the card's far field")

    monkeypatch.setattr(multires, "coarse_grid_from_tin", spy)
    monkeypatch.setattr(tin_raster, "coarse_grid", refuse)
    all_tris = _tin_run(num_tri_simp=100)
    assert len(calls) == 1
    verts, tris, kw, (want, offset) = calls[0]
    np.testing.assert_array_equal(tris, all_tris[:300])
    # the vertices only the dropped triangles use are not scattered
    assert np.setdiff1d(all_tris, tris).size > 0
    lat = tin_raster.lattice(kw["grid"], kw["fine_shape"], kw["ratio_log2"],
                             kw["dist_search"])
    assert lat.offset == offset
    order = np.random.default_rng(5).permutation(100)
    _same_bits(r1_model(verts, tris, lat, np.asarray(kw["z_fine"]), order),
               want)


def test_params_block_mirrors_the_kernel_struct():
    """``_TrParams`` lists ``struct TrParams``'s fields in order, with the
    same types (the library also compares the two sizes when it loads)."""
    src = (pathlib.Path(tin_raster.__file__).resolve().parent.parent
           / "csrc" / "tin_raster.cu").read_text()
    body = re.search(r"struct TrParams \{(.*?)\};", src, re.S).group(1)
    fields = []
    for kind, names in re.findall(
            r"^\s*(const float\*|const int\*|float\*|double|int)\s+"
            r"([\w, ]+);", body, re.M):
        fields += [(n.strip(), kind) for n in names.split(",")]
    kinds = {"const float*": ctypes.c_void_p, "const int*": ctypes.c_void_p,
             "float*": ctypes.c_void_p, "double": ctypes.c_double,
             "int": ctypes.c_int}
    assert [(n, kinds[k]) for n, k in fields] == list(
        tin_raster._TrParams._fields_)
    assert ctypes.sizeof(tin_raster._TrParams) == 4 * 8 + 6 * 8 + 9 * 4 + 4


def test_wrapper_refuses_what_the_kernel_does_not_take():
    verts, tris, grid, z_fine = tin_far_field_scene("irregular", 4)
    kw = dict(grid=grid, fine_shape=z_fine.shape, ratio_log2=4,
              dist_search=300.0)
    for dev in ("cpu", "meta"):
        z = torch.zeros(z_fine.shape, dtype=torch.float32, device=dev)
        with pytest.raises(ValueError, match="no TIN far field"):
            tin_raster.coarse_grid(verts, tris, z_fine=z, **kw)
    lat = tin_raster.lattice(grid, z_fine.shape, 4, 300.0)
    # the scene's unused vertex that is not finite is taken
    assert not np.isfinite(verts).all()
    v, t = tin_raster.host_inputs(verts, tris, lat, z_fine.shape)
    assert v.shape == (len(verts) // 3, 3) and t.dtype == np.int32
    bad_index = tris.copy()
    bad_index[4] = len(verts) // 3
    negative = tris.copy()
    negative[7] = -1
    not_finite = verts.copy().reshape(-1, 3)
    not_finite[tris[5], 2] = np.inf
    for args, what in [((verts, bad_index), "indices outside"),
                       ((verts, negative), "indices outside"),
                       ((not_finite, tris), "not finite"),
                       ((verts[:-1], tris), "whole triples"),
                       ((verts, tris[:-1]), "whole triples"),
                       ((verts, tris.astype(np.float32)), "integer")]:
        with pytest.raises(ValueError, match=what):
            tin_raster.host_inputs(*args, lat, z_fine.shape)
    huge = lat._replace(n_i=2 ** 30)
    with pytest.raises(ValueError, match="too large"):
        tin_raster.host_inputs(verts, tris, huge, z_fine.shape)
