"""The read floor's plain torch versions (``ops/read_floor.py``, kernel K5's
references) on the CPU.

K5's TPU counterpart, the body ``kernel`` of ``tools/read_floor.py:53-122``,
sits inside that tool's ``main`` and its ``pallas_call`` has no interpret
switch, so nothing of it can be imported or run here; the reference is a
NumPy transcription of that body written below (:func:`tpu_body`), one
(t0, t1) tile whose window read starts at the tool's margins (8, 128).
``bilinear``, ``nearest`` and ``alu`` (the tool's ``vpu``) must be
bit-equal to it.  ``aligned``, ``stream`` and ``stage`` are the port's own
definitions and are held against NumPy statements of them, bit-equal too
(maxima and float32 products in one order).
"""

import numpy as np
import pytest
import torch

from horayzon_tpu_torch.ops import read_floor

T0, T1, STEPS, AZIM = 16, 64, 41, 6


def tpu_body(win, sh_i, sh_j, mode, t0, t1, n_steps):
    """``tools/read_floor.py:53-122`` for one grid step, float32 NumPy:
    ``_shifted_window(win_ref, di + 8, dj + 128, rows, cols)`` is the slice
    of the window at that start."""
    f32 = np.float32
    acc = np.full((t0, t1), -1e30, dtype=f32)
    for m in range(n_steps):
        s = f32(m + 1)
        if mode == "vpu":
            x = acc
            y = acc + s
            for _ in range(8):
                x = x * sh_i + sh_j
                y = y * sh_j + sh_i
                x = np.maximum(x, y)
            acc = x
            continue
        dif = s * sh_i
        djf = s * sh_j
        di = np.floor(dif)
        dj = np.floor(djf)
        rows = t0 + (1 if mode == "bilinear" else 0)
        cols = t1 + (1 if mode == "bilinear" else 0)
        w = win[int(di) + 8:int(di) + 8 + rows,
                int(dj) + 128:int(dj) + 128 + cols]
        if mode == "bilinear":
            fi = dif - di
            fj = djf - dj
            top = (f32(1.0) - fj) * w[:-1, :-1] + fj * w[:-1, 1:]
            bot = (f32(1.0) - fj) * w[1:, :-1] + fj * w[1:, 1:]
            he = (f32(1.0) - fi) * top + fi * bot
        else:
            he = w[:t0, :t1]
        acc = np.maximum(acc, he * (f32(1.0) / s))
    return acc


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    # the tool's window: the tile, its margins and the steps, rounded
    w0 = -(-(T0 + 1 + 16 + STEPS) // 8) * 8
    w1 = -(-(T1 + 1 + 256 + STEPS) // 128) * 128
    win = rng.normal(size=(w0, w1)).astype(np.float32)
    return win, read_floor.first_quadrant_trig(AZIM)


def _port(win, trig, mode, **kw):
    kw = dict(dict(cells=(T0, T1), n_steps=STEPS, offset=(8, 128)), **kw)
    return read_floor.read_floor(torch.from_numpy(win), trig, mode, **kw)


@pytest.mark.parametrize("mode,tpu_mode", [("bilinear", "bilinear"),
                                           ("nearest", "nearest"),
                                           ("alu", "vpu")])
def test_mode_bit_equal_to_tpu_body(scene, mode, tpu_mode):
    win, trig = scene
    got = _port(win, trig, mode)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (AZIM, T0, T1)
    for k in range(AZIM):
        want = tpu_body(win, trig[k, 0], trig[k, 1], tpu_mode, T0, T1, STEPS)
        np.testing.assert_array_equal(got[k].numpy(), want)
    assert np.isfinite(got.numpy()).all()


def test_first_quadrant_trig_is_the_tools_table():
    a = 32
    az = 0.5 * np.pi * (np.arange(a) + 0.5) / a
    want = np.stack([np.sin(az), np.cos(az)], -1).astype(np.float32)
    got = read_floor.first_quadrant_trig(a)
    np.testing.assert_array_equal(got, want)
    assert got.min() > 0.0 and got.max() < 1.0


def test_aligned_rounds_the_column_shift_up_to_a_warp(scene):
    win, trig = scene
    big = np.random.default_rng(1).normal(size=(96, 256)).astype(np.float32)
    got = _port(big, trig, "aligned", offset=(8, 64))
    f32 = np.float32
    for k in range(AZIM):
        acc = np.full((T0, T1), -1e30, dtype=f32)
        for m in range(STEPS):
            s = f32(m + 1)
            di = int(np.floor(s * trig[k, 0]))
            dj = (int(np.floor(s * trig[k, 1])) + 32) // 32 * 32
            assert dj % 32 == 0 and dj > s * trig[k, 1] - 1
            he = big[8 + di:8 + di + T0, 64 + dj:64 + dj + T1]
            acc = np.maximum(acc, he * (f32(1.0) / s))
        np.testing.assert_array_equal(got[k].numpy(), acc)
    # a column offset or a row stride off the 32-cell grid is refused
    with pytest.raises(ValueError, match="multiples of 32"):
        _port(big, trig, "aligned", offset=(8, 65))
    with pytest.raises(ValueError, match="multiples of 32"):
        _port(big[:, :250].copy(), trig, "aligned", offset=(8, 64))


def test_stream_folds_rotating_quads():
    rng = np.random.default_rng(2)
    win = rng.normal(size=(24, 36)).astype(np.float32)
    trig = read_floor.first_quadrant_trig(3)
    cells, steps = (10, 40), 9          # ragged: blocks pad to (16, 64)
    got = read_floor.read_floor(torch.from_numpy(win), trig, "stream",
                                cells=cells, n_steps=steps)
    quads = win.reshape(-1, 4).max(axis=1)
    nq = quads.size
    rot = read_floor.stream_rotation(nq)
    assert rot % 2 == 1 and 0 < rot < nq
    for k in range(3):
        for i in range(cells[0]):
            for j in range(cells[1]):
                t = (k * 16 + i) * 64 + j
                want = max(quads[(t + m * rot) % nq] for m in range(steps))
                assert got[k, i, j].item() == want
    with pytest.raises(ValueError, match="multiple of 4"):
        read_floor.read_floor(torch.from_numpy(win[:1, :35].copy()), trig,
                              "stream", cells=cells, n_steps=steps)


def test_sources_agree_and_stage_folds_the_strips(scene):
    win, trig = scene
    kw = dict(chunk=7)
    for mode in ("bilinear", "nearest"):
        assert torch.equal(_port(win, trig, mode, source="smem", **kw),
                           _port(win, trig, mode))
    got = _port(win, trig, "stage", source="smem", **kw)
    f32 = np.float32
    for k in (0, AZIM - 1):
        acc = np.full((T0, T1), -1e30, dtype=f32)
        for m0 in range(0, STEPS, 7):
            m1 = min(m0 + 7, STEPS)
            lo = [int(np.floor(f32(m0 + 1) * trig[k, a])) for a in (0, 1)]
            hi = [int(np.floor(f32(m1) * trig[k, a])) for a in (0, 1)]
            for i in range(T0):
                for j in range(T1):
                    b0, b1 = 8 + i - i % 8 + lo[0], 128 + j - j % 32 + lo[1]
                    box = win[b0:b0 + 9 + hi[0] - lo[0],
                              b1:b1 + 33 + hi[1] - lo[1]]
                    acc[i, j] = max(acc[i, j],
                                    box[i % 8::8, j % 32::32].max())
        np.testing.assert_array_equal(got[k].numpy(), acc)
    rows, ld = read_floor.strip_layout("bilinear", trig, STEPS, 7)
    assert rows <= 8 + 1 + 7 and ld <= 32 + 1 + 7
    # all 246 steps of K1's bench cell in one strip do not fit a block
    t32 = read_floor.first_quadrant_trig(32)
    rows, ld = read_floor.strip_layout("bilinear", t32, 246, 246)
    assert rows * ld * 4 > read_floor.MAX_SMEM_BYTES
    rows, ld = read_floor.strip_layout("bilinear", t32, 246, 32)
    assert rows * ld * 4 < 48 * 1024


def test_window_too_small_and_bad_arguments_raise(scene):
    win, trig = scene
    # the rows the steps need are 8 + 16 + 40 + 1; one fewer is refused (the
    # out-of-bounds read the TPU tool once had, tools/read_floor.py:69-72)
    _port(win[:T0 + 8 + STEPS], trig, "bilinear")
    with pytest.raises(ValueError, match="too small"):
        _port(win[:T0 + 8 + STEPS - 1], trig, "bilinear")
    with pytest.raises(ValueError, match="too small"):
        _port(win, trig, "nearest", n_steps=400)
    with pytest.raises(ValueError, match="mode must be"):
        _port(win, trig, "vpu")
    with pytest.raises(ValueError, match="no shared-memory source"):
        _port(win, trig, "alu", source="smem")
    with pytest.raises(ValueError, match="staging"):
        _port(win, trig, "stage")
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        _port(win, -trig, "nearest")
    with pytest.raises(ValueError, match="float32"):
        read_floor.read_floor(torch.from_numpy(win).double(), trig,
                              "nearest", cells=(T0, T1), n_steps=STEPS)
    with pytest.raises(ValueError, match="CUDA window"):
        read_floor.time_modes(torch.from_numpy(win))


def test_work_counts_and_default_offset():
    w = read_floor.work("bilinear", (1024, 1024), 32, 246)
    assert w["samples"] == 1024 * 1024 * 32 * 246
    assert w["reads"] == (1024 // 8) * (1024 // 32) * 32 * 246
    assert w["loads"] == 4 * w["samples"] and w["ops"] == 20 * w["samples"]
    assert read_floor.work("alu", (8, 32), 1, 1)["ops"] == 41 * 256
    # K1's geometry: the block centred, on the 32-column grid, and both
    # bench windows hold the 246 steps
    assert read_floor.centre_offset((2048, 2048), (1024, 1024)) == (512, 512)
    assert read_floor.centre_offset((5120, 5120), (1024, 1024)) == (2048,
                                                                    2048)
    assert read_floor.centre_offset((100, 100), (20, 30)) == (40, 32)
    trig = read_floor.first_quadrant_trig(32)
    for n in (2048, 5120):
        for mode in ("bilinear", "aligned"):
            read_floor._check(torch.empty((n, n)), trig, mode, (1024, 1024),
                              246, None, "l2", 32)
