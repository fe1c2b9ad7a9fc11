"""Native frame-IO (native/frame_io.cpp) vs the pure-Python writers.

Pins the exact-match contract: the C++ rasterizer reproduces
utils/render.rasterize pixel for pixel (same f32 pixel arithmetic, same
offset-major overwrite order), the PNG decodes back to the same image,
and the binary VTK round-trips through utils/io_vtk.read_vtk_points.
Also covers the driver's async-writer path end to end."""

import numpy as np
import pytest

from mpm_flip98a_tpu.utils import io_vtk, native_io, render

pytestmark = pytest.mark.skipif(
    not native_io.available(), reason="native frame-io library unavailable"
)


def _particles(n=5000, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 0.4375, size=(n, 2)).astype(np.float32)
    # A few points parked exactly on the domain edges hit the clip paths.
    x[:8] = [[0, 0], [0.4375, 0.4375], [0, 0.4375], [0.4375, 0],
             [0.2, 0], [0, 0.2], [0.4375, 0.2], [0.2, 0.4375]]
    colors = rng.integers(0, 256, size=(n, 3), dtype=np.uint8)
    return x, colors


def test_png_pixel_equality(tmp_path):
    from PIL import Image

    x, colors = _particles()
    ref = render.rasterize(x, res=256, extent=0.4375, colors=colors)
    path = str(tmp_path / "frame.png")
    assert native_io.frame_png(path, x, colors, 256, 0.4375)
    got = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(got, ref)


def test_vtk_binary_roundtrip(tmp_path):
    x, _ = _particles(n=333)
    path = str(tmp_path / "p.vtk")
    assert native_io.vtk_particles(path, x)
    back = io_vtk.read_vtk_points(path)
    assert back.shape == (333, 3)
    np.testing.assert_allclose(back[:, :2], x.astype(np.float64), atol=0)
    assert not back[:, 2].any()
    # 3D positions round-trip too.
    x3 = np.concatenate([x, x[:, :1] * 0.5], axis=1)
    assert native_io.vtk_particles(path, x3)
    np.testing.assert_allclose(
        io_vtk.read_vtk_points(path), x3.astype(np.float64), atol=0
    )


def test_driver_async_io(tmp_path, monkeypatch):
    """CLI production mode (no GIF => async native writers): artifacts
    exist and the VTK positions match the final state."""
    import os

    from mpm_flip98a_tpu import driver

    # Keep the test session off the process-wide persistent compile cache
    # that main() turns on (tests/test_utils_and_driver.py covers it).
    monkeypatch.setattr(driver.compile_cache, "enable", lambda: None)
    driver.main(
        ["--scenario", "dam2d_flip98", "--frames", "2", "--substeps", "3",
         "--out", str(tmp_path)]
    )
    movs = [d for d in os.listdir(tmp_path) if d.startswith("mov_")]
    vtks = [d for d in os.listdir(tmp_path) if d.startswith("vtk_")]
    assert len(movs) == 1 and len(vtks) == 1
    frames = sorted(os.listdir(tmp_path / movs[0]))
    assert frames == ["00001.png", "00002.png"], frames
    pts = io_vtk.read_vtk_points(str(tmp_path / vtks[0] / "00002.vtk"))
    assert np.isfinite(pts).all() and len(pts) > 0
