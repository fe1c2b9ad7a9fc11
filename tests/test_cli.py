"""Driver CLI smoke: the `python -m mpm_flip98a_tpu` argument surface."""

import os

import pytest

from mpm_flip98a_tpu import driver
from mpm_flip98a_tpu.driver import main


@pytest.fixture(autouse=True)
def _no_persistent_cache(monkeypatch):
    # main() turns on the process-wide persistent compilation cache; keep
    # the test session off it (tests/test_utils_and_driver.py covers it).
    monkeypatch.setattr(driver.compile_cache, "enable", lambda: None)


def test_cli_end_to_end(tmp_path, capsys):
    main(
        [
            "--scenario", "dam2d_flip98",
            "--frames", "1",
            "--substeps", "5",
            "--out", str(tmp_path),
            "--checkpoint", str(tmp_path / "end.npz"),
        ]
    )
    out = capsys.readouterr().out
    assert "Run Time:" in out  # exec.py:31 parity
    assert os.path.exists(tmp_path / "end.npz")
    # Frame + VTK artifacts written by post_process.
    dirs = os.listdir(tmp_path)
    assert any(d.startswith("mov_") for d in dirs)
    assert any(d.startswith("vtk_") for d in dirs)


def test_cli_resume(tmp_path, capsys):
    ck = str(tmp_path / "ck.npz")
    main(
        ["--scenario", "dam2d_flip98", "--frames", "1", "--substeps", "5",
         "--out", str(tmp_path), "--checkpoint", ck]
    )
    main(
        ["--scenario", "dam2d_flip98", "--frames", "1", "--substeps", "5",
         "--out", str(tmp_path / "resumed"), "--resume", ck]
    )
    assert "Run Time:" in capsys.readouterr().out
    # The restored frame counter must CONTINUE the numbering: the first
    # run wrote 00001.png, so the resumed run's single frame is 00002.png
    # (a --checkpoint-every / frame_count arithmetic regression would
    # restart at 00001 and still pass a smoke check).
    resumed_movs = [
        d for d in os.listdir(tmp_path / "resumed") if d.startswith("mov_")
    ]
    assert len(resumed_movs) == 1
    frames = sorted(os.listdir(tmp_path / "resumed" / resumed_movs[0]))
    assert frames == ["00002.png"], frames


def test_cli_multidevice_fast(tmp_path, capsys):
    # VERDICT r2 item 4: the flagship slab-sharded fast path must be
    # reachable from the user entry point, incl. checkpoint + resume of
    # the sharded bucket state (here on the virtual 8-device CPU mesh).
    ck = str(tmp_path / "ck.npz")
    main(
        ["--scenario", "dam2d_flip98", "--path", "fast", "--devices", "4",
         "--frames", "2", "--substeps", "3", "--out", str(tmp_path),
         "--checkpoint-every", "1", "--checkpoint", ck]
    )
    out = capsys.readouterr().out
    assert "Run Time:" in out
    import os
    assert os.path.exists(ck)
    dirs = os.listdir(tmp_path)
    assert any(d.startswith("mov_") for d in dirs)
    main(
        ["--scenario", "dam2d_flip98", "--path", "fast", "--devices", "4",
         "--frames", "1", "--substeps", "3",
         "--out", str(tmp_path / "resumed"), "--resume", ck]
    )
    assert "Run Time:" in capsys.readouterr().out


def test_cli_incompressible_fast_sharded(tmp_path, capsys):
    # VERDICT r3 item 4 "done" criterion: dam2d_incompressible runs with
    # --path fast and --devices (sharded PCG: psum dots + halo refresh).
    main(
        ["--scenario", "dam2d_incompressible", "--path", "fast",
         "--devices", "4", "--frames", "1", "--substeps", "5",
         "--out", str(tmp_path)]
    )
    out = capsys.readouterr().out
    assert "Run Time:" in out
    dirs = os.listdir(tmp_path)
    assert any(d.startswith("mov_") for d in dirs)


def test_cli_incompressible_fast_single(tmp_path, capsys):
    main(
        ["--scenario", "dam2d_incompressible", "--path", "fast",
         "--frames", "1", "--substeps", "5", "--out", str(tmp_path)]
    )
    assert "Run Time:" in capsys.readouterr().out


def test_cli_two_axis_mesh_3d(tmp_path, capsys):
    # Two-axis (slabs x pencil columns) 3D decomposition from the CLI,
    # incl. checkpoint + resume of the shard-major bucket state on the
    # virtual 8-device CPU mesh.
    ck = str(tmp_path / "ck.npz")
    main(
        ["--scenario", "dam3d", "--path", "fast", "--devices", "2x4",
         "--frames", "1", "--substeps", "3", "--out", str(tmp_path),
         "--checkpoint", ck]
    )
    assert "Run Time:" in capsys.readouterr().out
    assert os.path.exists(ck)
    main(
        ["--scenario", "dam3d", "--path", "fast", "--devices", "2x4",
         "--frames", "1", "--substeps", "3",
         "--out", str(tmp_path / "resumed"), "--resume", ck]
    )
    assert "Run Time:" in capsys.readouterr().out


def test_cli_orbax_sharded_checkpoint(tmp_path, capsys):
    # Pod-scale checkpoint path: non-.npz checkpoint => per-shard Orbax
    # directory (no host gather), restored straight onto the mesh.
    ck = str(tmp_path / "ck_orbax")
    main(
        ["--scenario", "dam2d_flip98", "--path", "fast", "--devices", "4",
         "--frames", "1", "--substeps", "3", "--out", str(tmp_path),
         "--checkpoint", ck]
    )
    assert "Run Time:" in capsys.readouterr().out
    assert os.path.isdir(ck) and os.path.exists(ck + ".meta.json")
    main(
        ["--scenario", "dam2d_flip98", "--path", "fast", "--devices", "4",
         "--frames", "1", "--substeps", "3",
         "--out", str(tmp_path / "resumed"), "--resume", ck]
    )
    assert "Run Time:" in capsys.readouterr().out
    # Frame numbering continues across the Orbax resume.
    movs = [d for d in os.listdir(tmp_path / "resumed") if d.startswith("mov_")]
    frames = sorted(os.listdir(tmp_path / "resumed" / movs[0]))
    assert frames == ["00002.png"], frames
