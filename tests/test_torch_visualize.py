"""The port's visualisation helpers (picad_tpu_torch/utils/visualize.py)
against the JAX package's copy, and the port's GIF smoke
(picad_tpu_torch/tools/smoke_gif.py); the case of tests/test_tools_smoke.py.

The modules are imported whole: each defines a function named
`test_iou_cases`, which pytest would collect if it were imported by name.
"""

import subprocess
import sys

import numpy as np
import pytest

import picad_tpu.utils.visualize as jvis
import picad_tpu_torch.utils.visualize as tvis

REPO = __file__.rsplit("/tests/", 1)[0]


def test_gif_smoke_writes_artifacts(tmp_path):
    """The smoke on the port's synthetic eval source writes the orig and
    flip GIFs and the overlay PNG."""
    from picad_tpu_torch.tools import smoke_gif

    assert smoke_gif.main([str(tmp_path), "1"]) == str(tmp_path)
    for name in ("orig_01_gt.gif", "flip_01_gt.gif", "overlay_01.png"):
        p = tmp_path / name
        assert p.exists() and p.stat().st_size > 0, name


def test_gif_smoke_runs_as_a_module(tmp_path):
    r = subprocess.run([sys.executable, "-m", "picad_tpu_torch.tools.smoke_gif",
                        str(tmp_path), "0"], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "orig_00_gt.gif").stat().st_size > 0


@pytest.mark.parametrize("kind", ["random", "zeros", "shifted"])
def test_normalize_image_matches_jax_module(kind):
    rng = np.random.default_rng(1)
    pic = {"random": rng.standard_normal((16, 12, 3)),
           "zeros": np.zeros((4, 4)),
           "shifted": 5.0 + rng.random((8, 8))}[kind].astype(np.float32)
    got, want = tvis.normalize_image(pic), jvis.normalize_image(pic)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_iou_debug_and_the_reference_cases_match_jax_module(tmp_path):
    rng = np.random.default_rng(2)
    for _ in range(5):
        a, b = rng.random((10, 10)) > 0.5, rng.random((10, 10)) > 0.6
        assert tvis.iou_debug(a, b) == jvis.iou_debug(a, b)
    assert tvis.iou_debug(np.zeros((3, 3)), np.zeros((3, 3))) == 0.0
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    ious = tvis.test_iou_cases(str(tmp_path / "port"))
    assert ious == jvis.test_iou_cases(str(tmp_path / "jax"))
    assert ious == pytest.approx([1.0, 0.0, 3 / 15, 4 / 16])
    for i in range(4):
        name = f"iou_case_{i}.png"
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_histogram_draws_the_jax_modules_figure(tmp_path):
    arr = np.random.default_rng(3).standard_normal(1000)
    tvis.histogram(arr, 50, save=str(tmp_path / "port.png"))
    jvis.histogram(arr, 50, save=str(tmp_path / "jax.png"))
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()


def test_import_needs_no_plotting_stack():
    """The card's machine has no matplotlib or imageio: importing the
    port's module must not need them."""
    code = ("import sys; sys.modules['matplotlib'] = None; sys.modules['imageio'] = None\n"
            "import picad_tpu_torch.utils.visualize as v, picad_tpu_torch.tools.smoke_gif\n"
            "import numpy as np\n"
            "print(v.iou_debug(v.normalize_image(np.array([[0.0, 2.0]])), np.array([[0, 1]])))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "1.0"
