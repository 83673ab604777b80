"""The port's `stitch` CLI against the JAX package's.

The parser: every action equals the JAX parser's in option strings, dest,
default and choices (`--verbose_dir`'s default is a timestamp and help
texts may differ). `--preview` writes the panorama of the run without it
and prints the JAX CLI's no-GUI notice on stderr. `main(device=
"cpu")` with `--affine --no-crop` on `affine_set(n=2)` writes a panorama
whose array equals `AffineStitcher(device="cpu", crop=False).stitch` on
the same files (with `-v`, its `stitch_verbose`, and the same artifacts);
`--output_params 1 90` writes the JPEG Pillow writes at quality 90, and an
unsupported flag raises.
"""

import io as _bytes_io
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch
from PIL import Image

from fixtures import affine_set
from stitching_tpu.cli import stitch as jax_cli
from stitching_tpu_torch import AffineStitcher, StitchingError, __version__
from stitching_tpu_torch import io as port_io
from stitching_tpu_torch.cli import stitch as cli

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)


def _actions(parser):
    return {a.dest: a for a in parser._actions}


def test_parser_actions_equal_jax():
    got, want = _actions(cli.create_parser()), _actions(
        jax_cli.create_parser())
    assert list(got) == list(want)
    for dest, a in want.items():
        b = got[dest]
        assert b.option_strings == a.option_strings, dest
        assert b.choices == a.choices, dest
        assert b.nargs == a.nargs and type(b) is type(a), dest
        if dest != "verbose_dir":
            assert b.default == a.default, dest


def test_parser_parses_like_jax():
    argv = ["a.png", "b.png", "--affine", "--no-crop", "--finder", "voronoi",
            "--nfeatures", "800", "--output_params", "1", "90", "-v"]
    got = vars(cli.create_parser().parse_args(argv))
    want = vars(jax_cli.create_parser().parse_args(argv))
    got.pop("verbose_dir"), want.pop("verbose_dir")
    assert got == want


def test_version():
    assert __version__ == "0.1.0"
    with mock.patch.object(sys, "argv", ["stitch", "--version"]), \
            pytest.raises(SystemExit) as exc:
        cli.main(device="cpu")
    assert exc.value.code == 0


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    imgs, _ = affine_set(n=2)
    paths = []
    for i, img in enumerate(imgs):
        p = str(d / f"in{i}.png")
        port_io.write_image(p, img)
        paths.append(p)
    want = AffineStitcher(device="cpu", crop=False).stitch(paths)
    return d, paths, want


def run_main(argv):
    with mock.patch.object(sys, "argv", ["stitch"] + argv):
        cli.main(device="cpu")


def test_preview_raises(files, capsys):
    """`--preview` raises nothing: as the JAX CLI does on a host without
    cv2 (the card host has none), it writes the panorama of the run
    without the flag, then prints the JAX CLI's notice on stderr."""
    d, paths, want = files
    argv = paths + ["--affine", "--no-crop", "--preview", "--output"]
    capsys.readouterr()
    run_main(argv + [str(d / "p.png")])
    got_err = capsys.readouterr().err
    got = port_io.read_image(str(d / "p.png"))
    assert got.shape == want.shape and np.array_equal(got, want)
    with mock.patch.dict(sys.modules, {"cv2": None}), \
            mock.patch.object(sys, "argv",
                              ["stitch"] + argv + [str(d / "p_jax.png")]):
        jax_cli.main()
    want_err = capsys.readouterr().err
    assert os.path.exists(d / "p_jax.png")
    assert "preview unavailable (no GUI backend)" in want_err
    assert got_err == want_err


@pytest.mark.parametrize("verbose", [False, True])
def test_main_affine_equals_stitcher(files, verbose):
    d, paths, want = files
    out = str(d / f"pano_{verbose}.png")
    extra = ["-v", "--verbose_dir", str(d / "verbose")] if verbose else []
    run_main(paths + ["--affine", "--no-crop", "--output", out] + extra)
    got = port_io.read_image(out)
    if verbose:
        # verbose mode is its own path (seams resized against the FINAL
        # warp masks): the same call from Python
        (d / "verbose_py").mkdir(exist_ok=True)
        want = AffineStitcher(device="cpu", crop=False).stitch_verbose(
            paths, verbose_dir=str(d / "verbose_py"))
        assert sorted(os.listdir(d / "verbose")) == sorted(
            os.listdir(d / "verbose_py"))
    assert got.shape == want.shape and np.array_equal(got, want)


def test_output_params_honoured(files):
    d, paths, want = files
    out = str(d / "q90.jpg")
    run_main(paths + ["--affine", "--no-crop", "--output", out,
                      "--output_params", "1", "90"])
    buf = _bytes_io.BytesIO()
    Image.fromarray(np.ascontiguousarray(want[:, :, ::-1])).save(
        buf, format="JPEG", quality=90)
    assert open(out, "rb").read() == buf.getvalue()
    with pytest.raises(StitchingError, match="99"):
        run_main(paths + ["--affine", "--no-crop", "--output",
                          str(d / "bad.jpg"), "--output_params", "99", "1"])


def test_write_image_params(tmp_path):
    img = np.broadcast_to(np.arange(60, dtype=np.uint8)[None, :, None] * 4,
                          (40, 60, 3)).copy()
    sizes = {}
    for level in (0, 9):
        p = str(tmp_path / f"c{level}.png")
        port_io.write_image(p, img, [16, level])
        assert np.array_equal(port_io.read_image(p), img)
        sizes[level] = os.path.getsize(p)
    assert sizes[9] < sizes[0]
    with pytest.raises(StitchingError):
        port_io.write_image(str(tmp_path / "x.png"), img, [16])
