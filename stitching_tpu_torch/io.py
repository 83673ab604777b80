"""Host-side image file I/O.

The compute pipeline is PyTorch on the card; file decode/encode stays on the
host. Images are numpy uint8 arrays in **BGR** channel order (matching the
reference's cv.imread convention, `stitching/images.py:113-116`), so user
code written against the reference keeps working unmodified.

Pillow decodes and encodes, on every host, so a file gives the same array
wherever the port runs. It is imported on first use: the stitcher runs
without it as long as it is handed arrays.
"""

import numpy as np

from .errors import StitchingError


def _pil():
    try:
        from PIL import Image
    except ImportError as exc:
        raise StitchingError(
            "reading and writing image files needs Pillow") from exc
    return Image


def read_image(path: str) -> np.ndarray:
    """Read an image file into a BGR uint8 array (HxWx3), as cv.imread
    does by default."""
    pil_image = _pil()
    try:
        with pil_image.open(path) as pil:
            rgb = np.asarray(pil.convert("RGB"))
    except OSError as exc:
        raise StitchingError("Cannot read image " + path) from exc
    return rgb[:, :, ::-1].copy()


# cv.imwrite's flag codes that the CLI's --output_params documents, and the
# Pillow save option each one sets
_WRITE_FLAGS = {
    1: "quality",           # IMWRITE_JPEG_QUALITY
    16: "compress_level",   # IMWRITE_PNG_COMPRESSION
    64: "quality",          # IMWRITE_WEBP_QUALITY
}


def _save_options(params):
    """Pillow save options from cv.imwrite's flat [flag, value, ...]."""
    params = list(params or [])
    if len(params) % 2:
        raise StitchingError(
            f"image write parameters come in flag/value pairs: {params}")
    options = {}
    for flag, value in zip(params[::2], params[1::2]):
        if int(flag) not in _WRITE_FLAGS:
            raise StitchingError(
                f"unsupported image write parameter {flag} (supported: "
                "1 JPEG quality, 16 PNG compression, 64 WEBP quality)")
        options[_WRITE_FLAGS[int(flag)]] = int(value)
    return options


def write_image(path: str, img: np.ndarray, params=None) -> bool:
    """Write a BGR (HxWx3) or gray (HxW) uint8 array to an image file, its
    format from the file's extension. `params` are cv.imwrite's flag/value
    pairs: JPEG quality (1), PNG compression (16) and WEBP quality (64)."""
    options = _save_options(params)
    img = np.ascontiguousarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    arr = img[:, :, ::-1] if img.ndim == 3 else img
    _pil().fromarray(np.ascontiguousarray(arr)).save(path, **options)
    return True
