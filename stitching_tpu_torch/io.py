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


def write_image(path: str, img: np.ndarray) -> bool:
    """Write a BGR (HxWx3) or gray (HxW) uint8 array to an image file, its
    format from the file's extension."""
    img = np.ascontiguousarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    arr = img[:, :, ::-1] if img.ndim == 3 else img
    _pil().fromarray(np.ascontiguousarray(arr)).save(path)
    return True
