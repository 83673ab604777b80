"""Host-side image file I/O.

The compute pipeline is PyTorch on the card; file decode/encode stays on the
host. Images are numpy uint8 arrays in **BGR** channel order (matching the
reference's cv.imread convention, `stitching/images.py:113-116`), so user
code written against the reference keeps working unmodified.

OpenCV decodes when it is installed (byte-level parity with the reference),
otherwise Pillow. The codec is imported on first use, so the stitcher runs
where neither is installed as long as it is handed arrays.
"""

import numpy as np

from .errors import StitchingError


def _codecs():
    """(cv2 or None, PIL.Image or None)."""
    try:
        import cv2
        return cv2, None
    except ImportError:
        pass
    try:
        from PIL import Image
        return None, Image
    except ImportError:
        return None, None


def read_image(path: str) -> np.ndarray:
    """Read an image file into a BGR uint8 array (HxWx3) or grayscale (HxW)."""
    cv2, pil_image = _codecs()
    if cv2 is not None:
        img = cv2.imread(path)
        if img is None:
            raise StitchingError("Cannot read image " + path)
        return img
    if pil_image is not None:
        try:
            pil = pil_image.open(path).convert("RGB")
        except OSError as exc:
            raise StitchingError("Cannot read image " + path) from exc
        return np.asarray(pil)[:, :, ::-1].copy()
    raise StitchingError(
        "No image codec available (need cv2 or PIL) to read " + path
    )


def write_image(path: str, img: np.ndarray, params=None) -> bool:
    """Write a BGR uint8 array to an image file."""
    img = np.ascontiguousarray(img)
    cv2, pil_image = _codecs()
    if cv2 is not None:
        if params:
            return bool(cv2.imwrite(path, img, params))
        return bool(cv2.imwrite(path, img))
    if pil_image is not None:
        arr = img[:, :, ::-1] if img.ndim == 3 else img
        pil_image.fromarray(arr).save(path)
        return True
    raise StitchingError("No image codec available (need cv2 or PIL)")
