"""Input image sets and the three-resolution scheme.

Behavioral parity with the reference's `stitching/images.py` (pinned by
tests/test_images.py): `Images.of` factory dispatch (ndarray list vs
filename list), MEDIUM 0.6 / LOW 0.1 / FINAL -1 megapixel targets, scales
derived from the FIRST image's size, lazy per-iteration file reading with
sizes recorded as a side effect, wildcard resolution, and the >=2-image /
megapix-ordering validations with the same error messages.

Structure is engine-oriented rather than generator-oriented: resolution
bookkeeping lives in one `_ResolutionPlan` value object that the batched
engine queries for target sizes and ratios (`engine.py` resizes whole
stacks on device in one kernel); the per-image `resize` generator remains
for component-level use (verbose mode, tutorials).
"""

import os
from enum import Enum
from glob import glob

import numpy as np

from . import io as _io
from .errors import StitchingError
from .megapix_scaler import MegapixDownscaler
from .ops.resize import resize as _resize


class _ResolutionPlan:
    """Megapixel targets -> per-resolution scale factors and target sizes.

    Scales lock in once, from the first image's size (reference
    images.py:85-89: all images in a set share the first image's scale).
    """

    def __init__(self, medium_megapix, low_megapix, final_megapix):
        if medium_megapix < low_megapix:
            raise StitchingError(
                "Medium resolution megapix need to be "
                "greater or equal than low resolution "
                "megapix"
            )
        self._scalers = {
            "MEDIUM": MegapixDownscaler(medium_megapix),
            "LOW": MegapixDownscaler(low_megapix),
            "FINAL": MegapixDownscaler(final_megapix),
        }
        self.locked = False

    def lock(self, first_size):
        if not self.locked:
            for scaler in self._scalers.values():
                scaler.set_scale_by_img_size(first_size)
            self.locked = True

    def scaler(self, resolution):
        Images.check_resolution(resolution)
        return self._scalers[resolution.name]

    def scale(self, resolution):
        assert self.locked
        return self.scaler(resolution).scale

    def ratio(self, from_resolution, to_resolution):
        return self.scale(to_resolution) / self.scale(from_resolution)

    def target_size(self, resolution, size):
        return self.scaler(resolution).get_scaled_img_size(size)


class Images:
    class Resolution(Enum):
        MEDIUM = 0.6
        LOW = 0.1
        FINAL = -1

    @staticmethod
    def of(
        images,
        medium_megapix=Resolution.MEDIUM.value,
        low_megapix=Resolution.LOW.value,
        final_megapix=Resolution.FINAL.value,
    ):
        if not isinstance(images, list):
            raise StitchingError(
                "images must be a list of images or filenames")
        if len(images) == 0:
            raise StitchingError("images must not be an empty list")
        mp = (medium_megapix, low_megapix, final_megapix)
        if all(isinstance(i, np.ndarray) for i in images):
            return _NumpyImages(images, *mp)
        if all(isinstance(i, str) for i in images):
            return _FilenameImages(images, *mp)
        raise StitchingError(
            """invalid images list:
                    must be numpy arrays (loaded images) or filename strings"""
        )

    def __init__(self, names, medium_megapix, low_megapix, final_megapix):
        self._plan = _ResolutionPlan(
            medium_megapix, low_megapix, final_megapix)
        self._names = names
        self._size_table = [None] * len(names)

    # -- iteration: subclasses yield raw images through `_record` ----------

    def __iter__(self):
        for idx in range(len(self._names)):
            yield self._record(idx, self._load(idx))

    def _load(self, idx):
        raise NotImplementedError

    def _record(self, idx, img):
        """Register size/scale bookkeeping for a just-produced image."""
        if self._size_table[idx] is None:
            self._size_table[idx] = Images.get_image_size(img)
        first = self._size_table[0]
        if first is not None:
            self._plan.lock(first)
        return img

    # -- metadata -----------------------------------------------------------

    @property
    def names(self):
        return self._names

    @property
    def sizes(self):
        assert all(s is not None for s in self._size_table)
        return self._size_table

    def subset(self, indices):
        self._names = [self._names[i] for i in indices]
        self._size_table = [self._size_table[i] for i in indices]

    # -- resolution queries (the batched engine's interface) ----------------

    def get_ratio(self, from_resolution, to_resolution):
        return self._plan.ratio(from_resolution, to_resolution)

    def get_scaled_img_sizes(self, resolution):
        return [self._plan.target_size(resolution, s) for s in self.sizes]

    # -- per-image resize generator (component-level / verbose use) ---------

    def resize(self, resolution, imgs=None):
        for idx, img in enumerate(imgs if imgs is not None else self):
            yield Images.resize_img_by_scaler(
                self._plan.scaler(resolution), self._size_table[idx], img)

    # -- static helpers ------------------------------------------------------

    @staticmethod
    def read_image(img_name):
        return _io.read_image(img_name)

    @staticmethod
    def get_image_size(img):
        """(width, height)"""
        return (img.shape[1], img.shape[0])

    @staticmethod
    def resize_img_by_scaler(scaler, size, img):
        return _resize(img, scaler.get_scaled_img_size(size))

    @staticmethod
    def check_resolution(resolution):
        assert (isinstance(resolution, Enum)
                and resolution in Images.Resolution)

    @staticmethod
    def resolve_wildcards(img_names):
        if len(img_names) == 1:
            img_names = [f for f in glob(img_names[0])
                         if not os.path.isdir(f)]
        return img_names

    @staticmethod
    def check_list_element_types(list_, type_):
        return all(isinstance(element, type_) for element in list_)

    @staticmethod
    def to_binary(img):
        """Binarize a (possibly color) mask image to {0, 255} uint8."""
        img = np.asarray(img)
        if img.ndim == 3:
            # BT.601 luma, same weights cv.cvtColor BGR2GRAY uses.
            img = (0.114 * img[:, :, 0] + 0.587 * img[:, :, 1]
                   + 0.299 * img[:, :, 2])
        return ((img > 0.5) * 255).astype(np.uint8)


class _NumpyImages(Images):
    """In-memory image list; sizes and scales known up front."""

    def __init__(self, images, medium_megapix, low_megapix, final_megapix):
        if len(images) < 2:
            raise StitchingError("2 or more Images needed")
        names = [str(i + 1) for i in range(len(images))]
        super().__init__(names, medium_megapix, low_megapix, final_megapix)
        self._images = list(images)
        for idx, img in enumerate(self._images):
            self._size_table[idx] = Images.get_image_size(img)
        self._plan.lock(self._size_table[0])

    def subset(self, indices):
        super().subset(indices)
        self._images = [self._images[i] for i in indices]

    def _load(self, idx):
        return self._images[idx]


class _FilenameImages(Images):
    """Disk-backed set: images read lazily per iteration pass; sizes and
    scales are recorded as first-pass side effects (reference
    images.py:183-200 semantics)."""

    def __init__(self, images, medium_megapix, low_megapix, final_megapix):
        names = Images.resolve_wildcards(images)
        if len(names) < 2:
            raise StitchingError("2 or more Images needed")
        super().__init__(names, medium_megapix, low_megapix, final_megapix)

    def _load(self, idx):
        return Images.read_image(self._names[idx])
