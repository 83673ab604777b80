"""Error / warning taxonomy.

Parity: reference `stitching/stitching_error.py:1-6` — the reference's
entire error surface is one exception plus one warning class; every failure
mode in the pipeline raises `StitchingError` and recoverable anomalies emit
`StitchingWarning`.
"""


class StitchingError(Exception):
    """Raised on any unrecoverable pipeline failure (bad input, no confident
    matches, estimation failure, invalid crop, ...)."""


class StitchingWarning(UserWarning):
    """Emitted for recoverable anomalies (dropped images, overridden affine
    defaults, ...)."""
