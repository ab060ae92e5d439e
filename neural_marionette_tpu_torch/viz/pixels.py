"""What the port's image readers share below each of them: Pillow's
decompression-bomb limit and the eight orientations of an EXIF or TIFF
Orientation tag."""
from __future__ import annotations

import numpy as np

# Pillow refuses an image of more pixels (twice its MAX_IMAGE_PIXELS)
MAX_PIXELS = 178956970


def check_pixels(width: int, height: int, path: str, fmt: str) -> None:
    """Raise ``ValueError`` for an image past Pillow's decompression-bomb
    limit, which the port holds every format that imageio reads through
    Pillow to (a TIFF under Pillow's names: ``viz/tiff_pillow.py``). A
    TIFF under tifffile's names has no cap (tifffile has none;
    ``viz/tiff.py`` bounds each strip by the data the file holds instead),
    and OpenCV's files have OpenCV's limits."""
    if width * height > MAX_PIXELS:
        raise ValueError(f"{path}: a {fmt} image of {width} x {height} "
                         f"pixels, past the limit of {MAX_PIXELS}")


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ApplyExifOrientation (and Pillow's ``exif_transpose``): 2
    mirrored, 3 turned half way, 4 flipped, 5 transposed, 6 turned
    clockwise, 7 transposed the other way, 8 turned anticlockwise; any
    other value changes nothing."""
    t = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
         4: lambda a: a[::-1], 5: lambda a: a.transpose(1, 0, 2),
         6: lambda a: a.transpose(1, 0, 2)[:, ::-1],
         7: lambda a: a.transpose(1, 0, 2)[::-1, ::-1],
         8: lambda a: a.transpose(1, 0, 2)[::-1]}.get(orientation)
    return img if t is None else np.ascontiguousarray(t(img))
