"""Image metadata and the fixed quality constants.

The port's copy of hydrium_tpu/config.py, trimmed to what the port
uses.  Mirrors the capability surface of hydrium's `HYDImageMetadata`
(reference: src/include/libhydrium/libhydrium.h:109-155).
"""

from __future__ import annotations

import dataclasses
import enum


class SampleFormat(enum.Enum):
    """Input sample formats (libhydrium.h:103-107)."""

    UINT8 = "uint8"
    UINT16 = "uint16"
    FLOAT32 = "float32"


HYD_UINT8 = SampleFormat.UINT8
HYD_UINT16 = SampleFormat.UINT16
HYD_FLOAT32 = SampleFormat.FLOAT32

MAX_DIM = 1 << 30          # per-side limit (libhydrium.c:54)
MAX_PIXELS = 1 << 40       # total-pixel limit (libhydrium.c:60)
LEVEL10_DIM = 1 << 20      # level-10 container threshold (libhydrium.c:67)
LEVEL10_AREA = 1 << 28

GROUP_DIM = 256            # HF group side in pixels
LF_GROUP_DIM = 2048        # LF group side in pixels (one-frame mode tile)


@dataclasses.dataclass
class ImageMetadata:
    """Validated image-level parameters.

    tile_size_shift_{x,y}: 0..3 => tile side 256<<shift; -1 => one-frame
    mode (whole image as a single frame of 2048x2048 LF groups), matching
    libhydrium.h:129-154.
    """

    width: int
    height: int
    linear_light: bool = False
    tile_size_shift_x: int = -1
    tile_size_shift_y: int = -1

    def validate(self) -> None:
        if self.width <= 0 or self.height <= 0:
            raise ValueError("invalid zero-width or zero-height")
        if self.width > MAX_DIM or self.height > MAX_DIM:
            raise ValueError("width or height out of bounds")
        if self.width * self.height > MAX_PIXELS:
            raise ValueError("width times height out of bounds")
        for s in (self.tile_size_shift_x, self.tile_size_shift_y):
            if s < -1 or s > 3:
                raise ValueError("tile_size_shift must be between -1 and 3")

    @property
    def one_frame(self) -> bool:
        return self.tile_size_shift_x < 0 or self.tile_size_shift_y < 0

    @property
    def level10(self) -> bool:
        return (
            self.width > LEVEL10_DIM
            or self.height > LEVEL10_DIM
            or self.width * self.height > LEVEL10_AREA
        )

    @property
    def lfg_count_x(self) -> int:
        return (self.width + LF_GROUP_DIM - 1) // LF_GROUP_DIM

    @property
    def lfg_count_y(self) -> int:
        return (self.height + LF_GROUP_DIM - 1) // LF_GROUP_DIM

    @property
    def lfg_per_frame(self) -> int:
        """LF groups per frame: all of them in one-frame mode, else 1
        (each tile is its own frame). libhydrium.c:82."""
        if self.one_frame:
            return self.lfg_count_x * self.lfg_count_y
        return 1

    @property
    def tile_width(self) -> int:
        """Tile width in pixels for tiled mode."""
        return GROUP_DIM << max(self.tile_size_shift_x, 0)

    @property
    def tile_height(self) -> int:
        return GROUP_DIM << max(self.tile_size_shift_y, 0)


# Fixed quality profile constants (hydrium has no quality knob;
# encoder.c:517-519), written into every LFGlobal section.
GLOBAL_SCALE = 32768
QUANT_LF = 4
