"""Index layouts (copy of `diffusiondrive_tpu/common/enums.py:BoundingBox2DIndex`)."""


class BoundingBox2DIndex:
    """Layout of the 2D (BEV) agent box predicted by the detection head."""

    X = 0
    Y = 1
    HEADING = 2
    LENGTH = 3
    WIDTH = 4

    POINT = slice(0, 2)
    STATE_SE2 = slice(0, 3)

    @classmethod
    def size(cls) -> int:
        return 5
