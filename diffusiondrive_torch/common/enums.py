"""Index layouts (copies of `diffusiondrive_tpu/common/enums.py:BoundingBox2DIndex`, `LidarIndex`)."""


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


class LidarIndex:
    """Layout of a packed lidar point-cloud array (6, num_points)."""

    X = 0
    Y = 1
    Z = 2
    INTENSITY = 3
    RING = 4
    ID = 5

    POINT2D = slice(0, 2)
    POSITION = slice(0, 3)

    @classmethod
    def size(cls) -> int:
        return 6
