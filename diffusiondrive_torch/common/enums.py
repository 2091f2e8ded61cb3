"""Index layouts: copies of `diffusiondrive_tpu/common/enums.py` (`BoundingBoxIndex`,
`BoundingBox2DIndex`, `LidarIndex`, `StateIndex`, `BBCoordsIndex` and the
scorer's `EgoAreaIndex`, `MultiMetricIndex`, `WeightedMetricIndex`) and of
`diffusiondrive_tpu/evaluate/observation.py:MapLayer`, with the same values."""


class BoundingBoxIndex:
    """Layout of a 3D bounding box array in logs: (x, y, z, l, w, h, heading)."""

    X = 0
    Y = 1
    Z = 2
    LENGTH = 3
    WIDTH = 4
    HEIGHT = 5
    HEADING = 6

    POINT2D = slice(0, 2)
    POSITION = slice(0, 3)
    DIMENSION = slice(3, 6)

    @classmethod
    def size(cls) -> int:
        return 7


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


class StateIndex:
    """Layout of the 11-field dynamic ego state array."""

    X = 0
    Y = 1
    HEADING = 2
    VELOCITY_X = 3
    VELOCITY_Y = 4
    ACCELERATION_X = 5
    ACCELERATION_Y = 6
    STEERING_ANGLE = 7
    STEERING_RATE = 8
    ANGULAR_VELOCITY = 9
    ANGULAR_ACCELERATION = 10

    POINT = slice(0, 2)
    STATE_SE2 = slice(0, 3)
    VELOCITY_2D = slice(3, 5)
    ACCELERATION_2D = slice(5, 7)

    @classmethod
    def size(cls) -> int:
        return 11


class BBCoordsIndex:
    """Corner layout of an oriented-box coordinate array (4 corners + center)."""

    FRONT_LEFT = 0
    REAR_LEFT = 1
    REAR_RIGHT = 2
    FRONT_RIGHT = 3
    CENTER = 4

    @classmethod
    def size(cls) -> int:
        return 5


class MapLayer:
    """Semantic map layers (the values a map API is queried with)."""

    LANE = 0
    LANE_CONNECTOR = 1
    ROADBLOCK = 2
    ROADBLOCK_CONNECTOR = 3
    INTERSECTION = 4
    DRIVABLE_AREA = 5
    CARPARK_AREA = 6
    WALKWAYS = 7
    CROSSWALK = 8

    DRIVABLE = (ROADBLOCK, INTERSECTION, DRIVABLE_AREA, CARPARK_AREA)
    DRIVABLE_LANES = (LANE, LANE_CONNECTOR)


class EgoAreaIndex:
    """Ego-area classification channels used by the PDM scorer
    (`pdm_planner/utils/pdm_enums.py:EgoAreaIndex`)."""

    MULTIPLE_LANES = 0
    NON_DRIVABLE_AREA = 1
    ONCOMING_TRAFFIC = 2

    @classmethod
    def size(cls) -> int:
        return 3


class MultiMetricIndex:
    """Multiplicative sub-metrics of the PDM score; driving direction is not
    one of them: it lives in `WeightedMetricIndex` (with weight 0)."""

    NO_COLLISION = 0
    DRIVABLE_AREA = 1

    @classmethod
    def size(cls) -> int:
        return 2


class WeightedMetricIndex:
    """Weighted-average sub-metrics of the PDM score. The scorer builds its
    weight vector in this order (`evaluate/scorer.py:score_proposals`)."""

    PROGRESS = 0
    TTC = 1
    COMFORTABLE = 2
    DRIVING_DIRECTION = 3

    @classmethod
    def size(cls) -> int:
        return 4
