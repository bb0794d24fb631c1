"""Framework constants (counterpart of ``CONST`` in ``poem_v2_tpu/utils/misc.py``),
as far as the data layer needs them."""


class CONST:
    UVD_DEPTH_RANGE = 0.4  # metres: the depth span of the UVD transform's unit range
