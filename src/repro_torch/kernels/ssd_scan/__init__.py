from .ops import ssd_intra  # noqa: F401
from .ref import ssd_intra_plain  # noqa: F401
