"""The streaming tracker: producer framing, the batched demod and CRS
extraction on the device, host float64 per-cell control loops, the
background searcher and the dashboard."""

from .state import GlobalState, TrackedCell  # noqa: F401
from .runner import TrackerRunner  # noqa: F401
