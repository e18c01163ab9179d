"""Host-side helpers of the port."""
from .batch_sender import BatchSender
from .time_tracker import TimeTracker

__all__ = ["BatchSender", "TimeTracker"]
