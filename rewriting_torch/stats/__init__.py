from .running import RunningMean, RunningSecondMoment
from . import tally

__all__ = ["RunningMean", "RunningSecondMoment", "tally"]
