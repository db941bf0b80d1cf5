from .running import RunningSecondMoment
from . import tally

__all__ = ["RunningSecondMoment", "tally"]
