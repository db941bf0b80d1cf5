from .running import (RunningMean, RunningSecondMoment, RunningVariance,
                      RunningCovariance, RunningCrossCovariance,
                      RunningBincount, RunningTopK,
                      RunningAllIntersectionAndUnion,
                      RunningConditionalMean, RunningConditionalVariance,
                      RunningConditionalTopK, RunningConditionalQuantile)
from .quantile import RunningQuantile
from . import tally

__all__ = ["RunningMean", "RunningSecondMoment", "RunningVariance",
           "RunningCovariance", "RunningCrossCovariance", "RunningBincount",
           "RunningTopK", "RunningQuantile",
           "RunningAllIntersectionAndUnion", "RunningConditionalMean",
           "RunningConditionalVariance", "RunningConditionalTopK",
           "RunningConditionalQuantile", "tally"]
