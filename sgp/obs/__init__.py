from sgp.obs.monitor import ResidualWhitenessMonitor
from sgp.obs.profiling import (StepTimer, Throughput, profile_trace,
                               time_fn)

__all__ = ["ResidualWhitenessMonitor", "StepTimer", "Throughput",
           "profile_trace", "time_fn"]
