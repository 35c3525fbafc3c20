"""repro_torch.ft — fault tolerance: the step watchdog and the heartbeat."""
from repro_torch.ft.watchdog import Heartbeat, StepWatchdog, WatchdogEvent

__all__ = ["Heartbeat", "StepWatchdog", "WatchdogEvent"]
