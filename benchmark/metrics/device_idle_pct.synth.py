"""The share of the profiled stretch in which the device ran nothing."""
from benchmark.readers import device_idle_pct as read  # noqa: F401
