"""The `device_idle.stream` metric in `bigann-1m.stream`
(`segbench.reduce.device_idle`)."""
from segbench.reduce import device_idle as read  # noqa: F401
