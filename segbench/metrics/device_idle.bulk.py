"""The `device_idle.bulk` metric in `bigann-4x250k.bulk`
(`segbench.reduce.device_idle`)."""
from segbench.reduce import device_idle as read  # noqa: F401
