"""The `coord_self_ms.bulk` metric in `bigann-4x250k.bulk`
(`segbench.reduce.coord_self_ms`)."""
from segbench.reduce import coord_self_ms as read  # noqa: F401
