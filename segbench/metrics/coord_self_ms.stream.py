"""The `coord_self_ms.stream` metric in `bigann-1m.stream`
(`segbench.reduce.coord_self_ms`)."""
from segbench.reduce import coord_self_ms as read  # noqa: F401
