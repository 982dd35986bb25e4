"""The `round_kernels_roofline.stream` metric in `bigann-1m.stream`
(`segbench.reduce.round_kernels_roofline`)."""
from segbench.reduce import round_kernels_roofline as read  # noqa: F401
