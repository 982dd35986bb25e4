"""The `round_kernels_roofline.bulk` metric in `bigann-4x250k.bulk`
(`segbench.reduce.round_kernels_roofline`)."""
from segbench.reduce import round_kernels_roofline as read  # noqa: F401
