"""The `sync_wait_ms.bulk` metric in `bigann-4x250k.bulk`
(`segbench.spans.sync_wait_ms`)."""
from segbench.spans import sync_wait_ms as read  # noqa: F401
