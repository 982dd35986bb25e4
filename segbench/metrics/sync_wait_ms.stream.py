"""The `sync_wait_ms.stream` metric in `bigann-1m.stream`
(`segbench.spans.sync_wait_ms`)."""
from segbench.spans import sync_wait_ms as read  # noqa: F401
