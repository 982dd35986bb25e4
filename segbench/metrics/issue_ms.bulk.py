"""The `issue_ms.bulk` metric in `bigann-4x250k.bulk`
(`segbench.spans.issue_ms`)."""
from segbench.spans import issue_ms as read  # noqa: F401
