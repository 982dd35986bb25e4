"""The `issue_ms.stream` metric in `bigann-1m.stream`
(`segbench.spans.issue_ms`)."""
from segbench.spans import issue_ms as read  # noqa: F401
