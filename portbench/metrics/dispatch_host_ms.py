"""Median host ms a call spends issuing its work (``readers.dispatch_ms``)."""
from portbench.readers import dispatch_ms as read  # noqa: F401
