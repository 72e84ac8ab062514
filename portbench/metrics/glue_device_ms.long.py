"""Device ms a call of operations that are none of the port's kernels
(``readers.glue_ms``)."""
from portbench.readers import glue_ms as read  # noqa: F401
