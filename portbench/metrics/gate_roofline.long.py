"""The gate as a whole, % of its memory roofline (``readers.gate_roofline``)."""
from portbench.readers import gate_roofline as read  # noqa: F401
