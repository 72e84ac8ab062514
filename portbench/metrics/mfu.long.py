"""The whole call's share of the card's FP32 peak, % (``readers.gate_mfu``)."""
from portbench.readers import gate_mfu as read  # noqa: F401
