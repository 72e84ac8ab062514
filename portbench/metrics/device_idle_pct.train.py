"""Share of the traced window with the card idle, % (``readers.idle_pct``)."""
from portbench.readers import idle_pct as read  # noqa: F401
