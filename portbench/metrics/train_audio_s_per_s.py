"""Channel-seconds of audio over the window's wall seconds (``readers.window_rate``)."""
from portbench.readers import window_rate as read  # noqa: F401
