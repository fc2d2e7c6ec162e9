"""device_idle.generate: the share of the traced window in which no kernel,
copy or set ran on the card, in percent."""
from bench.yardstick.readers import idle as read  # noqa: F401
