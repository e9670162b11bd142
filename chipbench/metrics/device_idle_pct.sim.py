"""The share of the traced window in which no operation ran on the
device (device trace)."""

from chipbench.trace import idle_pct as read  # noqa: F401
