"""``device_idle.train``: the share of the traced steps' wall time in
which no operation ran on the card, in percent."""

from portbench.trace import idle_pct


def read(r: dict):
    return idle_pct(r.get("trace"))
