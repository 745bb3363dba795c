"""``device_idle.serve``: the share of the traced stretch of the serving
window in which no operation ran on the card, in percent."""

from portbench.trace import idle_pct


def read(r: dict):
    return idle_pct(r.get("trace"))
