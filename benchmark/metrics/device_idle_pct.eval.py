"""100 minus the share of the traced slice that the union of the device's
events covers."""
from benchmark.metrics._share import idle_pct


def read(run):
    return idle_pct(run)
