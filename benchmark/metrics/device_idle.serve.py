"""The share of the timed window in which no operation ran on the device:
one minus the device's busy seconds a unit of work in the device-only
profiled window (the union of its operations' intervals) times the units the
timed window completed, over its seconds; in percent."""

from benchmark.trace import idle_share


def read(observed):
    return idle_share(observed)
