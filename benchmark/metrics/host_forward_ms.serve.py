"""The network's forward's host time in the program-traced requests: the
mean of the program's ``network.forward`` spans, in milliseconds (a step's
less it is the sampler's own time)."""

from benchmark.program_trace import span_ms


def read(observed):
    return span_ms(observed, "network.forward")
