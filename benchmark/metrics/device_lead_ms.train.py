"""How far the device ran behind the host when a train step opened, in the
program-traced steps (one queued ahead, as in the window): the mean
``d0 - t0`` of the program's ``train.step`` spans, in milliseconds (near 0:
the device waits for the host)."""

from benchmark.program_trace import lead_ms


def read(observed):
    return lead_ms(observed, "train.step")
