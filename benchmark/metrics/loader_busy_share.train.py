"""The share of the program-traced segment's host time in which the
loader's prefetch thread was building a batch: the program's
``data.make_batch`` spans over the segment, in percent."""

from benchmark.program_trace import share


def read(observed):
    return share(observed, "data.make_batch")
