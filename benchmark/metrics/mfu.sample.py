"""The network's operations over the timed window (the frozen count of a
forward, ``roofline/flops.py``, times the images and forwards of the work the
window completed, three times that for a train step) over the window's
seconds times the card's bf16 peak, in percent."""

from benchmark.trace import mfu


def read(observed):
    return mfu(observed)
