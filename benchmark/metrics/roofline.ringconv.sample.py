"""The 48 ResidualBlock 3x3 ring convs of each profiled forward: their least
time (``roofline/kernels.py::ringconv``) over the device time of the kernels
launched inside ``ResidualBlock._conv``, in percent. Nothing when no call was
seen or no kernel ran inside them."""

from benchmark.trace import roofline_share


def read(observed):
    return roofline_share(observed, "ringconv")
