"""The 50 GroupNorm/AdaGN + SiLU of each profiled forward: their least time
(``roofline/kernels.py::group_norm``) over the device time of the kernels
launched inside the network's ``fused_group_norm_silu`` calls, in percent."""

from benchmark.trace import roofline_share


def read(observed):
    return roofline_share(observed, "group_norm")
