"""How far the device ran behind the host when a denoising step opened, in
the program-traced requests: the mean ``d0 - t0`` of the program's
``sampler.step`` spans, in milliseconds (near 0: the device waits for the
host)."""

from benchmark.program_trace import lead_ms


def read(observed):
    return lead_ms(observed, "sampler.step")
