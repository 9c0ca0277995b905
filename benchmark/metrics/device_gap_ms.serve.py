"""The device's wait between requests in the program-traced segment: from
one request's last ``sampler.step`` ending on the device to the next
request's first starting there, the mean over consecutive requests, in
milliseconds."""

from benchmark.program_trace import unit_gap_ms


def read(observed):
    return unit_gap_ms(observed, "sampler.step")
