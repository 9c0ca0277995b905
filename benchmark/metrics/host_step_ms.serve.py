"""A denoising step's host time in the program-traced requests: the mean
of the program's ``sampler.step`` spans, in milliseconds."""

from benchmark.program_trace import span_ms


def read(observed):
    return span_ms(observed, "sampler.step")
