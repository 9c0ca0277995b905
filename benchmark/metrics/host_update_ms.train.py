"""The optimizer update's host time (clip, AdamW, schedule, EMA) in the
program-traced steps: the mean of the program's ``train.update`` spans, in
milliseconds."""

from benchmark.program_trace import span_ms


def read(observed):
    return span_ms(observed, "train.update")
