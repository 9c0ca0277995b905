"""The share of the trainer's batches that it asked the loader for while
the loader's prefetch queue was empty, in the program-traced steps: the
program's counters ``data.gets_empty`` over ``data.gets``, in percent."""

from benchmark.program_trace import count


def read(observed):
    gets = count(observed, "data.gets")
    if not gets:
        return None
    return 100.0 * (count(observed, "data.gets_empty") or 0) / gets
