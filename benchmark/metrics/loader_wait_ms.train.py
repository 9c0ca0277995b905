"""The host's mean wait on the loader's ``next()`` per train step of the
window, in milliseconds (a span the benchmark records around the call)."""


def read(observed):
    waits = observed.get("loader_wait_s")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
