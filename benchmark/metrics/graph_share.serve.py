"""The share of the network's forwards in the program-traced requests that
replayed a CUDA graph: the program's counters ``network.graph_replays``
over ``network.forwards``, in percent (None where the program counts no
forwards)."""

from benchmark.program_trace import count


def read(observed):
    forwards = count(observed, "network.forwards")
    if not forwards:
        return None
    return 100.0 * (count(observed, "network.graph_replays") or 0) / forwards
