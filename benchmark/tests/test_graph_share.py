"""``graph_share.serve`` read from a synthetic program-traced segment: the
share of the network's forwards that replayed a CUDA graph."""

from __future__ import annotations

import pytest

from benchmark import manifest


@pytest.mark.parametrize("counters,share", [
    ({"network.forwards": 48, "network.graph_replays": 48, "network.graph_captures": 0}, 100.0),
    ({"network.forwards": 48}, 0.0),
    ({"network.forwards": 48, "network.graph_replays": 12}, 25.0),
    (None, None),
])
def test_graph_share_reads_the_replays_over_the_forwards(counters, share):
    """Every forward replayed, none (the counter absent, as when no graph
    ran), a quarter, and no segment kept (an untraced run)."""
    observed = {} if counters is None else {"program": {"spans": [], "counters": counters, "t0": 0.0, "t1": 1.0,
                                                        "units": 3}}
    assert manifest.reader("graph_share.serve")(observed) == share
