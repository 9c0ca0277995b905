"""Operations of one forward of one image, from a configuration's sizes
(a multiply-add counts 2): the sum of what the configuration's architecture
module (``architectures/``) counts by kind in ``flops(cfg)``."""

from __future__ import annotations

from .. import manifest


def forward_flops(cfg: dict) -> int:
    """All the operations of one forward of one image."""
    return sum(manifest.architecture(cfg).flops(cfg).values())
