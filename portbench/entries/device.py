"""Entry ``device``: ``pipeline.match`` on stacks already on the device.

One pair is one ``libbicos_tpu_torch.pipeline.match(s0, s1, cfg,
corrmap=...)`` with the default device (the card) and backend, ended by a
synchronize; the maps stay on the device. The harness keeps the pool on
the device, so its bytes are the harness's, not the program's.
"""

from __future__ import annotations

import torch

from libbicos_tpu_torch import pipeline


class Entry:
    """What the harness calls of an entry kind: ``call(p)`` runs pool pair
    ``p`` and returns its answer, the ``(disparity, corrmap)`` maps;
    ``finish()`` waits until nothing is in flight; ``harness_bytes()``
    counts what the harness, not the program, holds on the card;
    ``close()`` frees the program's state after the window; ``inputs(p)``
    gives pair ``p`` to the reference."""

    def __init__(self, cfg, pool, device, backend: str, corrmap: bool):
        self.cfg = cfg
        self.pool = pool
        self.device = torch.device(device)
        # The card's default; a CPU rehearsal names its device.
        self.kw = {"backend": backend, "corrmap": corrmap}
        if self.device.type != "cuda":
            self.kw["device"] = self.device

    def call(self, p: int):
        s0, s1 = self.pool[p]
        return pipeline.match(s0, s1, self.cfg, **self.kw)

    def finish(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def harness_bytes(self) -> int:
        return sum(s.numel() * s.element_size() for pair in self.pool
                   for s in pair)

    def inputs(self, p: int):
        return self.pool[p]

    def close(self) -> None:
        """The program holds no state between calls."""
