"""Online model-health monitoring for serving.

Wraps the AZ-whiteness test (``sgp/analysis/whiteness.py``, the
reference's ``tsl/ops/framearray.py`` analysis counterpart) as a
ROLLING monitor over live forecast residuals: if the one-step-ahead
residual stream stops being serially/spatially white, the model no
longer captures the process (drift, regime change, sensor failure) and
the monitor flags it. Host-side numpy over a bounded window — zero
device cost next to the serving dispatch.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

from sgp.analysis.whiteness import az_whiteness_test


class ResidualWhitenessMonitor:
    """Rolling AZ-whiteness test over the last ``window`` residuals.

    Args:
        edge_index: spatial topology ``[2, E]`` (or a ``Graph``, whose
            edge weights are then used in the spatial statistic).
        window: number of most-recent steps tested.
        alpha: significance level — ``update`` reports
            ``flagged=True`` when the test's p-value drops below it.
        min_steps: don't test before this many residuals arrived.
        edge_weight: ``[E]`` spatial edge weights (overrides a
            ``Graph``'s; ignored weights default to 1.0 in the test).
    """

    def __init__(self, edge_index, window: int = 64,
                 alpha: float = 0.05, min_steps: int = 8,
                 edge_weight=None):
        if hasattr(edge_index, "src"):          # a Graph
            if edge_weight is None:
                edge_weight = np.asarray(edge_index.weight, np.float64)
            edge_index = np.stack([np.asarray(edge_index.src),
                                   np.asarray(edge_index.dst)])
        self.edge_index = np.asarray(edge_index)
        self.edge_weight = (None if edge_weight is None
                            else np.asarray(edge_weight, np.float64))
        if min_steps > window:
            raise ValueError(
                f"min_steps={min_steps} > window={window}: the rolling "
                f"buffer caps at `window` residuals, so the monitor "
                f"would never run a test")
        if min_steps < 2:
            raise ValueError("min_steps must be >= 2 (the temporal "
                             "statistic needs consecutive residuals)")
        self.window = window
        self.alpha = alpha
        self.min_steps = min_steps
        self._buf: deque = deque(maxlen=window)
        self._mask: deque = deque(maxlen=window)
        self.last_result = None

    def update(self, residual, mask=None):
        """Ingest one step's residuals ``[N, C]`` (+ optional mask);
        returns the current test result (or None before ``min_steps``).
        ``result.flagged`` is set per the monitor's ``alpha``."""
        self._buf.append(np.asarray(residual, np.float64))
        self._mask.append(None if mask is None
                          else np.asarray(mask, bool))
        if len(self._buf) < self.min_steps:
            self.last_result = None
            return None
        x = np.stack(self._buf)                  # [W, N, C]
        masks = None
        if any(m is not None for m in self._mask):
            masks = np.stack([np.ones(x.shape[1:], bool) if m is None
                              else m for m in self._mask])
        res = az_whiteness_test(x, self.edge_index, mask=masks,
                                edge_weight=self.edge_weight)
        res.flagged = res.pvalue < self.alpha
        self.last_result = res
        return res

    def reset(self):
        self._buf.clear()
        self._mask.clear()
        self.last_result = None
