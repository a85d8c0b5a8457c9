"""Synthetic missing-data utilities + imputation dataset view.

Counterpart of ``tsl/ops/imputation.py`` (``sample_mask`` :12-35,
``add_missing_values`` :70-102) and ``tsl/data/imputation_stds.py``: the
tooling for imputation experiments — inject synthetic missingness (point
failures + contiguous blackout windows) and expose a windowed dataset
whose input is the corrupted series and whose target is the original.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from sgp.data.spatiotemporal import Batch, SpatioTemporalDataset


def sample_mask(shape, p: float = 0.002, p_noise: float = 0.0,
                min_seq: int = 1, max_seq: int = 1,
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Sample a *missing* mask (True = missing): point noise with prob
    ``p_noise`` plus blackout windows of length ``[min_seq, max_seq]``
    starting with prob ``p`` (``imputation.py:12-35``)."""
    rng = rng or np.random.default_rng()
    mask = rng.random(shape) < p_noise
    starts = np.nonzero(rng.random(shape) < p)
    t = shape[0]
    for idx in zip(*starts):
        length = int(rng.integers(min_seq, max_seq + 1))
        s = idx[0]
        sl = (slice(s, min(s + length, t)),) + idx[1:]
        mask[sl] = True
    return mask


def add_missing_values(dataset: SpatioTemporalDataset, p_fault: float = 0.0015,
                       p_noise: float = 0.05, min_seq: int = 1,
                       max_seq: int = 10, seed: int = 56789
                       ) -> SpatioTemporalDataset:
    """Attach an ``eval_mask`` covariate of synthetically-missing points
    (valid in the original data, hidden for training) —
    ``imputation.py:70-102`` semantics."""
    rng = np.random.default_rng(seed)
    missing = sample_mask(dataset.target.shape, p=p_fault,
                          p_noise=p_noise, min_seq=min_seq,
                          max_seq=max_seq, rng=rng)
    eval_mask = missing & dataset.mask
    dataset.add_covariate("eval_mask", eval_mask.astype(np.float32),
                          pattern="t n c")
    return dataset


class ImputationDataset(SpatioTemporalDataset):
    """Windowed imputation view (``tsl/data/imputation_stds.py``).

    Batch contract — the SAME one ``train/imputer.py::
    make_imputer_train_step`` consumes (one contract, not two):

    - ``x``: the window with hidden (``eval_mask``) points zeroed —
      hidden values are never visible to the model;
    - ``y``: the raw window (ground truth, incl. hidden values) — the
      reconstruction target;
    - ``mask``: the TRAINING-observed mask, valid & ~eval — what the
      model may condition on (the trainer whitens a further random
      subset of it);
    - ``eval_mask``: the synthetically-hidden points — scored by the
      loss and by evaluation.
    """

    def gather_batch(self, item_idx, node_index=None) -> Batch:
        batch = super().gather_batch(item_idx, node_index=node_index)
        assert "eval_mask" in self.covariates, \
            "call add_missing_values first"
        w = self.windowing
        starts = self.indices()[np.asarray(item_idx)]
        w_steps = starts[:, None] + w.window_offsets()[None, :]
        ev = self.covariates["eval_mask"].value.astype(bool)
        ev_w = ev[w_steps]
        valid_w = self.mask[w_steps].astype(bool)
        y_w = self.target[w_steps]
        if node_index is not None:
            ni = np.asarray(node_index)
            ev_w = ev_w[..., ni, :]
            valid_w = valid_w[..., ni, :]
            y_w = y_w[..., ni, :]
        batch["x"] = np.where(ev_w, 0.0, batch["x"])
        # imputation target: the raw window itself
        batch["y"] = y_w
        batch["mask"] = valid_w & ~ev_w
        batch["eval_mask"] = ev_w
        return batch
