"""CER-En Irish smart-meter energy dataset (6,435 meters, 30-min).

Local-file loader mirroring ``lib/datasets/cer_en.py:36-167``: a
pre-built ``cer_en.h5`` (the reference builds it from the six CER zip
archives; data requires a license request, so only the built file is
consumed here). Similarity by weekly-window correntropy or
seasonally-debiased pearson.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from sgp.data.datasets.base import TabularDataset
from sgp.graph.similarities import correntropy

AGG_SCALE = 1000


class CEREn(TabularDataset):
    similarity_options = {"correntropy", "pearson"}

    def load(self):
        from sgp.data.datasets.build import build_cer_en, read_hdf_any
        path = os.path.join(self.root, "cer_en.h5")
        if not os.path.exists(path):
            # build-from-raw: the six licensed File<i>.txt.zip archives
            # (``lib/datasets/cer_en.py:78-114``)
            zips = [f for f in (os.listdir(self.root)
                                if os.path.isdir(self.root) else [])
                    if f.endswith(".zip")]
            if zips:
                build_cer_en(self.root)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"CEREn: expected {path} (or the raw File<i>.txt.zip "
                "archives); the CER dataset is license-gated — provide "
                "the files or use SyntheticDiffusion.")
        df = read_hdf_any(path)
        df = df.asfreq("30min")
        values = df.values.astype(np.float32)
        self.mask = (~np.isnan(values))[..., None]
        self.target = np.nan_to_num(values)[..., None]
        self.index = np.asarray(df.index.values, "datetime64[ns]")

    def compute_similarity(self, method: str, gamma: float = 0.05,
                           train_slice: Optional[np.ndarray] = None,
                           **kwargs) -> np.ndarray:
        x = self.target[..., 0] * self.mask[..., 0]
        mask = self.mask[..., 0:1].astype(np.uint8)
        if train_slice is not None:
            x = self.target[train_slice, :, 0]
            mask = mask[train_slice]
        if method == "pearson":
            return np.corrcoef(x, rowvar=False)
        if method == "correntropy":
            xs = (x - x.mean()) / x.std()
            step = self.index[1] - self.index[0]
            period = int(np.timedelta64(7, "D") / step)
            # masked weekly-window correntropy (windows with missing
            # values excluded, matching the reference's mask handling)
            return correntropy(xs, period=period, mask=mask, gamma=gamma)
        raise NotImplementedError(method)
