"""METR-LA traffic dataset loader.

Loads from local files (``<data_dir>/MetrLA/metr_la.h5`` +
``metr_la_dist.npy``) in the same layout the reference builds
(``tsl/datasets/metr_la.py:12-110``). This environment has no network
egress, so the download path is intentionally absent — place the files
locally or use :class:`SyntheticDiffusion` as a stand-in.
"""
from __future__ import annotations

import os

import numpy as np

from sgp.data.datasets.base import TabularDataset
from sgp.graph.similarities import gaussian_kernel


class _DistanceTrafficDataset(TabularDataset):
    """Shared loader for METR-LA / PEMS-BAY style (h5 + dist npy) data."""

    similarity_options = {"distance"}
    h5_name: str = ""
    dist_name: str = ""
    dist_csv_name: str = ""       # raw (from, to, cost) CSV
    ids_txt_name: str = ""        # sensor-id list ("" -> ids = h5 columns)
    freq = np.timedelta64(5, "m")
    mask_zeros = True
    impute_zeros = True

    def _maybe_build_dist(self, h5: str, dist: str):
        """Build the distance matrix from the raw CSV when the built
        ``.npy`` is absent (``tsl/datasets/metr_la.py:60-82`` /
        ``pems_bay.py:63-110``)."""
        from sgp.data.datasets.build import (build_distance_matrix,
                                             read_hdf_any,
                                             read_sensor_ids)
        csv = os.path.join(self.root, self.dist_csv_name)
        if not (self.dist_csv_name and os.path.exists(csv)):
            return False
        if self.ids_txt_name:
            ids = read_sensor_ids(os.path.join(self.root,
                                               self.ids_txt_name))
        else:
            ids = [int(c) for c in read_hdf_any(h5).columns]
        build_distance_matrix(csv, ids, out_npy=dist)
        return True

    def load(self):
        from sgp.data.datasets.build import read_hdf_any
        h5 = os.path.join(self.root, self.h5_name)
        dist = os.path.join(self.root, self.dist_name)
        if os.path.exists(h5) and not os.path.exists(dist):
            self._maybe_build_dist(h5, dist)
        if not (os.path.exists(h5) and os.path.exists(dist)):
            raise FileNotFoundError(
                f"{type(self).__name__}: expected {h5} and {dist}. "
                "No network egress in this environment — provide the files "
                "or use SyntheticDiffusion.")
        import pandas as pd
        df = read_hdf_any(h5)
        # reindex onto a complete uniform grid (missing rows -> NaN)
        idx = sorted(df.index)
        full = pd.date_range(idx[0], idx[-1], freq="5min")
        df = df.reindex(index=full)
        values = df.values.astype(np.float32)
        mask = np.ones_like(values, bool)
        if self.mask_zeros:
            mask &= values != 0.0
        mask &= ~np.isnan(values)
        if self.impute_zeros:
            # forward-fill masked-out entries
            filled = np.where(mask, values, np.nan)
            df2 = pd.DataFrame(filled).ffill().bfill()
            values = np.nan_to_num(df2.values.astype(np.float32))
        self.target = values[..., None]
        self.mask = mask[..., None]
        self.index = np.asarray(full.values, "datetime64[ns]")
        self.dist = np.load(dist)

    def compute_similarity(self, method: str, **kwargs) -> np.ndarray:
        assert method == "distance"
        finite = self.dist.reshape(-1)
        finite = finite[~np.isinf(finite)]
        sigma = finite.std()
        sim = gaussian_kernel(self.dist, sigma)
        sim[np.isinf(self.dist)] = 0.0
        return sim


class MetrLA(_DistanceTrafficDataset):
    """207 LA loop detectors, 5-min, Mar-Jun 2012 (34,272 steps)."""
    h5_name = "metr_la.h5"
    dist_name = "metr_la_dist.npy"
    dist_csv_name = "distances_la.csv"
    ids_txt_name = "sensor_ids_la.txt"


class _PemsBayBase(_DistanceTrafficDataset):
    h5_name = "pems_bay.h5"
    dist_name = "pems_bay_dist.npy"
    dist_csv_name = "distances_bay.csv"
    ids_txt_name = ""    # BAY sensor ids come from the h5 columns
