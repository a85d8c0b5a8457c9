"""PV-US solar production dataset (NREL, 5,016 plants, year 2006).

Local-file loader mirroring ``lib/datasets/pv.py:11-95``: per-zone HDF5
files (``east.h5`` / ``west.h5`` with keys ``actual`` and ``metadata``),
east-duplicate plants dropped, gaussian-kernel similarity (theta=150 km)
over haversine distances of plant lat/lon. No network egress — files must
be provided locally; use :class:`SyntheticDiffusion` otherwise.
"""
from __future__ import annotations

import os
from typing import List, Optional, Union

import numpy as np

from sgp.data.datasets.base import TabularDataset
from sgp.graph.similarities import (correntropy, gaussian_kernel,
                                    geographical_distance)


class PvUS(TabularDataset):
    available_zones = ["east", "west"]
    similarity_options = {"distance", "correntropy"}

    def __init__(self, zones: Union[str, List, None] = None,
                 mask_zeros: bool = False, root: Optional[str] = None):
        if zones is None:
            zones = self.available_zones
        elif isinstance(zones, str):
            zones = [zones]
        assert set(zones).issubset(self.available_zones)
        self.zones = zones
        self.mask_zeros = mask_zeros
        super().__init__(root=root)

    @staticmethod
    def _read_zone(path):
        """Raw NREL zone HDF5 (keys ``actual``/``metadata``); pandas
        (pytables) layout first, portable h5py layout as fallback."""
        import pandas as pd
        try:
            return (pd.read_hdf(path, key="actual"),
                    pd.read_hdf(path, key="metadata"))
        except ImportError:
            import h5py

            from sgp.data.datasets.build import load_frame_h5
            actual = load_frame_h5(path, key="actual")
            with h5py.File(path, "r") as f:
                grp = f["metadata"]
                cols = {k: grp[k][()] for k in grp}
            md = pd.DataFrame(
                {k: (v.astype(str) if v.dtype.kind == "S" else v)
                 for k, v in cols.items()})
            if "plant_id" in md.columns:
                md = md.set_index("plant_id")
            return actual, md

    def load(self):
        import pandas as pd
        actual, metadata = [], []
        for zone in self.zones:
            path = os.path.join(self.root, f"{zone}.h5")
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"PvUS: expected {path}; no egress — provide files "
                    "locally or use SyntheticDiffusion.")
            a, m = self._read_zone(path)
            actual.append(a)
            metadata.append(m)
        actual = pd.concat(actual, axis=1).sort_index(axis=1, level=0)
        metadata = pd.concat(metadata, axis=0).sort_index()
        if len(self.zones) == 2:
            dup = metadata.index[[sid.endswith("-east")
                                  for sid in metadata.state_id]]
            metadata = metadata.drop(dup, axis=0)
            lvl = 0 if isinstance(actual.columns, pd.MultiIndex) else None
            actual = actual.drop(dup, axis=1, level=lvl)
        values = actual.values.astype(np.float32)
        self.target = values[..., None]
        self.mask = ((values > 0) if self.mask_zeros
                     else np.ones_like(values, bool))[..., None]
        self.index = np.asarray(actual.index.values, "datetime64[ns]")
        self.metadata = metadata

    def compute_similarity(self, method: str, theta: float = 150,
                           gamma: float = 0.05, **kwargs) -> np.ndarray:
        if method == "distance":
            coords = self.metadata.loc[:, ["lat", "lon"]].values
            dist = geographical_distance(coords, to_rad=True)
            return gaussian_kernel(dist, theta=theta)
        if method == "correntropy":
            steps_per_week = int(np.timedelta64(7, "D")
                                 / (self.index[1] - self.index[0]))
            x = self.target[..., 0]
            x = (x - x.mean()) / x.std()
            return correntropy(x, period=steps_per_week, gamma=gamma)
        raise NotImplementedError(method)
