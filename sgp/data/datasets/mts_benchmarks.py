"""Classic multivariate time-series benchmarks.

Counterpart of ``tsl/datasets/mts_benchmarks.py:9-189`` (Electricity /
TrafficBenchmark / Solar / Exchange; present in the reference zoo,
unused by its experiments). Local-file loaders (no egress): each expects
a ``<name>.txt.gz`` / ``.txt`` / ``.csv`` of shape ``[T, N]`` under
``<data_dir>/<ClassName>/`` — the LSTNet benchmark layout.
"""
from __future__ import annotations

import gzip
import os

import numpy as np

from sgp.data.datasets.base import TabularDataset
from sgp.graph.similarities import pearson_similarity


class _MTSBenchmark(TabularDataset):
    similarity_options = {"pearson"}
    file_stem: str = ""
    start: str = "2000-01-01T00:00"
    freq_minutes: int = 60

    def load(self):
        for ext in (".txt.gz", ".txt", ".csv"):
            path = os.path.join(self.root, self.file_stem + ext)
            if os.path.exists(path):
                break
        else:
            raise FileNotFoundError(
                f"{type(self).__name__}: no {self.file_stem}.txt[.gz] "
                f"under {self.root} (no egress — provide locally)")
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as fp:
            values = np.loadtxt(fp, delimiter=",", dtype=np.float32)
        self.target = values[..., None]
        self.mask = np.ones_like(self.target, bool)
        t = len(values)
        self.index = (np.datetime64(self.start)
                      + np.arange(t) * np.timedelta64(self.freq_minutes,
                                                      "m")
                      ).astype("datetime64[ns]")

    def compute_similarity(self, method: str, **kwargs) -> np.ndarray:
        assert method == "pearson"
        sim = pearson_similarity(self.target[..., 0].T)
        np.fill_diagonal(sim, 0.0)
        return np.abs(sim)


class ElectricityBenchmark(_MTSBenchmark):
    """321 clients' hourly electricity consumption (2012-2014)."""
    file_stem = "electricity"
    start = "2012-01-01T00:00"
    freq_minutes = 60


class TrafficBenchmark(_MTSBenchmark):
    """862 SF Bay Area lane occupancy rates, hourly (2015-2016)."""
    file_stem = "traffic"
    start = "2015-01-01T00:00"
    freq_minutes = 60


class SolarBenchmark(_MTSBenchmark):
    """137 Alabama PV plants, 10-minute (2006)."""
    file_stem = "solar_AL"
    start = "2006-01-01T00:00"
    freq_minutes = 10


class ExchangeBenchmark(_MTSBenchmark):
    """8 daily exchange rates (1990-2016)."""
    file_stem = "exchange_rate"
    start = "1990-01-01T00:00"
    freq_minutes = 24 * 60
