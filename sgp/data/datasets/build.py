"""Build-from-raw dataset pipelines (host-side, no downloads).

The reference builds its benchmark datasets from raw licensed/archived
files; this module reproduces those builds on LOCAL raw files (network
egress is unavailable, so the download step is intentionally absent):

- METR-LA / PEMS-BAY: sensor-distance CSV -> ``[n, n]`` distance matrix
  (``tsl/datasets/metr_la.py:60-82``, ``pems_bay.py:63-110``).
- CER-En: six ``File<i>.txt.zip`` archives of (id, datetime-code, load)
  rows -> pivoted/merged/validated 30-min frame
  (``lib/datasets/cer_en.py:78-114``).
- PV-US's "build" IS its raw-HDF5 load (zone concat + east-duplicate
  drop, ``lib/datasets/pv.py:65-81``) — implemented in
  :mod:`sgp.data.datasets.pv_us`.

HDF5 IO uses a portable h5py layout (``values``/``index``/``columns``)
because pandas' HDF backend (pytables) is not available here; loaders
try pandas first and fall back to this layout.
"""
from __future__ import annotations

import os
from datetime import datetime, timedelta
from typing import List, Optional, Sequence

import numpy as np

# -- portable HDF5 frame IO (h5py layout) -----------------------------------


def save_frame_h5(path: str, values: np.ndarray, index: np.ndarray,
                  columns: Optional[Sequence] = None, key: str = "data"):
    """``values [T, N]`` + datetime64 index (+ column ids) -> HDF5."""
    import h5py
    with h5py.File(path, "a") as f:
        if key in f:
            del f[key]
        grp = f.create_group(key)
        grp.create_dataset("values", data=np.asarray(values, np.float32))
        grp.create_dataset(
            "index", data=np.asarray(index, "datetime64[ns]").astype(np.int64))
        if columns is not None:
            cols = np.asarray(columns)
            if cols.dtype.kind in "UO":
                cols = cols.astype("S")
            grp.create_dataset("columns", data=cols)


def load_frame_h5(path: str, key: str = "data"):
    """Read the :func:`save_frame_h5` layout -> pandas DataFrame."""
    import h5py
    import pandas as pd
    with h5py.File(path, "r") as f:
        grp = f[key]
        values = grp["values"][()]
        index = pd.to_datetime(grp["index"][()].astype("datetime64[ns]"))
        columns = grp["columns"][()] if "columns" in grp else None
    if columns is not None and columns.dtype.kind == "S":
        columns = columns.astype(str)
    return pd.DataFrame(values, index=index, columns=columns)


def read_hdf_any(path: str, key: str = "data"):
    """pandas HDF (pytables) if available, else the h5py layout."""
    import pandas as pd
    try:
        return pd.read_hdf(path)
    except ImportError:
        return load_frame_h5(path, key=key)


# -- METR-LA / PEMS-BAY distance matrix --------------------------------------


def build_distance_matrix(dist_csv: str, ids: Sequence[int],
                          out_npy: Optional[str] = None) -> np.ndarray:
    """Directed sensor-distance matrix from a (from, to, cost) CSV
    (``tsl/datasets/metr_la.py:60-82``): ``inf`` where no entry; rows
    whose endpoints are not in ``ids`` are dropped."""
    import pandas as pd
    distances = pd.read_csv(dist_csv)
    num_sensors = len(ids)
    dist = np.full((num_sensors, num_sensors), np.inf, np.float32)
    sensor_to_ind = {int(s): i for i, s in enumerate(ids)}
    for row in distances.values:
        if row[0] not in sensor_to_ind or row[1] not in sensor_to_ind:
            continue
        dist[sensor_to_ind[row[0]], sensor_to_ind[row[1]]] = row[2]
    if out_npy is not None:
        np.save(out_npy, dist)
    return dist


def read_sensor_ids(ids_txt: str) -> List[int]:
    """``sensor_ids_la.txt``: one comma-separated line of sensor ids."""
    with open(ids_txt) as f:
        return [int(s) for s in f.read().strip().split(",")]


# -- CER-En zip-archive build -------------------------------------------------

CER_START = datetime(2008, 12, 31, 0, 0)
CER_SAMPLES_PER_DAY = 48


def _cer_parse_date(code: int) -> datetime:
    """Day/slot code -> timestamp (``lib/datasets/cer_en.py:25-33``):
    ``code = day*100 + halfhour_slot`` counted from 2008-12-31."""
    return CER_START + timedelta(days=int(code) // 100) \
        + timedelta(hours=0.5 * (int(code) % 100))


def build_cer_en(root: str, out_name: str = "cer_en.h5"):
    """Build the CER-En frame from the licensed ``File<i>.txt.zip``
    archives in ``root`` (``lib/datasets/cer_en.py:78-114``): read each
    zip's space-separated (id, datetime-code, load) rows, pivot to
    (datetime, meter), inner-merge across archives, drop slot codes
    outside (0, 48], decode timestamps, de-duplicate, save as HDF5.
    Returns the built DataFrame."""
    from functools import reduce
    from zipfile import ZipFile

    import pandas as pd

    zips = sorted(f for f in os.listdir(root) if f.endswith(".zip"))
    if not zips:
        raise FileNotFoundError(f"no CER zip archives in {root}")
    dfs = []
    for name in zips:
        zf = ZipFile(os.path.join(root, name))
        with zf.open(zf.infolist()[0]) as fp:
            data = pd.read_csv(fp, sep=" ", header=None,
                               names=["id", "datetime", "load"])
        data = data.apply(pd.to_numeric)
        dfs.append(pd.pivot_table(data, values="load", index=["datetime"],
                                  columns=["id"]))
    df = reduce(lambda lt, rt: pd.merge(lt, rt, on="datetime"), dfs)
    df = df.reset_index()
    ts = df["datetime"].values % 100
    df = df[(ts > 0) & (ts <= CER_SAMPLES_PER_DAY)]
    index = pd.to_datetime(df["datetime"].apply(_cer_parse_date))
    df = df.drop(columns=["datetime"]).set_index(index).astype("float32")
    df.index.name = "datetime"
    df = df[~df.index.duplicated()]
    path = os.path.join(root, out_name)
    try:
        df.to_hdf(path, key="data", complevel=3)
    except ImportError:
        save_frame_h5(path, df.values, df.index.values,
                      df.columns.to_numpy())
    return df
