"""Build-from-raw dataset pipelines on tiny synthetic raw fixtures:
distance-CSV -> adjacency matrix; CER zip archives -> pivoted 30-min
frame; end-to-end loads through the built files (portable h5py HDF
layout — pytables is unavailable here)."""
import os
from datetime import timedelta
from zipfile import ZipFile

import numpy as np
import pytest


def test_build_distance_matrix(tmp_path):
    from sgp.data.datasets.build import (build_distance_matrix,
                                         read_sensor_ids)
    ids_txt = tmp_path / "sensor_ids_la.txt"
    ids_txt.write_text("101,202,303")
    csv = tmp_path / "distances_la.csv"
    csv.write_text("from,to,cost\n101,202,5.0\n202,101,7.0\n"
                   "303,303,0.0\n101,999,1.0\n")
    ids = read_sensor_ids(str(ids_txt))
    out = str(tmp_path / "dist.npy")
    dist = build_distance_matrix(str(csv), ids, out_npy=out)
    assert dist.shape == (3, 3)
    assert dist[0, 1] == 5.0 and dist[1, 0] == 7.0
    assert dist[2, 2] == 0.0
    assert np.isinf(dist[0, 2])       # no entry
    np.testing.assert_array_equal(np.load(out), dist)


def _write_cer_zip(path, meter_ids, codes, rng):
    rows = []
    for mid in meter_ids:
        for code in codes:
            rows.append(f"{mid} {code} {rng.random():.4f}")
    txt_name = os.path.basename(path).replace(".zip", "")
    with ZipFile(path, "w") as zf:
        zf.writestr(txt_name, "\n".join(rows))


def test_build_cer_en_and_load(tmp_path, rng):
    from sgp.data.datasets.build import CER_START, build_cer_en
    from sgp.data.datasets.cer_en import CEREn

    # day 195, slots 1..4 (+ an invalid slot 50 that must be dropped)
    codes = [19501, 19502, 19503, 19504, 19550]
    _write_cer_zip(str(tmp_path / "File1.txt.zip"), [1000, 1001], codes,
                   rng)
    _write_cer_zip(str(tmp_path / "File2.txt.zip"), [1002], codes, rng)
    df = build_cer_en(str(tmp_path))
    assert df.shape == (4, 3)                 # slot 50 dropped, 3 meters
    expect_t0 = CER_START + timedelta(days=195, hours=0.5)
    assert df.index[0].to_pydatetime() == expect_t0
    assert (df.index[1] - df.index[0]) == timedelta(minutes=30)
    assert os.path.exists(tmp_path / "cer_en.h5")

    # the dataset class loads through the built file (h5py layout)
    ds = CEREn(root=str(tmp_path))
    assert ds.target.shape == (4, 3, 1)
    assert ds.mask.all()
    np.testing.assert_allclose(ds.target[..., 0], df.values, atol=1e-6)


def test_cer_en_builds_from_zips_on_demand(tmp_path, rng):
    """CEREn with only the raw zips present triggers the build."""
    from sgp.data.datasets.cer_en import CEREn
    _write_cer_zip(str(tmp_path / "File1.txt.zip"), [7, 8],
                   [10001, 10002], rng)
    ds = CEREn(root=str(tmp_path))
    assert ds.target.shape == (2, 2, 1)
    assert os.path.exists(tmp_path / "cer_en.h5")


def test_metr_la_builds_dist_from_csv(tmp_path, rng):
    from sgp.data.datasets.build import save_frame_h5
    from sgp.data.datasets.metr_la import MetrLA

    ids = [11, 22, 33]
    t = 24
    index = np.datetime64("2012-03-01T00:00") \
        + np.arange(t) * np.timedelta64(5, "m")
    values = rng.random((t, len(ids))).astype(np.float32) + 1.0
    save_frame_h5(str(tmp_path / "metr_la.h5"), values, index, ids)
    (tmp_path / "sensor_ids_la.txt").write_text("11,22,33")
    (tmp_path / "distances_la.csv").write_text(
        "from,to,cost\n11,22,3.0\n22,33,4.0\n")
    ds = MetrLA(root=str(tmp_path))
    assert os.path.exists(tmp_path / "metr_la_dist.npy")
    assert ds.target.shape == (t, 3, 1)
    assert ds.dist[0, 1] == 3.0 and np.isinf(ds.dist[0, 2])
    sim = ds.compute_similarity("distance")
    assert sim.shape == (3, 3) and np.isfinite(sim).all()


def test_pv_us_loads_h5py_layout(tmp_path, rng):
    import h5py

    from sgp.data.datasets.build import save_frame_h5
    from sgp.data.datasets.pv_us import PvUS

    t = 12
    index = np.datetime64("2006-01-01T00:00") \
        + np.arange(t) * np.timedelta64(30, "m")
    for zone, plants in (("east", ["p1", "p2-east", "p3"]),
                         ("west", ["p2", "p4"])):
        path = str(tmp_path / f"{zone}.h5")
        vals = rng.random((t, len(plants))).astype(np.float32)
        save_frame_h5(path, vals, index, plants, key="actual")
        with h5py.File(path, "a") as f:
            grp = f.create_group("metadata")
            grp.create_dataset("plant_id",
                               data=np.asarray(plants, "S"))
            grp.create_dataset("lat", data=rng.random(len(plants)) * 10)
            grp.create_dataset("lon", data=rng.random(len(plants)) * 10)
            grp.create_dataset(
                "state_id",
                data=np.asarray([p.replace("p", "CA-") for p in plants],
                                "S"))
    ds = PvUS(root=str(tmp_path))
    # 'p2-east' (state_id CA-2-east) dropped as a duplicated farm
    assert ds.target.shape == (t, 4, 1)
    sim = ds.compute_similarity("distance")
    assert sim.shape == (4, 4)
