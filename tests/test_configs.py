"""Config parity guard: every key in all 31 ported configs (TOML) must
map to a known flag of its runner (the reference enforces the same —
``parser_utils.py:30-33``), and the config merge must apply."""
import glob
import json
import os
import tomllib

import pytest

from sgp.exp.common import load_config
from sgp.utils.config import config as global_config

CONFIG_DIR = global_config["config_dir"]


def _parser_for(path: str):
    from sgp.exp.run_closed_form import configure_parser as p_cf
    from sgp.exp.run_traffic_baselines import configure_parser as p_bl
    from sgp.exp.run_traffic_sgp import configure_parser as p_sgp
    name = os.path.basename(path)
    if name.startswith("gesn"):
        return p_cf()
    if name.startswith("sgp"):
        parser = p_sgp()
        # flags added by the largescale __main__ entry
        from sgp.exp.common import str2bool
        parser.add_argument("--iid-stratified", type=str2bool,
                            default=False)
        parser.add_argument("--times-per-batch", type=int, default=32)
        return parser
    return p_bl()


ALL_CONFIGS = sorted(glob.glob(os.path.join(CONFIG_DIR, "*", "*.toml")))
CONFIG_IDS = [os.path.relpath(p, CONFIG_DIR) for p in ALL_CONFIGS]


def test_all_31_configs_present():
    assert len(ALL_CONFIGS) == 31


@pytest.mark.parametrize("path", ALL_CONFIGS, ids=CONFIG_IDS)
def test_config_keys_map_to_flags(path):
    with open(path, "rb") as fp:
        cfg = tomllib.load(fp)
    parser = _parser_for(path)
    defaults = vars(parser.parse_args([]))
    unknown = [k for k in cfg if k not in defaults]
    assert not unknown, f"{path}: unknown config keys {unknown}"


@pytest.mark.parametrize("path", ALL_CONFIGS, ids=CONFIG_IDS)
def test_config_round_trip(path, tmp_path, monkeypatch):
    """TOML -> runner flags -> the run's JSON record keeps every value
    and its type."""
    from sgp.exp.common import Experiment
    monkeypatch.setitem(global_config, "logs_dir", str(tmp_path))
    cfg = load_config(os.path.relpath(path, CONFIG_DIR))
    captured = {}

    def run_fn(args):
        captured.update(vars(args))

    Experiment(run_fn, _parser_for(path)).run(["--config", path])
    (record,) = glob.glob(str(tmp_path / "**" / "exp_config.json"),
                          recursive=True)
    with open(record) as fp:
        stored = json.load(fp)
    for k, v in cfg.items():
        assert captured[k] == v and type(captured[k]) is type(v), k
        assert stored[k] == v and type(stored[k]) is type(v), k


def test_config_merge_applies():
    cfg = load_config("traffic/sgp_la.toml")
    assert cfg["reservoir_size"] == 64
    assert cfg["lr_milestones"] == [40, 80, 120]
    parser = _parser_for(os.path.join(CONFIG_DIR, "traffic/sgp_la.toml"))
    from sgp.exp.common import Experiment

    captured = {}

    def run_fn(args):
        captured.update(vars(args))
        return None

    Experiment(run_fn, parser).run(["--config", "traffic/sgp_la.toml",
                                    "--seed", "1"])
    assert captured["reservoir_size"] == 64
    assert captured["hidden_size"] == 960
    assert captured["bidirectional"] is True


def test_hyperopt_through_runner():
    """The search harness drives a real runner config dict."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from sgp.exp.hyperopt import run_search
    from sgp.exp.run_traffic_sgp import (configure_parser,
                                         run_experiment)
    from sgp.exp.common import Experiment

    base = ["--dataset-name", "synthetic", "--synthetic-nodes", "16",
            "--synthetic-steps", "200", "--epochs", "1",
            "--batches-epoch", "2", "--reservoir-size", "4",
            "--mlp-size", "8", "--batch-size", "8", "--seed", "3",
            "--fused", "false"]

    def run_fn(cfg):
        argv = base + [f"--hidden-size", str(cfg["hidden_size"])]
        return Experiment(run_experiment, configure_parser()).run(argv)

    out = run_search(run_fn, {}, {"hidden_size": [8, 16]}, mode="grid",
                     monitor="test_mae")
    assert out["best_config"]["hidden_size"] in (8, 16)
    assert len(out["trials"]) == 2


def test_hyperopt_parallel_workers():
    """n_workers>1 runs all trials and picks the same best as serial."""
    from sgp.exp.hyperopt import run_search

    def run_fn(cfg):
        return {"test_mae": abs(cfg["h"] - 12)}

    space = {"h": [8, 12, 16, 20]}
    serial = run_search(run_fn, {}, space, mode="grid",
                        monitor="test_mae")
    par = run_search(run_fn, {}, space, mode="grid",
                     monitor="test_mae", n_workers=4)
    assert par["best_config"] == serial["best_config"] == {"h": 12}
    assert len(par["trials"]) == 4
    assert [t["config"] for t in par["trials"]] == \
        [t["config"] for t in serial["trials"]]
