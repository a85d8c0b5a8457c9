"""Experiment scaffolding: flags + TOML config merge + run setup.

Counterpart of ``tsl/utils/experiment.py:11-83`` (TslExperiment) and the
shared head of the five ``experiments/run_*.py`` scripts: argparse flag
surface, a TOML config merged over defaults (its keys must exist as flags,
``parser_utils.py:30-33``), per-run logdir with a config dump, seeding,
dataset/splitter registries.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import tomllib
from typing import Callable, Optional

import numpy as np

from sgp.data.splitters import (AtTimeStepSplitter, Splitter,
                                TemporalSplitter)
from sgp.utils.config import config as global_config
from sgp.utils.logging import logger


def load_config(path: str) -> dict:
    if not os.path.isabs(path) and not os.path.exists(path):
        # resolve relative to the config dir only when the path isn't
        # already valid from the cwd ("configs/traffic/x.toml" and
        # "traffic/x.toml" both work)
        path = os.path.join(global_config["config_dir"], path)
    with open(path, "rb") as fp:
        return tomllib.load(fp)


def get_dataset(name: str, **kwargs):
    from sgp.data.datasets import (CEREn, MetrLA, PemsBay, PvUS,
                                   SyntheticDiffusion)
    if name == "la":
        return MetrLA()
    if name == "bay":
        return PemsBay(mask_zeros=True)
    if name == "pv":
        return PvUS(mask_zeros=True)
    if name == "cer":
        return CEREn()
    if name == "synthetic":
        return SyntheticDiffusion(**kwargs)
    if name == "synthetic_large":
        return SyntheticDiffusion(num_nodes=kwargs.pop("num_nodes", 1024),
                                  num_steps=kwargs.pop("num_steps", 4000),
                                  **kwargs)
    raise ValueError(f"Dataset {name} not available.")


def get_splitter(dataset_name: str, val_len: float = 0.1,
                 test_len: float = 0.2) -> Splitter:
    """Traffic datasets use the paper's datetime boundaries
    (``run_traffic_sgp.py:52-60``); everything else splits temporally."""
    if dataset_name == "la":
        return AtTimeStepSplitter(first_val_ts=(2012, 5, 25, 16, 0),
                                  last_val_ts=(2012, 6, 4, 3, 20),
                                  first_test_ts=(2012, 6, 4, 4, 20))
    if dataset_name == "bay":
        return AtTimeStepSplitter(first_val_ts=(2017, 5, 11, 7, 20),
                                  last_val_ts=(2017, 5, 25, 17, 40),
                                  first_test_ts=(2017, 5, 25, 18, 40))
    return TemporalSplitter(val_len=val_len, test_len=test_len)


class Experiment:
    """Parse flags, merge the TOML config, seed, create the logdir, run."""

    def __init__(self, run_fn: Callable, parser: argparse.ArgumentParser):
        self.run_fn = run_fn
        self.parser = parser

    def parse(self, argv: Optional[list] = None) -> argparse.Namespace:
        """Flags with the ``--config`` file merged in, and the seed
        drawn if negative."""
        args = self.parser.parse_args(argv)
        if getattr(args, "config", None):
            cfg = load_config(args.config)
            # the config beats parser DEFAULTS, but a flag typed on the
            # command line beats the config (`--config sgp_la.toml
            # --dataset-name synthetic` means synthetic)
            tokens = list(sys.argv[1:] if argv is None else argv)
            # detect given flags by RE-PARSING with every default set
            # to SUPPRESS: only values actually typed land in the
            # namespace. Literal option-string matching misses argparse
            # prefix abbreviations (`--epoch` for `--epochs`), which
            # would let the config silently override a typed flag.
            saved = [(a, a.default) for a in self.parser._actions]
            saved_defaults = dict(self.parser._defaults)
            try:
                for a in self.parser._actions:
                    a.default = argparse.SUPPRESS
                self.parser._defaults.clear()
                shadow, _ = self.parser.parse_known_args(tokens)
                given = set(vars(shadow))
            finally:
                for a, d in saved:
                    a.default = d
                self.parser._defaults.update(saved_defaults)
            for key, value in cfg.items():
                if not hasattr(args, key):
                    raise ValueError(
                        f"config key {key!r} is not a known flag")
                if key not in given:
                    setattr(args, key, value)
        if getattr(args, "seed", -1) < 0:
            args.seed = int(np.random.randint(1e9))
        return args

    def run(self, argv: Optional[list] = None):
        args = self.parse(argv)
        np.random.seed(args.seed)
        logger.info(f"SEED: {args.seed}")

        if getattr(args, "num_processes", None):
            # multi-host init must precede any device/mesh query
            from sgp.parallel import init_distributed
            n = init_distributed(
                coordinator_address=args.coordinator_address,
                num_processes=args.num_processes,
                process_id=args.process_id)
            logger.info(f"distributed: {n} process(es)")

        exp_name = (datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
                    + f"_{args.seed}")
        logdir = os.path.join(global_config["logs_dir"],
                              getattr(args, "dataset_name", "run"),
                              getattr(args, "model_name", "model"),
                              exp_name)
        os.makedirs(logdir, exist_ok=True)
        with open(os.path.join(logdir, "exp_config.json"), "w") as fp:
            json.dump(vars(args), fp, indent=2, sort_keys=True)
        args.logdir = logdir
        result = self.run_fn(args)
        if result is not None:
            with open(os.path.join(logdir, "results.json"), "w") as fp:
                json.dump(result, fp, indent=2, default=float)
            logger.info(f"results: {json.dumps(result, default=float)}")
        return result


def add_common_args(parser: argparse.ArgumentParser):
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--seed", type=int, default=-1)
    parser.add_argument("--dataset-name", type=str, default="synthetic")
    parser.add_argument("--window", type=int, default=1)
    parser.add_argument("--horizon", type=int, default=12)
    parser.add_argument("--horizon-lag", type=int, default=1)
    parser.add_argument("--stride", type=int, default=1)
    parser.add_argument("--val-len", type=float, default=0.1)
    parser.add_argument("--test-len", type=float, default=0.2)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--batch-inference", type=int, default=None)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--use-lr-schedule", type=str2bool, default=True)
    parser.add_argument("--lr-milestones", type=int, nargs="*",
                        default=[25, 50, 100])
    parser.add_argument("--lr-gamma", type=float, default=0.25)
    parser.add_argument("--l2-reg", type=float, default=0.0)
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--patience", type=int, default=50)
    parser.add_argument("--batches-epoch", type=int, default=-1)
    parser.add_argument("--grad-clip-val", type=float, default=5.0)
    parser.add_argument("--scale-target", type=str2bool, default=False)
    parser.add_argument("--workers", type=int, default=1)
    parser.add_argument("--adj-knn", type=int, default=None)
    parser.add_argument("--adj-threshold", type=float, default=0.1)
    parser.add_argument("--synthetic-nodes", type=int, default=64)
    parser.add_argument("--synthetic-steps", type=int, default=2000)
    # multi-host (pod-slice) execution: a config change, not a code
    # change (SURVEY.md §5.8). Launch one process per host with the same
    # coordinator and its process id; meshes then span all hosts.
    parser.add_argument("--coordinator-address", type=str, default=None)
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    return parser


def dp_mesh(args):
    """``--data-sharding batch`` -> a data-parallel mesh over all local
    devices for the loader-based Predictor (batches shard along the
    sample dim, grads psum via XLA SPMD); ``None`` otherwise."""
    if getattr(args, "data_sharding", "none") != "batch":
        return None
    import jax

    from sgp.parallel import make_mesh
    n = len(jax.devices())
    logger.info(f"data-sharding=batch over {n} devices (Predictor DP)")
    return make_mesh(n, 1)


def dataset_kwargs(args) -> dict:
    if getattr(args, "dataset_name", "").startswith("synthetic"):
        return {"num_nodes": args.synthetic_nodes,
                "num_steps": args.synthetic_steps}
    return {}


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("yes", "true", "t", "1")


def filter_kwargs(cls_or_fn, args: dict) -> dict:
    """Route flags to constructors by signature
    (``tsl/utils/parser_utils.py:69-82``)."""
    import inspect
    sig = inspect.signature(cls_or_fn)
    return {k: v for k, v in args.items() if k in sig.parameters}
