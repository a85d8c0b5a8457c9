"""Hyperparameter search (sequential or worker-parallel).

Counterpart of the reference's test_tube multi-trial harness
(``tsl/utils/experiment.py:54-83`` + ``opt_list`` tunables): sample
trial configurations from per-flag option lists (grid or random), run
them (``n_workers > 1`` runs trials concurrently, the analog of
test_tube's worker pool — use workers only for CPU runs; one process
per accelerator), swallow per-trial runtime errors
(``:63-73``), and report the best trial by a monitored metric.

For lr/seed spaces on the fused IID path, prefer the ON-DEVICE vmapped
search (``sgp/train/multi_trial.py``; ``--search-lr/--search-seeds``
on ``run_largescale_sgp``): all trials train in one XLA program on
shared batches — no per-trial process or compile.
"""
from __future__ import annotations

import itertools
import json
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from sgp.utils.logging import logger


def grid_trials(space: Dict[str, Sequence]) -> List[Dict]:
    keys = list(space)
    return [dict(zip(keys, vals))
            for vals in itertools.product(*(space[k] for k in keys))]


def random_trials(space: Dict[str, Sequence], n_trials: int,
                  seed: int = 0) -> List[Dict]:
    rng = np.random.default_rng(seed)
    return [{k: v[rng.integers(len(v))] for k, v in space.items()}
            for _ in range(n_trials)]


def run_search(run_fn: Callable[[Dict], Dict],
               base_config: Dict,
               space: Dict[str, Sequence],
               mode: str = "random",
               n_trials: int = 10,
               monitor: str = "test_mae",
               minimize: bool = True,
               seed: int = 0,
               n_workers: int = 1,
               out_path: Optional[str] = None) -> Dict:
    """Run trials of ``run_fn(config) -> metrics dict``; returns
    ``{"best_config", "best_metrics", "trials"}``. ``n_workers > 1``
    dispatches trials to a thread pool (XLA releases the GIL during
    compile/execute, so CPU trials genuinely overlap)."""
    trials = (grid_trials(space) if mode == "grid"
              else random_trials(space, n_trials, seed))
    sign = 1.0 if minimize else -1.0

    def one_trial(i_overrides):
        i, overrides = i_overrides
        cfg = {**base_config, **overrides}
        logger.info(f"trial {i + 1}/{len(trials)}: {overrides}")
        try:
            return {"config": overrides, "metrics": run_fn(cfg)}
        except RuntimeError as e:  # reference swallows per-trial errors
            logger.warning(f"trial {i} failed: {e}")
            return {"config": overrides, "error": str(e)}

    if n_workers > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=n_workers) as pool:
            results = list(pool.map(one_trial, enumerate(trials)))
    else:
        results = [one_trial(item) for item in enumerate(trials)]

    best = None
    for rec in results:
        if "metrics" not in rec:
            continue
        score = sign * rec["metrics"][monitor]
        if best is None or score < best[0]:
            best = (score, rec["config"], rec["metrics"])
    out = {"best_config": best[1] if best else None,
           "best_metrics": best[2] if best else None,
           "trials": results}
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as fp:
            json.dump(out, fp, indent=2, default=float)
    return out
