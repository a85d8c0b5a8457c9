"""Failure-detecting supervisor (SURVEY §5.3 elastic recovery): crashes
and hangs are detected, the run restarts with --resume, and the
recovered run reproduces the uninterrupted one exactly."""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from sgp.exp.supervise import _with_resume, supervise

pytestmark = pytest.mark.slow

RUNNER_WORKER = r"""
import os, sys, json
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
from sgp.exp.common import Experiment
from sgp.exp.run_largescale_sgp import (
    configure_parser_largescale, run_experiment)
res = Experiment(run_experiment,
                 configure_parser_largescale()).run(sys.argv[1:])
print("RESULT " + json.dumps(
    {k: v for k, v in res.items() if isinstance(v, (int, float))}))
"""

BASE = ["--dataset-name", "synthetic", "--synthetic-nodes", "12",
        "--synthetic-steps", "160", "--epochs", "4",
        "--batches-epoch", "2", "--reservoir-size", "4",
        "--mlp-size", "8", "--hidden-size", "16", "--batch-size", "8",
        "--seed", "0", "--patience", "5"]


def test_with_resume_dedups():
    assert _with_resume(["a", "--x", "1"]) == \
        ["a", "--x", "1", "--resume", "true"]
    assert _with_resume(["a", "--resume", "false", "--x", "1"]) == \
        ["a", "--x", "1", "--resume", "true"]
    assert _with_resume(["a", "--resume", "--x"]) == \
        ["a", "--x", "--resume", "true"]


def test_supervisor_restarts_crash_until_success(tmp_path):
    """A child that dies until relaunched with --resume: the supervisor
    appends the flag and reports eventual success."""
    script = tmp_path / "flaky.py"
    script.write_text(
        "import sys\n"
        "sys.exit(0 if '--resume' in sys.argv else 7)\n")
    rc = supervise([sys.executable, str(script)], max_restarts=2,
                   hang_timeout=0, restart_delay=0,
                   require_checkpoint=False)
    assert rc == 0


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    script = tmp_path / "dead.py"
    script.write_text("import sys\nsys.exit(3)\n")
    rc = supervise([sys.executable, str(script)], max_restarts=1,
                   hang_timeout=0, restart_delay=0,
                   require_checkpoint=False)
    assert rc == 3


def test_supervisor_requires_checkpoint_path(tmp_path):
    """Without --checkpoint-path a --resume restart would silently start
    from epoch 0 (fresh timestamped logdir) — refuse up front."""
    import pytest
    with pytest.raises(ValueError, match="checkpoint-path"):
        supervise([sys.executable, "-c", "pass"], max_restarts=1,
                  hang_timeout=0, restart_delay=0)


def test_supervisor_detects_hang(tmp_path):
    """No output past --hang-timeout -> the child's process group is
    killed (by pgid, never by pattern) and the failure surfaces."""
    script = tmp_path / "hang.py"
    script.write_text("import time\nprint('up', flush=True)\n"
                      "time.sleep(300)\n")
    t0 = time.time()
    rc = supervise([sys.executable, str(script)], max_restarts=0,
                   hang_timeout=1.0, restart_delay=0,
                   require_checkpoint=False)
    assert rc != 0
    assert time.time() - t0 < 60


def test_supervisor_recovers_runner_crash(tmp_path, capsys):
    """End to end: fault injection kills the real large-scale runner at
    epoch 2; the supervisor restarts it with --resume and the recovered
    run's test MAE matches an uninterrupted run exactly."""
    from sgp.exp.run_largescale_sgp import (
        configure_parser_largescale as configure_parser, run_experiment)
    from sgp.exp.common import Experiment

    full = Experiment(run_experiment, configure_parser()).run(list(BASE))

    worker = tmp_path / "worker.py"
    worker.write_text(RUNNER_WORKER)
    ck = str(tmp_path / "state.ckpt")
    marker = tmp_path / "fault_fired"
    cmd = [sys.executable, str(worker)] + BASE + [
        "--checkpoint-every", "1", "--checkpoint-path", ck]
    repo_root = os.path.dirname(os.path.dirname(__file__))
    old_pp = os.environ.get("PYTHONPATH")
    os.environ["SGP_FAULT"] = f"epoch:2,marker:{marker}"
    # append, never overwrite: the caller's PYTHONPATH must stay importable
    os.environ["PYTHONPATH"] = repo_root + (
        os.pathsep + old_pp if old_pp else "")
    try:
        rc = supervise(cmd, max_restarts=2, hang_timeout=0,
                       restart_delay=0)
    finally:
        del os.environ["SGP_FAULT"]
        if old_pp is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = old_pp
    assert rc == 0
    assert marker.exists()          # the fault really fired
    out = capsys.readouterr().out
    results = [json.loads(l.split("RESULT ", 1)[1])
               for l in out.splitlines() if l.startswith("RESULT ")]
    assert results, out
    np.testing.assert_allclose(results[-1]["test_mae"],
                               full["test_mae"], rtol=1e-6)
