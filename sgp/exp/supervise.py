"""Failure-detecting training supervisor: automatic crash/hang recovery.

The elastic-recovery half of SURVEY §5.3 (the reference has neither;
checkpoints there are Lightning best-model files only): the restartable
runners already make `--resume` reproduce the exact uninterrupted run
from one atomic state file — this wrapper closes the loop by DETECTING
the failure and restarting automatically, so a multi-hour run survives
OOM kills, crashes and hangs without a human in the loop.

Usage::

    python -m sgp.exp.supervise --max-restarts 5 --hang-timeout 1800 \
        -- python -m sgp.exp.run_largescale_sgp \
           --config largescale_100nn/sgp_pv.toml \
           --checkpoint-every 10 --checkpoint-path /path/state.ckpt

Behavior:
- The command after ``--`` runs as a child in its OWN process group;
  on failure the supervisor kills exactly that group by pgid (never by
  pattern — a pattern can match unrelated processes).
- Crash detection: any nonzero exit (OOM kill, fault, assert).
- Hang detection: no output for ``--hang-timeout`` seconds (a stalled
  device or collective prints nothing). Set it generously above the
  slowest first compile of the run.
- Every restart appends ``--resume true`` (and dedups an existing
  flag), so the child continues the exact run from its checkpoint.
- ``--restart-delay`` waits before relaunching (gives the killed
  program's device memory time to be released).
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

from sgp.utils.logging import logger


def _with_resume(cmd):
    """Return ``cmd`` with ``--resume true`` set (replacing any existing
    ``--resume`` value)."""
    out, i = [], 0
    while i < len(cmd):
        if cmd[i] == "--resume":
            i += 2 if i + 1 < len(cmd) and not \
                cmd[i + 1].startswith("--") else 1
            continue
        out.append(cmd[i])
        i += 1
    return out + ["--resume", "true"]


def _kill_group(proc):
    """Terminate the child's process group by pgid, escalating to
    SIGKILL. Never kills by name/pattern. Works after the leader has
    already been reaped (``start_new_session=True`` makes pgid ==
    ``proc.pid``), so crash cleanup can sweep surviving group members
    — an orphan still holding the device would starve every restart."""
    pgid = proc.pid   # session leader: pgid == pid, valid post-reap
    for sig, wait_s in ((signal.SIGTERM, 10.0), (signal.SIGKILL, 30.0)):
        try:
            os.killpg(pgid, sig)
        except ProcessLookupError:
            return   # no group members left
        deadline = time.time() + wait_s
        while time.time() < deadline:
            try:
                os.killpg(pgid, 0)   # probe: any member still alive?
            except ProcessLookupError:
                return
            time.sleep(0.2)


def supervise(cmd, max_restarts: int = 3, hang_timeout: float = 1800.0,
              restart_delay: float = 30.0,
              require_checkpoint: bool = True) -> int:
    """Run ``cmd`` under crash/hang supervision; returns the final exit
    code (0 on eventual success)."""
    if require_checkpoint and "--checkpoint-path" not in cmd:
        # without an explicit path the runner checkpoints into a fresh
        # timestamped logdir per invocation, so every --resume restart
        # would silently start from epoch 0 and replay the same crash
        raise ValueError(
            "supervise: the command has no --checkpoint-path; restarts "
            "could not resume (each invocation writes its checkpoint "
            "into a NEW timestamped logdir). Add --checkpoint-every/"
            "--checkpoint-path to the command, or pass "
            "--allow-no-checkpoint to supervise restart-from-scratch.")
    attempt = 0
    while True:
        argv = cmd if attempt == 0 else _with_resume(cmd)
        logger.info(f"supervise[{attempt}]: {' '.join(argv)}")
        proc = subprocess.Popen(
            argv, start_new_session=True,   # own pgid -> exact cleanup
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        os.set_blocking(proc.stdout.fileno(), False)

        def _drain():
            try:
                chunk = proc.stdout.read()   # non-blocking: None if empty
            except (OSError, ValueError):
                chunk = None
            if chunk:
                sys.stdout.write(chunk.decode(errors="replace"))
                sys.stdout.flush()
                return True
            return False

        last_out = time.time()
        hung = False
        while True:
            if _drain():
                last_out = time.time()
            if proc.poll() is not None:
                _drain()
                break
            if hang_timeout and time.time() - last_out > hang_timeout:
                logger.warning(
                    f"supervise: no output for {hang_timeout:.0f}s — "
                    f"killing pgid {proc.pid} as hung")
                _kill_group(proc)
                hung = True
                break
            time.sleep(0.25)
        rc = proc.wait()
        if rc == 0 and not hung:
            logger.info(f"supervise: success after {attempt} restart(s)")
            return 0
        if not hung:
            # crash path: the leader died but helpers it spawned in its
            # session may survive — sweep the group before restarting
            # (an orphan still holding the device starves the restart)
            _kill_group(proc)
        attempt += 1
        if attempt > max_restarts:
            logger.error(
                f"supervise: giving up after {max_restarts} restarts "
                f"(last rc={rc}{', hung' if hung else ''})")
            return rc if rc != 0 else 1
        logger.warning(f"supervise: child {'hung' if hung else f'died rc={rc}'}"
                       f"; restarting with --resume in {restart_delay:.0f}s")
        time.sleep(restart_delay)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Run a training command with automatic crash/hang "
                    "recovery (requires the runner's --checkpoint-every/"
                    "--checkpoint-path for exact resume).")
    parser.add_argument("--max-restarts", type=int, default=3)
    parser.add_argument("--hang-timeout", type=float, default=1800.0,
                        help="seconds without child output before the "
                             "run is declared hung (0 disables)")
    parser.add_argument("--restart-delay", type=float, default=30.0)
    parser.add_argument("--allow-no-checkpoint", action="store_true",
                        help="supervise a command without "
                             "--checkpoint-path (restarts re-run from "
                             "scratch instead of resuming)")
    parser.add_argument("cmd", nargs=argparse.REMAINDER,
                        help="-- followed by the training command")
    args = parser.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        parser.error("no command given (append: -- python -m ...)")
    try:
        return supervise(cmd, max_restarts=args.max_restarts,
                         hang_timeout=args.hang_timeout,
                         restart_delay=args.restart_delay,
                         require_checkpoint=not args.allow_no_checkpoint)
    except ValueError as e:
        parser.error(str(e))


if __name__ == "__main__":
    sys.exit(main())
