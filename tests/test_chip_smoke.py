"""chip_smoke.py's phases at tiny size on the CPU, its refusal to run
without a GPU, and the import / compile-cache contracts of the main
path."""
import json
import os
import subprocess
import sys

import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the PV-US config at toy scale: same flags and paths, small widths
TINY = ["--config", "largescale_100nn/sgp_pv.toml",
        "--dataset-name", "synthetic_large", "--synthetic-nodes", "32",
        "--synthetic-steps", "300", "--seed", "0", "--adj-knn", "6",
        "--hidden-size", "64", "--mlp-size", "32", "--batch-size", "128",
        "--reservoir-layers", "2"]


def _phase_lines(out: str) -> dict:
    lines = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
    return {l["phase"]: l for l in lines if "phase" in l}


def test_encoder_iid_step_serving_phases(capsys):
    args = chip_smoke.parse_args(TINY, synthetic_steps=96)
    ds, split, encoder = chip_smoke.encoder_phase(args)
    chip_smoke.iid_step_phase(args, ds, split, encoder)
    chip_smoke.serving_phase(args, ds, n_live=4)
    got = _phase_lines(capsys.readouterr().out)
    assert got["encoder"]["shape"] == [96, 32, encoder.output_size]
    assert got["encoder"]["max_rel"] <= got["encoder"]["tol_rel"]
    assert got["iid_step"]["batch"] == 128
    assert got["iid_step"]["mse_grad_max_rel"] <= chip_smoke.TOL_GRAD
    assert got["serving"]["steps"] == 4
    assert got["serving"]["warm_up_steps"] == 92
    assert got["serving"]["max_rel"] <= chip_smoke.TOL_SERVING


def test_reservoir_modes_phase(capsys):
    args = chip_smoke.parse_args(TINY, synthetic_steps=40)
    chip_smoke.reservoir_modes_phase(args, input_size=3, reps=1)
    got = _phase_lines(capsys.readouterr().out)["reservoir_modes"]
    assert got["steps"] == 40 and got["layers"] == 2
    assert got["faster"] in ("sequential", "wavefront")
    assert got["last64_max_rel"] <= chip_smoke.TOL_MODES


@pytest.mark.parametrize("bytes_limit,path", [(2 ** 34, "packed"),
                                              (10 ** 6, "stratified")])
def test_trainer_phase_picks_path_by_memory(capsys, tmp_path, monkeypatch,
                                            bytes_limit, path):
    from sgp.utils.config import config
    monkeypatch.setitem(config, "logs_dir", str(tmp_path))
    chip_smoke.trainer_phase(TINY, epochs=3, batches_epoch=4,
                             bytes_limit=bytes_limit)
    got = _phase_lines(capsys.readouterr().out)["trainer"]
    assert got["path"] == path
    assert len(got["epoch_losses"]) == 3
    assert got["epoch_losses"][-1] < got["epoch_losses"][0]
    assert got["compile_s"] > 0 and got["steady_batch_s"] > 0
    assert got["train_step_memory"]["argument_size_in_bytes"] > 0


def test_sharded_phase_on_four_devices(capsys):
    chip_smoke.sharded_phase(TINY, steps=160, epochs=3, batches_epoch=4)
    got = _phase_lines(capsys.readouterr().out)
    enc = got["sharded_encode"]
    assert enc["shards"] == [[160, 8, enc["shape"][2]]]
    assert enc["max_rel"] <= chip_smoke.TOL_SHARDED
    tr = got["sharded_train_eval"]
    assert tr["eval_max_rel"] <= chip_smoke.TOL_EVAL
    assert {tuple(s)[:2] for s in tr["packed_shards"]} == {(160, 8)}


@pytest.mark.parametrize("argv", [[], ["--chips", "4"]])
def test_main_refuses_without_gpu(capsys, argv):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main(argv)
    assert e.value.code not in (0, None)
    assert "no GPU" in str(e.value.code)
    assert '"ok"' not in capsys.readouterr().out


def _fresh(code: str, env_update: dict, drop=()) -> str:
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_update)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout.strip()


def test_main_path_imports_no_flax_yaml_pandas_torch():
    out = _fresh(
        "import sys, sgp.exp.run_largescale_sgp, chip_smoke; "
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'flax', 'yaml', 'pandas', 'torch'}))",
        {"JAX_PLATFORMS": "cpu"})
    assert out == "[]"


@pytest.mark.parametrize("case", ["env_set", "unset", "cpu_only"])
def test_compile_cache_placement(case, tmp_path):
    code = "import jax, sgp; print(jax.config.jax_compilation_cache_dir)"
    drop = ("JAX_COMPILATION_CACHE_DIR", "JAX_PLATFORMS")
    if case == "env_set":
        out = _fresh(code, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)},
                     drop=("JAX_PLATFORMS",))
        assert out == str(tmp_path)
    elif case == "unset":
        out = _fresh(code, {}, drop=drop)
        assert out == os.path.join(REPO, ".jax_cache")
    else:
        out = _fresh(code, {"JAX_PLATFORMS": "cpu"}, drop=drop)
        assert out in ("None", "")
