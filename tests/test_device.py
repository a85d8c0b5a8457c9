"""The device peak table, and checks that need the card (marker
``gpu``: they skip on the CPU and run with ``pytest -m gpu``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sgp.obs.device import PEAKS, device_peaks
from sgp.obs.roofline import dense_spmm_bound, iid_step_bound

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def gpu():
    """The first GPU, or a skip: decided when the test runs, never at
    import (every pytest-xdist worker must collect the same tests)."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX found "
                    f"{devices[0].platform!r}")
    return devices[0]


def test_known_device_has_datasheet_peaks():
    p = device_peaks(H100)
    assert p["bf16_flops"] == 989e12 and p["tf32_flops"] == 495e12
    assert p["fp32_flops"] == 67e12 and p["hbm_bytes_s"] == 3.35e12
    assert "data sheet" in p["source"]


@pytest.mark.parametrize("kind", ["AMD Instinct MI300X", "cpu", ""])
def test_unknown_device_raises(kind):
    with pytest.raises(KeyError, match="no peak rates"):
        device_peaks(kind)


def test_roofline_divides_by_the_table():
    p = PEAKS[H100]
    b = dense_spmm_bound(p, n=4096, f=128, precision="highest")
    assert b.flop_seconds == pytest.approx(2.0 * 4096 ** 2 * 128 / 67e12)
    assert b.hbm_seconds == pytest.approx(
        (4096 ** 2 * 4 + 2 * 4096 * 128 * 4) / 3.35e12)
    assert b.limiter == "flops"        # 2NNF f32 FLOPs outweigh 4NN bytes
    step = iid_step_bound(p, batch=4096, row_bytes=1048,
                          flops_per_step=2e10, precision="bf16")
    assert step["t_flop_bound_s"] == pytest.approx(2e10 / 989e12)
    assert step["floor_serial_s"] >= step["floor_overlap_s"]


@pytest.mark.gpu
def test_this_gpu_is_in_the_table(gpu):
    assert device_peaks(gpu.device_kind)["hbm_bytes_s"] > 0


@pytest.mark.gpu
def test_reservoir_f32_on_gpu_matches_cpu(gpu):
    """The reservoir asks for full f32 matmuls: the GPU trajectory
    stays within f32 rounding of the CPU one."""
    from sgp.encode import Reservoir
    res = Reservoir(input_size=3, hidden_size=16, num_layers=4,
                    spectral_radius=0.99, alpha_decay=True, seed=0)
    x = np.random.default_rng(0).uniform(-1, 1, (256, 64, 3)).astype(
        np.float32)
    on_gpu = np.asarray(res(jax.device_put(x, gpu)))
    on_cpu = np.asarray(res(jax.device_put(x, jax.devices("cpu")[0])))
    np.testing.assert_allclose(on_gpu, on_cpu, atol=1e-4)
    assert jnp.asarray(on_gpu).dtype == jnp.float32
