"""The port stands alone: it imports neither jax nor the JAX package, runs on
the card unless asked for the CPU, and takes the JAX package's state."""

import os
import pkgutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import triangulation_in_deformable_scenes_torch as port
from test_torch_problems import deforming_problem, jax_problem
from triangulation_in_deformable_scenes_torch import convert
from triangulation_in_deformable_scenes_torch.harness import sweep_config
from triangulation_in_deformable_scenes_torch.pipeline.simulation import SimulationPipeline

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    names = [port.__name__]
    for info in pkgutil.walk_packages(port.__path__, prefix=port.__name__ + "."):
        names.append(info.name)
    return names


def test_port_and_chip_smoke_import_no_jax():
    """In a fresh interpreter, import every module of the port,
    chip_smoke.py and chip_diagnostics.py: neither jax nor the JAX package
    may be loaded."""
    mods = _port_modules()
    assert len(mods) > 20
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke, chip_diagnostics\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('triangulation_in_deformable_scenes_tpu'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_pipeline_without_device_raises_when_no_card():
    """Entry points run on cuda by default and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SimulationPipeline(sweep_config.sweep_config())
    SimulationPipeline(sweep_config.sweep_config(), device="cpu")


def test_convert_round_trips_jax_state():
    """PairData/PairState/Hyper of the JAX package cross as numpy arrays and
    come back unchanged (f32, int64 indices, bool masks)."""
    jd, js, jh = jax_problem(deforming_problem(n_side=4))
    np_data = {k: np.asarray(v) for k, v in jd._asdict().items()}
    td = convert.pair_data_from_numpy(np_data, device="cpu")
    ts = convert.pair_state_from_numpy(js, device="cpu")
    th = convert.hyper_from_numpy(jh, device="cpu")
    for name, val in jd._asdict().items():
        got = getattr(td, name)
        np.testing.assert_array_equal(got.numpy(), np.asarray(val).astype(got.numpy().dtype), name)
    assert td.nbr.dtype == torch.int64 and td.valid.dtype == torch.bool
    for name, val in js._asdict().items():
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(val, np.float32), name)
    for name, val in jh._asdict().items():
        np.testing.assert_array_equal(getattr(th, name).numpy(), np.asarray(val, np.float32), name)
    back = {k: jnp.asarray(v.numpy()) for k, v in td._asdict().items()}
    np.testing.assert_array_equal(np.asarray(back["Ri"]), np.asarray(jd.Ri))


def test_orb_pattern_is_the_ports_own_byte_identical_copy():
    """The port loads its own orb_pattern.npy, byte for byte the JAX
    package's table (descriptor compatibility)."""
    from triangulation_in_deformable_scenes_torch.ops import features

    mine = os.path.join(REPO, "triangulation_in_deformable_scenes_torch", "ops", "orb_pattern.npy")
    theirs = os.path.join(REPO, "triangulation_in_deformable_scenes_tpu", "ops", "orb_pattern.npy")
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(features._PATTERN, np.load(mine))


def test_sequence_pipeline_without_device_raises_when_no_card():
    from triangulation_in_deformable_scenes_torch.harness import step_scene
    from triangulation_in_deformable_scenes_torch.pipeline.sequence import SequencePipeline

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = step_scene.scene_config(step_scene.SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SequencePipeline(cfg)
    SequencePipeline(cfg, device="cpu")
