"""The port never imports jax.

Runs in a subprocess because tests/conftest.py imports jax into this one:
import every module of isaacgymenvs_ma_tpu_torch, build Ant at 8 envs,
step it, then check that no jax module was loaded.
"""
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    import torch
    import isaacgymenvs_ma_tpu_torch as port
    mods = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                  port.__name__ + ".")]
    for name in mods:
        importlib.import_module(name)
    from isaacgymenvs_ma_tpu_torch.tasks.ant import Ant, TASK_CFG
    from isaacgymenvs_ma_tpu.utils.config import deep_merge
    task = Ant(deep_merge(TASK_CFG, {"env": {"numEnvs": 8}}))
    state = task.initial_state()
    for _ in range(2):
        state, res = task.step(state, torch.tanh(torch.randn(8, 8)))
    assert torch.isfinite(res.obs).all() and res.obs.shape == (8, 60)
    loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
    print("MODULES", len(mods), "JAX", loaded)
    assert not loaded, loaded
""")


def test_port_imports_and_steps_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "JAX []" in proc.stdout
    # every module of the package was imported (scaffold, ops, physics,
    # tasks, convert)
    n_mods = int(proc.stdout.split("MODULES")[1].split()[0])
    assert n_mods >= 12, proc.stdout
