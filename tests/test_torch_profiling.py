"""The port's profiling hooks (utils/profiling.py) on the CPU: ``trace``
exports a Chrome trace that lists every ``annotate`` region around Ant
steps, and ``StepTimer`` is the JAX package's (same summary keys)."""
import json
import os

import pytest
import torch

from isaacgymenvs_ma_tpu.utils import profiling as jprofiling
from isaacgymenvs_ma_tpu_torch.tasks.ant import TASK_CFG, Ant
from isaacgymenvs_ma_tpu_torch.utils import profiling
from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge

torch.set_num_threads(1)   # small CPU ops: one thread a test worker


def test_trace_lists_the_annotated_regions(tmp_path):
    task = Ant(deep_merge(TASK_CFG, {"env": {"numEnvs": 8}}), device="cpu")
    st = task.initial_state()
    with profiling.trace(str(tmp_path / "trace")) as prof:
        for i in range(3):
            with profiling.annotate(f"ant_step_{i}"):
                with profiling.annotate("policy"):
                    a = torch.tanh(torch.randn(8, 8))
                st, _ = task.step(st, a)
    path = str(tmp_path / "trace" / profiling.TRACE_FILE)
    assert prof.trace_path == path and os.path.exists(path)
    events = json.load(open(path))["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"ant_step_0", "ant_step_1", "ant_step_2", "policy"} <= names
    # the step's own work is in it, under the regions
    assert sum(1 for e in events if e.get("name") == "policy") == 3
    assert any(n and n.startswith("aten::") for n in names)


@pytest.mark.parametrize("phases", [("step",), ("play", "update", "play")])
def test_step_timer_matches_jax(phases):
    t, j = profiling.StepTimer(), jprofiling.StepTimer()
    for timer in (t, j):
        for p in phases:
            with timer.phase(p):
                pass
    assert sorted(t.summary()) == sorted(j.summary())
    assert all(v >= 0.0 for v in t.summary().values())
    assert dict(t.counts) == dict(j.counts)
