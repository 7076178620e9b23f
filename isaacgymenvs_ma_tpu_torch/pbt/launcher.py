"""PBT / sweep launcher (a copy of isaacgymenvs_ma_tpu/pbt/launcher.py whose
workers run the port's train module; reference pbt/launcher/{run,run_processes,
run_description}.py).

Spawns a population of ``python -m isaacgymenvs_ma_tpu_torch.train``
workers with OS-level parallelism; the
decentralized PBT protocol itself is file-based (pbt.py) so the launcher
only has to get the processes up with the right ``pbt.*`` overrides.  The
reference ships processes/slurm/ngc backends; here the processes backend is
native and slurm reduces to emitting an sbatch array script (no cluster in
the loop at build time).

Usage (population convenience, replaces a reference run-description module):

    python -m isaacgymenvs_ma_tpu_torch.pbt.launcher --pbt task=Ant \
        --num-policies 4 --workspace /tmp/pbt_ws --max-parallel 2 \
        num_envs=512 train.params.config.max_epochs=50

or with an importable run description (reference --run grammar):

    python -m isaacgymenvs_ma_tpu_torch.pbt.launcher --run my_module:RUN_DESCRIPTION
"""
from __future__ import annotations

import argparse
import importlib
import itertools
import os
import subprocess
import sys
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .pbt import TRAIN_MODULE


class ParamGenerator:
    def generate_params(self) -> Iterable[Dict]:
        raise NotImplementedError


class ParamList(ParamGenerator):
    """Explicit list of parameter dicts (run_description.py:18-32)."""

    def __init__(self, combinations: Sequence[Dict]):
        self.combinations = list(combinations)

    def generate_params(self):
        yield from self.combinations


class ParamGrid(ParamGenerator):
    """Cartesian grid over (name, values) tuples (run_description.py:35-75)."""

    def __init__(self, grid_tuples: Sequence[Tuple[str, Sequence]]):
        self.names = [n for n, _ in grid_tuples]
        self.values = [list(v) for _, v in grid_tuples]

    def generate_params(self):
        for combo in itertools.product(*self.values):
            yield dict(zip(self.names, combo))


class Experiment:
    def __init__(self, name: str, cmd: str,
                 param_generator: Optional[ParamGenerator] = None,
                 env_vars: Optional[Dict[str, str]] = None):
        self.name = name
        self.cmd = cmd
        self.param_generator = param_generator or ParamList([{}])
        self.env_vars = env_vars or {}

    def generate_experiments(self):
        for i, params in enumerate(self.param_generator.generate_params()):
            args = " ".join(f"{k}={v}" for k, v in params.items())
            name = f"{self.name}_{i:02d}" if args else self.name
            yield f"{self.cmd} {args}".strip(), name, dict(self.env_vars)


class RunDescription:
    def __init__(self, run_name: str, experiments: Sequence[Experiment]):
        self.run_name = run_name
        self.experiments = list(experiments)

    def generate_experiments(self):
        for e in self.experiments:
            yield from e.generate_experiments()


def pbt_population(task: str, num_policies: int, workspace: str,
                   extra_args: Sequence[str] = (),
                   python: str = sys.executable) -> RunDescription:
    """The N-policy PBT population as a RunDescription (the reference's
    run-description modules pass pbt.policy_idx per worker)."""
    base = (f"{python} -m {TRAIN_MODULE} task={task} pbt.enabled=True "
            f"pbt.workspace={workspace} pbt.num_policies={num_policies} "
            + " ".join(extra_args)).strip()
    exps = [Experiment(f"{task}_p{idx:02d}", f"{base} pbt.policy_idx={idx}")
            for idx in range(num_policies)]
    return RunDescription(f"{task}_pbt", exps)


def run_processes(run_description: RunDescription, train_dir: str,
                  max_parallel: int = 4, pause_between: float = 1.0,
                  extra_env: Optional[Dict[str, str]] = None) -> int:
    """OS-multiprocessing backend (run_processes.py:34-140): cap concurrent
    workers, stream each worker's output to its own log file, report
    failures.  Returns the number of failed processes."""
    os.makedirs(train_dir, exist_ok=True)
    queue = list(run_description.generate_experiments())
    running: List[Tuple[subprocess.Popen, str]] = []
    failed: List[str] = []
    print(f"launching {len(queue)} workers, max_parallel={max_parallel}")
    while queue or running:
        while queue and len(running) < max_parallel:
            cmd, name, env_vars = queue.pop(0)
            log_path = os.path.join(train_dir, f"{name}.log")
            env = dict(os.environ, **env_vars, **(extra_env or {}))
            log = open(log_path, "ab")
            print(f"  start {name}: {cmd}  (log: {log_path})")
            p = subprocess.Popen(cmd.split(" "), stdout=log, stderr=log,
                                 env=env)
            running.append((p, name))
            time.sleep(pause_between)
        still = []
        for p, name in running:
            rc = p.poll()
            if rc is None:
                still.append((p, name))
            elif rc != 0:
                print(f"  FAILED {name} (exit {rc})")
                failed.append(name)
            else:
                print(f"  done {name}")
        running = still
        time.sleep(0.5)
    print(f"all workers finished; {len(failed)} failed: {failed}")
    return len(failed)


def emit_slurm_script(run_description: RunDescription, train_dir: str,
                      partition: str = "batch", time_limit: str = "24:00:00",
                      out: Optional[str] = None) -> str:
    """sbatch-array analog of run_slurm.py — emitted, not submitted."""
    os.makedirs(train_dir, exist_ok=True)
    cmds = [c for c, _, _ in run_description.generate_experiments()]
    path = out or os.path.join(train_dir,
                               f"{run_description.run_name}.sbatch")
    lines = ["#!/bin/bash",
             f"#SBATCH --partition={partition}",
             f"#SBATCH --time={time_limit}",
             f"#SBATCH --array=0-{len(cmds) - 1}",
             f"#SBATCH --output={train_dir}/%A_%a.log",
             "case $SLURM_ARRAY_TASK_ID in"]
    for i, c in enumerate(cmds):
        lines.append(f"  {i}) {c} ;;")
    lines.append("esac")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {path} ({len(cmds)} array tasks)")
    return path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--run", default=None,
                        help="module[:VAR] exposing a RunDescription "
                             "(default VAR: RUN_DESCRIPTION)")
    parser.add_argument("--pbt", default=None, metavar="task=NAME",
                        help="convenience: launch a PBT population for a task")
    parser.add_argument("--num-policies", type=int, default=8)
    parser.add_argument("--workspace", default="pbt_workspace")
    parser.add_argument("--train-dir", default="./train_dir")
    parser.add_argument("--max-parallel", type=int, default=4)
    parser.add_argument("--pause-between", type=float, default=1.0)
    parser.add_argument("--backend", default="processes",
                        choices=["processes", "slurm"])
    args, extra = parser.parse_known_args(argv)

    if args.run:
        mod, _, var = args.run.partition(":")
        rd = getattr(importlib.import_module(mod), var or "RUN_DESCRIPTION")
    elif args.pbt:
        task = args.pbt.split("=", 1)[-1]
        rd = pbt_population(task, args.num_policies, args.workspace, extra)
    else:
        parser.error("one of --run / --pbt is required")
    if args.backend == "slurm":
        emit_slurm_script(rd, args.train_dir)
        return 0
    return run_processes(rd, args.train_dir, args.max_parallel,
                         args.pause_between)


if __name__ == "__main__":
    sys.exit(main())
