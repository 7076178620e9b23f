"""Config system of the port (counterpart of
isaacgymenvs_ma_tpu/utils/config.py).

Every task and train config is a nested dict registered in Python, merged
as global defaults < task defaults < CLI overrides, with the same
dotted-override grammar: ``task.env.numEnvs=4096``,
``train.params.config.horizon_length=32``, the ``num_envs=512`` shorthand.

The JAX package parses each override value with ``yaml.safe_load``; the
port has no PyYAML, so ``_parse_value`` resolves the scalar forms a command
line takes by PyYAML's own YAML 1.1 rules (bool, null, int, float, plain
and quoted strings) and flow lists ``[a, b]``.  A user YAML file
(``user_yaml``) is not supported.  :func:`dump_yaml` writes the run's
``config.yaml`` snapshot (the JAX ``train.py`` writes it with
``yaml.safe_dump``): block mappings, flow sequences, every string
double-quoted, so that ``yaml.safe_load`` reads it back as it reads the
JAX snapshot.
"""
from __future__ import annotations

import copy
import math
import re
from typing import Any, Dict, List, Optional

# mirror of the root config surface (reference cfg/config.yaml); the port
# runs on the card unless the caller asks for the CPU
GLOBAL_DEFAULTS: Dict[str, Any] = {
    "task_name": "Cartpole",
    "experiment": "",
    "num_envs": "",
    "seed": 42,
    "torch_deterministic": False,
    "max_iterations": "",
    "sim_device": "cuda:0",
    "rl_device": "cuda:0",
    "graphics_device_id": 0,
    "pipeline": "gpu",
    "multi_gpu": False,
    "test": False,
    "checkpoint": "",
    "sigma": "",
    "headless": True,
    "capture_video": False,
    "capture_video_freq": 1464,
    "capture_video_len": 100,
    "force_render": False,
    "wandb_activate": False,
    "wandb_group": "",
    "wandb_name": "",
    "wandb_entity": "",
    "wandb_project": "isaacgymenvs_ma_tpu",
    "wandb_tags": [],
    "wandb_logcode_dir": "",
    "pbt": {"enabled": False},
}


def deep_merge(base: dict, override: dict) -> dict:
    """``base`` with ``override`` merged in recursively; neither is
    modified."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


# PyYAML's implicit resolvers (yaml/resolver.py, YAML 1.1); sexagesimal
# numbers (1:30) and timestamps are left as strings
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


def _scalar(s: str) -> Any:
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if _INT.match(s):
        v = s.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v != "0" and v.startswith("0"):
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(s):
        v = s.replace("_", "").lower()
        if v.endswith(".inf"):
            return float("-inf") if v[0] == "-" else float("inf")
        if v.endswith(".nan"):
            return float("nan")
        return float(v)
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    return s


def _split_flow(body: str) -> Optional[List[str]]:
    """Items of a flow list's body at bracket depth 0; None if unbalanced."""
    items, depth, start = [], 0, 0
    for i, c in enumerate(body):
        if c == "[":
            depth += 1
        elif c == "]":
            depth -= 1
            if depth < 0:
                return None
        elif c == "," and depth == 0:
            items.append(body[start:i])
            start = i + 1
    if depth != 0:
        return None
    items.append(body[start:])
    if items[-1].strip() == "":        # "[]" and a trailing comma
        items.pop()
    return items


def _parse_value(s: str) -> Any:
    """A CLI override value as ``yaml.safe_load`` reads it; a value it would
    reject stays the raw string, as in the JAX package."""
    t = s.strip()
    if t.startswith("["):
        if not t.endswith("]"):
            return s
        items = _split_flow(t[1:-1])
        if items is None:
            return s
        return [_parse_value(x) for x in items]
    return _scalar(t)


def apply_overrides(cfg: dict, overrides: Optional[List[str]]) -> dict:
    """Dotted CLI overrides: ``a.b.c=value`` (Hydra grammar; +/++ prefixes ok)."""
    if not overrides:
        return cfg
    cfg = copy.deepcopy(cfg)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override '{ov}' is not key=value")
        key, val = ov.split("=", 1)
        key = key.lstrip("+")
        parts = key.split(".")
        node = cfg
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(val)
    return cfg


def resolve_default(default, value):
    """The reference's ``${resolve_default:X,${...}}`` resolver semantics."""
    return default if value in ("", None) else value


def load_task_config(task_name: str, overrides: Optional[List[str]] = None
                     ) -> dict:
    """Resolve a full task config dict (the reference's ``cfg.task`` subtree)."""
    from ..tasks import registry

    cfg = copy.deepcopy(registry.task_default_config(task_name))
    return apply_overrides(cfg, overrides)


def load_train_config(task_name: str, overrides: Optional[List[str]] = None
                      ) -> dict:
    from ..learning import configs as train_configs

    cfg = copy.deepcopy(train_configs.train_default_config(task_name))
    return apply_overrides(cfg, overrides)


def print_dict(d: dict, prefix: str = ""):
    for k, v in d.items():
        if isinstance(v, dict):
            print(f"{prefix}{k}:")
            print_dict(v, prefix + "  ")
        else:
            print(f"{prefix}{k}: {v}")


# ----------------------------------------------------------------------
# the config.yaml snapshot

def _yaml_str(s: str) -> str:
    """A double-quoted YAML scalar: ASCII, with escapes YAML 1.1 reads."""
    out = ['"']
    for c in s:
        o = ord(c)
        if c in '"\\':
            out.append("\\" + c)
        elif 0x20 <= o < 0x7F:
            out.append(c)
        elif o <= 0xFF:
            out.append(f"\\x{o:02x}")
        elif o <= 0xFFFF:
            out.append(f"\\u{o:04x}")
        else:
            out.append(f"\\U{o:08x}")
    out.append('"')
    return "".join(out)


def _yaml_float(x: float) -> str:
    """PyYAML's float spelling: its resolver wants a dot and a signed
    exponent ("1.0e-05", not "1e-05")."""
    if math.isnan(x):
        return ".nan"
    if math.isinf(x):
        return ".inf" if x > 0 else "-.inf"
    r = repr(x).lower()
    if "." not in r and "e" in r:
        r = r.replace("e", ".0e", 1)
    elif "." not in r:
        r += ".0"
    return r


def _yaml_scalar(v: Any) -> str:
    if hasattr(v, "item") and not isinstance(v, (str, bytes)):
        v = v.item()                   # numpy / torch scalars
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return _yaml_float(v)
    if isinstance(v, str):
        return _yaml_str(v)
    raise TypeError(f"cannot write {type(v).__name__} into config.yaml")


def _yaml_flow(v: Any) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_yaml_key(k)}: {_yaml_flow(x)}"
                               for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_yaml_flow(x) for x in v) + "]"
    return _yaml_scalar(v)


_PLAIN_KEY = re.compile(r"^[A-Za-z_][A-Za-z0-9_.-]*$")


def _yaml_key(k: Any) -> str:
    """A mapping key: plain where PyYAML reads it back as the same string,
    else as :func:`_yaml_scalar` writes it."""
    if (isinstance(k, str) and _PLAIN_KEY.match(k)
            and not (_BOOL.match(k) or _NULL.match(k) or _FLOAT.match(k))):
        return k
    return _yaml_scalar(k)


def _yaml_block(d: dict, indent: int, lines: List[str]) -> None:
    pad = " " * indent
    for k, v in d.items():
        key = _yaml_key(k)
        if isinstance(v, dict) and v:
            lines.append(f"{pad}{key}:")
            _yaml_block(v, indent + 2, lines)
        else:
            lines.append(f"{pad}{key}: {_yaml_flow(v)}")


def dump_yaml(cfg: dict) -> str:
    """``cfg`` as a YAML document that ``yaml.safe_load`` reads back equal
    to ``yaml.safe_load(yaml.safe_dump(cfg))``: tuples become lists, as
    there."""
    lines: List[str] = []
    _yaml_block(cfg, 0, lines)
    return "\n".join(lines) + "\n" if lines else "{}\n"


def write_config_snapshot(path: str, cfg: dict) -> str:
    """Write the run's ``config.yaml`` (JAX train.py:108-114)."""
    import os
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="ascii") as f:
        f.write(dump_yaml(cfg))
    return path
