"""What every run of the benchmark shares: the cell's files found by name,
the caches kept inside the checkout, the device checks, and the result
line."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
CACHE = os.path.join(ROOT, "build", "bench_cache")
# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "uwcv_tpu")


class Unfit(RuntimeError):
    """The run cannot give a result (no card, missing program, ...)."""


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own CUDA build lives under ``build/uwcv_tpu_torch``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        path = os.path.join(CACHE, sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path
    # keep libraries from loading JAX on their own
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def cell(workload: str, root: str = ROOT) -> Dict:
    """The workload's entry of BENCHMARK.json with its configuration's and
    traffic mix's files loaded: {"workload", "config", "traffic", "spec"}."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    for w in bench["workloads"]:
        if w["name"] == workload:
            break
    else:
        raise Unfit(f"no workload named {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    return {"workload": w, "spec": bench,
            "config": load_json(os.path.join(root, conf["file"])),
            "traffic": load_json(os.path.join(BENCH, "traffic",
                                              w["traffic"] + ".json"))}


def metric_names(spec: Dict, workload: str, kind: str) -> List[dict]:
    """The end_to_end or per_layer metrics that this workload reports."""
    return [m for m in spec[kind]
            if workload in m.get("workloads", [workload])]


def driver(kind: str):
    """The driver of a traffic mix's ``kind``: the module
    ``benchmark/harness/<kind>.py``, whose ``run(ctx, args, t_start)``
    sets up, measures and checks one run."""
    import importlib

    if not kind.isidentifier() or not os.path.isfile(
            os.path.join(BENCH, "harness", kind + ".py")):
        raise Unfit(f"no driver benchmark/harness/{kind}.py")
    return importlib.import_module("benchmark.harness." + kind)


def reader(name: str):
    """The per-layer metric ``name``'s reader, ``benchmark/metrics/
    <name>.py::read(ctx) -> float | None``."""
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def require_devices(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise Unfit("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise Unfit(f"{torch.cuda.device_count()} CUDA devices, the cell "
                    f"asks for {chips}")


def forbidden_loaded() -> List[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)
                   if n.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_block(chips: int, trace: Optional[dict] = None,
                 device=None) -> Dict:
    import torch

    if device is not None and device.type != "cuda":
        return {"platform": device.type, "kind": device.type, "count": 1,
                "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips,
           "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                    for i in range(chips))}
    if trace is not None:
        out["busy_s"] = trace["busy_s"]
        out["window_s"] = trace["window_s"]
    return out


def checks_block(numbers: Dict[str, float], limits: Dict[str, float]
                 ) -> Dict[str, Dict[str, float]]:
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def emit(result: Dict, checks: Dict[str, Dict[str, float]]) -> None:
    """The numbers compared beside their limits as the last lines of
    standard error, then the result line (``checks`` last) on standard
    output."""
    for k, c in checks.items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    out = dict(result)
    out["checks"] = checks
    print(json.dumps(out), flush=True)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
