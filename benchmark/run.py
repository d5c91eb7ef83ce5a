"""One run of one cell of the benchmark of ``uwcv_tpu_torch``.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Sets up the cell named in ``BENCHMARK.json`` (its configuration from
``benchmark/configs``, its traffic mix from ``benchmark/traffic``, whose
``kind`` names the driver module in ``benchmark/harness``), warms
up every shape it uses, measures for ``--seconds`` (with ``--trace 1`` a
traced window whose per-layer metrics the readers in
``benchmark/metrics`` take), checks the outputs against the plain
reference in ``benchmark/reference``, and prints one JSON line.  Exits
non-zero with no result line when there is no card, when the program is
missing, or when JAX or the JAX package got loaded.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

T_START = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import common  # noqa: E402

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    common.set_cache_dirs()
    try:
        ctx = common.cell(args.workload)
        common.require_devices(ctx["workload"]["chips"])
        try:
            import uwcv_tpu_torch  # noqa: F401
        except ImportError as e:
            raise common.Unfit(f"the program is not here: {e}") from e
        driver = common.driver(ctx["traffic"]["kind"])
        out = driver.run(ctx, args, T_START)
    except common.Unfit as e:
        common.log(f"no result: {e}")
        return 2
    loaded = common.forbidden_loaded()
    if loaded:
        common.log(f"no result: modules loaded in this process: {loaded}")
        return 3
    checks = common.checks_block(out["numbers"], out["limits"])
    result = {"correct": common.passed(checks), **out["result"]}
    common.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
