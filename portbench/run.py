"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this folder and
the ``noisereduce_tpu_torch`` package. It needs as many CUDA cards as the
cell asks for, and exits with another code than 0, printing no result,
without them, without the package, or if JAX or the JAX package was
loaded. The last line of standard output is the result's JSON object; the
numbers the check compared, each beside its limit, are the last lines of
standard error.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# the program's kernel caches stay inside the checkout (its own build
# cache, noisereduce_tpu_torch/_build/, already does)
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / ".portbench_cache" / sub)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import harness

    if not (ROOT / "noisereduce_tpu_torch" / "__init__.py").is_file():
        print(f"no noisereduce_tpu_torch package beside {ROOT / 'portbench'}", file=sys.stderr)
        return 2
    plan = harness.load_plan(args.workload, ROOT)
    chips = plan.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(plan, args.seed, args.seconds, bool(args.trace), "cuda:0",
                              T_PROCESS)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in the measured process: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
