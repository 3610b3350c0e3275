"""Run one cell of the benchmark of ``pixray_tpu_torch`` once, on the card.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, weights made on the card from the seed, the engine, the
warm-up steps) is timed from the start of this process; then the window
runs for ``--seconds``; then the first steps are judged against the plain
reference.  The last line of standard output is the result's JSON object;
the last lines of standard error hold each compared number beside its
limit.  Exits non-zero without a result where there is no CUDA card, fewer
cards than the cell needs, no program to measure, or JAX loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, ROOT)
    # every kernel cache of a run at a fixed place inside the checkout (the
    # port builds its CUDA kernels into pixray_tpu_torch/_build/ there too)
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    import torch

    from portbench.harness import cell as C
    from portbench.harness import nojax
    from portbench.harness.measure import measure

    cell = C.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, lines = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    loaded = nojax.loaded()  # the window has closed; this process prints the result
    if loaded:
        print(f"portbench: JAX or the JAX package is loaded: {loaded}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
