"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload yi6b.decode_long --seed 7 \
        --seconds 30 --trace 0

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics), ``device`` (with ``--trace
1`` also ``busy_s`` and ``window_s``), ``breakdown`` (``--trace 1``) and,
last, ``checked``: each number compared beside its limit.  The same
numbers are the last lines of standard error.  ``--quant`` serves in
another quantization mode (the control: ``w4a8_nibble``); the cells'
runs never pass it.

Exits non-zero, printing no result, without a CUDA device (or fewer than
the cell's chips), without the program beside the benchmark, or when
JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _err(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    from repro_torch.kernels import _build
    _build.BUILD_DIR = build / "kernels"


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = "nvidia-smi unavailable"
    return out.splitlines()[0] if out else "nvidia-smi gave nothing"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--quant", default=None,
                    help="serve in this quant mode instead (the control)")
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        _err(f"no program beside the benchmark: {ROOT / 'src' / 'repro_torch'}"
             f" is missing")
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # one process with one host thread for PyTorch's CPU ops: the host
    # drives the card, and idle pool threads only take the host's cores
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    torch.set_num_threads(1)
    from portbench.harness import load_cell, run_cell

    cell = load_cell(args.workload, ROOT)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _err(f"{args.workload} needs {chips} CUDA device(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    _caches()
    from portbench import cost
    _err(f"card: {_card()}; peaks used: int8 {cost.INT8_PEAK / 1e12:.0f} "
         f"TOP/s, bf16 {cost.BF16_PEAK / 1e12:.0f} TFLOP/s, HBM "
         f"{cost.HBM_BPS / 1e12:.2f} TB/s (H100 SXM at 700 W)")
    _err(f"torch {torch.__version__} cuda {torch.version.cuda}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      t_start=T_START, quant_mode=args.quant, log=_err)
    bad = forbidden_modules()
    if bad:
        _err(f"forbidden modules loaded: {', '.join(bad)}")
        return 4
    for name, c in result["checked"].items():
        _err(f"checked {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
