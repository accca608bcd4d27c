"""Run one cell of the port's benchmark and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository's root. Set-up (loading, the kernel library's build on
a checkout's first run, warm-up) is timed from the start of this process to
the window's first request; the window then runs the cell's traffic for
``--seconds``. Afterwards the program is freed, the plain reference judges
every answer the window served, and the last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last (each
compared number beside its limit, which also end standard error).

It exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), when the JAX package or JAX is loaded, or when the
reference module imports the program.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(BENCH_DIR)
for p in (BENCH_DIR, REPO_ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import guard, judge, manifest, reference, weights  # noqa: E402
from harness import images as images_mod  # noqa: E402
from harness.load import drive  # noqa: E402
from harness.run_state import Run  # noqa: E402
from harness.tracing import Tracer  # noqa: E402


def log(*parts) -> None:
    print("[port_bench]", *parts, file=sys.stderr, flush=True)


class Refused(Exception):
    """The run cannot give a result (exit code 3)."""


def check_device(chips: int, device: str) -> None:
    import torch

    if device != "cuda":
        return
    if not torch.cuda.is_available():
        raise Refused("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} CUDA devices, "
                      f"{torch.cuda.device_count()} present")


def check_route(config: dict, traffic: dict) -> None:
    """The route runs at the precision that the configuration states:
    the int8 decoder weights (``route.quantize``) only where it states
    them (``decode_weights``), since no limit of ``correct`` can tell a
    lower precision from the stated one."""
    stated = config.get("decode_weights", config["model"]["dtype"])
    runs = ("int8" if traffic.get("route", {}).get("quantize")
            else config["model"]["dtype"])
    if runs != stated:
        raise Refused(f"the route runs {runs} decoder weights, the "
                      f"configuration states {stated}")


def check_imports() -> None:
    bad = guard.loaded(guard.JAX_NAMES)
    if bad:
        raise Refused(f"JAX or the JAX package is loaded: {bad}")
    bad = guard.imported_by(reference, guard.PROGRAM_NAMES | guard.JAX_NAMES)
    if bad:
        raise Refused(f"the reference imports the program: {bad}")


async def measure(run: Run, ctx: dict) -> dict:
    """Set-up, the window, and the program freed; returns the device
    reading taken before the program was freed."""
    import torch

    entry = manifest.load_module("entries", run.traffic["entry"])
    gen = manifest.load_module("generators", run.traffic["generator"])
    system = entry.System(run, ctx)
    if ctx.get("fault") is not None:
        ctx["fault"](system)
    await system.start()
    plan = gen.plan(run.traffic, run.seed, len(ctx["images_u8"]),
                    run.seconds)
    if ctx["device"] == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # set-up's objects leave the collector's generations, so that its
    # passes in the window scan only what the window makes
    gc.collect()
    gc.freeze()
    tracer = ctx["tracer"]
    run.setup_s = time.perf_counter() - ctx["t_process"]
    tracer.start_at = (time.perf_counter()
                       + run.traffic.get("trace_start", 0.3) * run.seconds)
    run.stats0 = system.snapshot()

    def window_end():
        run.stats1 = system.snapshot()

    await drive(run, plan, system.send, window_end)
    reading = {}
    if ctx["device"] == "cuda":
        torch.cuda.synchronize()
        reading["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    await system.stop()
    del system
    gc.unfreeze()
    return reading


def execute(cell_name: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", cell=None, t_process: float = None,
            fault=None, control: bool = False, detail: bool = False
            ) -> dict:
    """One run; returns the result object. ``cell`` and ``device`` let a
    CPU test drive a small configuration; ``fault`` breaks the timed path
    (a callable of ``harness/faults.py`` or a test's, given the entry's
    system); ``control`` also judges the control (``judge.gaps``) against
    the same limits, into the result's ``control_correct`` and
    ``control_checks``; ``detail`` adds the judge's readings
    (``judged``, ``distinct_answers``)."""
    import torch

    cell = cell or manifest.find_cell(cell_name)
    check_device(cell.chips, device)
    check_route(cell.config, cell.traffic)
    from handwritten_math_ocr_api_torch.core.config import \
        model_config_from_dict
    from handwritten_math_ocr_api_torch.core.tokenizer import (Tokenizer,
                                                               load_vocab)

    config = cell.config
    run = Run(cell.name, config, cell.traffic, int(seed), float(seconds),
              bool(trace))
    model = config["model"]
    imgs = images_mod.load_u8(os.path.join(REPO_ROOT, config["images"]),
                              model["img_h"], model["img_w"])
    vocab_path = os.path.join(REPO_ROOT, config["vocab"])
    vocab = reference.Vocab(vocab_path)
    run.notes["vocab"] = vocab
    params, state = weights.load(config, seed, device)
    tracer = Tracer(bool(trace), cell.traffic.get("trace_seconds", 2.0))
    tracer.warm()
    ctx = {"params": params, "state": state,
           "cfg": model_config_from_dict(model),
           "tokenizer": Tokenizer(*load_vocab(vocab_path)),
           "images_u8": imgs, "device": device, "tracer": tracer,
           "t_process": T_PROCESS if t_process is None else t_process,
           "fault": fault}
    reading = asyncio.run(measure(run, ctx))
    tracer.finish()
    run.traced = tracer.result()
    run.notes["trace_stop_s"] = tracer.stop_s
    del ctx
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    check_imports()
    limits = config_limits(cell.name)
    ref_params = reference.tensors(params, device)
    ref_state = reference.tensors(state, device)
    del params, state
    t_judge = time.perf_counter()
    checks = judge.checks(run, ref_params, ref_state, vocab, imgs, device,
                          limits, control)
    run.notes["judge_s"] = time.perf_counter() - t_judge
    del ref_params, ref_state
    metrics = manifest.read_metrics(
        cell.per_layer if trace else cell.end_to_end, run)
    due = run.due_in_window()
    result = {"correct": judge.passed(checks),
              "attempted": len(due),
              "failed": sum(1 for r in due if not r.ok),
              "metrics": metrics,
              "device": device_info(cell.chips, device, reading, run)}
    if trace and run.traced is not None:
        result["breakdown"] = {"device_ops": run.traced.device_ops,
                               "idle_gaps": run.traced.idle_gaps}
    if detail or control:
        result["judged"] = run.notes["judged"]
        result["distinct_answers"] = run.notes["distinct_answers"]
    if control:
        result["control_checks"] = run.notes["control_checks"]
        result["control_correct"] = judge.passed(result["control_checks"])
    result["checks"] = checks
    report(run, result)
    return result


def config_limits(cell_name: str) -> dict:
    with open(os.path.join(BENCH_DIR, "limits", f"{cell_name}.json")) as f:
        return json.load(f)["limits"]


def device_info(chips: int, device: str, reading: dict, run: Run) -> dict:
    import torch

    info = {"platform": "gpu" if device == "cuda" else device,
            "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                     else "cpu"),
            "count": chips,
            "memory_peak_bytes": reading.get("memory_peak_bytes", 0)}
    if run.trace and run.traced is not None:
        info["busy_s"] = run.traced.busy_s
        info["window_s"] = run.traced.window_s
    return info


def report(run: Run, result: dict) -> None:
    """The run's side readings on standard error, and the compared numbers
    beside their limits last."""
    t = run.traced
    if run.trace:
        if t is None:
            log("trace: the traced window did not close")
        else:
            log(f"trace: stopping the profiler after the window took "
                f"{run.notes.get('trace_stop_s', 0.0):.3f} s")
            log(f"trace: window {t.window_s:.4f} s, busy {t.busy_s:.4f} s, "
                f"the port's kernels in the trace {t.port_seen}, launched "
                f"{sum(t.launches.values())} (complete: {t.complete}); "
                f"device operations placed without their launch "
                f"{t.unlaunched}")
            log("trace: launches by counter:",
                json.dumps({f"{k[0]}.{k[1]}": v
                            for k, v in t.launches.items() if v}))
    log(f"judged in {run.notes['judge_s']:.2f} s:",
        json.dumps(run.notes.get("judged")))
    log("distinct answers in the window:", run.notes["distinct_answers"])
    log("power:", power_line())
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")


def power_line() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def steady_host() -> None:
    """Keep this process's threads on four fixed cores (not the first,
    which takes the machine's interrupts), with as many intra-op threads:
    the launching threads then neither wander between cores nor meet a
    pool sized by the machine."""
    import torch

    cpus = sorted(os.sched_getaffinity(0))
    keep = cpus[1:5] if len(cpus) > 4 else cpus
    os.sched_setaffinity(0, keep)
    torch.set_num_threads(len(keep))


def main(argv=None) -> int:
    steady_host()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = execute(args.workload, args.seed, args.seconds,
                         bool(args.trace))
    except (Refused, KeyError, FileNotFoundError) as e:
        log(f"refused: {e}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
