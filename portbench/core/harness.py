"""One run of one cell: set-up, the measured window, the per-layer reading
and the reference's judgement, as one result line.

Set-up: the card, the port's entry points, the scenario pool made from
``--seed`` by the one generator, and one warm iteration on a scenario
outside the pool (it builds the port's CUDA and host libraries into their
fixed directories inside the checkout on a checkout's first run, and finds
them built on every later one).  The window is a closed loop of one
operator proving faults one at a time, as the port's HTTP node serves one
prove per request on its card: each iteration parses a scenario's JSON,
proves it and strictly verifies the container, each call timed by
``perf_counter`` and ended by a synchronize.  Iterations start while
``--seconds`` have not passed; the window ends when the last one ends, so
it holds whole iterations only.  After it, the peak device memory is read,
the port's device memory released, and the reference judges a sample of
the window's containers drawn from the seed.
"""

from __future__ import annotations

import gc
import importlib
import os
import random
import sys
import time
from dataclasses import dataclass, field

from ..reference import check as reference
from . import traffic
from .program import Program
from .spec import ROOT, Cell
from .trace import Trace, Tracer

#: top-level module names that the process printing a result may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "dvt_circuits_tpu")
#: the limit of every number compared: each counts a fault
LIMITS = {name: 0 for name in reference.NUMBERS}


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record of its
    start (``/proc/self/stat``) on the boot clock."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - started


def cache_env() -> None:
    """Fixed build and kernel-cache directories inside the checkout."""
    base = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def forbidden_modules() -> list:
    """Forbidden top-level names among the loaded modules, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


@dataclass
class Run:
    """What a metric reader reads."""

    cell: Cell
    records: list  # one dict per window iteration
    window_s: float
    setup_s: float
    peak_bytes: int
    trace: Trace = None

    @property
    def proven(self) -> list:
        return [r for r in self.records if "prove_s" in r]

    @property
    def verified(self) -> list:
        return [r for r in self.records if "verify_s" in r]


def reader(name: str):
    """The reader of metric ``name``: ``portbench/metrics/<name>.py``."""
    return importlib.import_module(f"portbench.metrics.{name}").read


@dataclass
class Outcome:
    line: dict  # the result line
    notes: list = field(default_factory=list)  # why a number is not 0


def _window(program, pool: list, seconds: float, tracer: Tracer) -> tuple:
    records = []
    t_start = time.perf_counter()
    with tracer.span("window"):
        for i, raw in enumerate(pool):
            if time.perf_counter() - t_start >= seconds:
                break
            rec = {"index": i}
            records.append(rec)
            try:
                t0 = time.perf_counter()
                with tracer.span(f"parse_{i}"):
                    data = program.parse(raw)
                with tracer.span(f"prove_{i}"):
                    rec["container"] = program.prove(data)
                t1 = time.perf_counter()
                rec["prove_s"] = t1 - t0
                with tracer.span(f"verify_{i}"):
                    program.verify(rec["container"])
                rec["verify_s"] = time.perf_counter() - t1
            except Exception as e:  # the run counts every failed iteration
                rec["error"] = f"{type(e).__name__}: {e}"
        window_s = time.perf_counter() - t_start
    return records, window_s


def judge(cell: Cell, pool: list, records: list, seed: int, device: str) -> tuple:
    """The numbers compared and the notes on every fault found.  The
    reference's plain PyTorch verifier runs on ``device``, after the port's
    device memory is released."""
    notes = [f"iteration {r['index']}: {r['error']}" for r in records if "error" in r]
    numbers = dict.fromkeys(reference.NUMBERS, 0)
    numbers["failed_in_window"] = len(notes)
    done = [r for r in records if "container" in r]
    sample = random.Random(seed).sample(done, min(int(cell.mix["check_sample"]), len(done)))
    circuit = cell.mix["circuit"]
    for r in sorted(sample, key=lambda r: r["index"]):
        why = reference.statement_differs(pool[r["index"]], r["container"], cell.config, circuit)
        if why:
            numbers["wrong_statement"] += 1
            notes.append(f"iteration {r['index']}: {why}")
        why = reference.rejection(r["container"], cell.config, circuit, device)
        if why:
            numbers["rejected_by_reference"] += 1
            notes.append(f"iteration {r['index']}: {why}")
    if not done:
        notes.append("no container came out of the window")
    correct = bool(done) and all(numbers[k] <= LIMITS[k] for k in numbers)
    return correct, numbers, notes, len(sample)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        control: str = "", program_cls=Program) -> Outcome:
    """One run of ``cell``; ``device="cpu"`` is for the tests alone."""
    import torch

    if device == "cuda":
        torch.zeros(1, device="cuda")
    program = program_cls(cell.config, cell.mix["circuit"], device, control)
    n_pool = int(cell.mix["pool"])
    pool = traffic.pool(cell.config, cell.mix, cell.mix_name, seed, n_pool)
    warm = traffic.scenario(cell.config, cell.mix, cell.mix_name, seed, traffic.WARM)
    warm_notes = []
    try:
        program.verify(program.prove(program.parse(warm)))
    except Exception as e:  # the window counts the faults; set-up goes on
        warm_notes.append(f"warm-up iteration: {type(e).__name__}: {e}")
    gc.collect()
    gc.freeze()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = process_age_s()

    tracer = Tracer(trace, device)
    with tracer:
        records, window_s = _window(program, pool, seconds, tracer)
        t_stop = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    gc.unfreeze()
    notes = []
    tr = None
    if trace:
        t_read = time.perf_counter()
        tr = Trace.from_profiler(tracer.prof, "window")
        notes.append(f"trace: {len(tr.ops)} device operations, collected in "
                     f"{t_read - t_stop:.1f} s, read in {time.perf_counter() - t_read:.1f} s")
    state = Run(cell, records, window_s, setup_s, peak, tr)

    names = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in names:
        value = reader(m["name"])(state)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
    del program
    if device == "cuda":
        torch.cuda.empty_cache()

    t_judge = time.perf_counter()
    correct, numbers, found, checked = judge(cell, pool, records, seed, device)
    notes = warm_notes + notes + found
    notes.append(f"the reference judged {checked} of the window's {len(records)} containers "
                 f"in {time.perf_counter() - t_judge:.1f} s")
    if len(records) == len(pool) and window_s < seconds:
        notes.append(f"the pool of {len(pool)} scenarios ran out {window_s:.1f} s into "
                     f"a window of {seconds} s")
    line = {"correct": correct, "attempted": len(records), "failed": numbers["failed_in_window"],
            "metrics": metrics, "device": dev}
    if tr is not None:
        line["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    line["checks"] = {k: {"value": v, "limit": LIMITS[k]} for k, v in numbers.items()}
    return Outcome(line, notes)
