"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, loaded with ``ctypes``.
Libraries are keyed by a hash of the sources, so an edited kernel is
rebuilt on its next use.  Builds land in ``build/kernels/`` at the
repository root (git-ignored); ``build_all`` starts one ``nvcc`` per source
at once and keeps each compiler's report (``-Xptxas -v``: registers,
spills) beside its library (``build_log``).  Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
KERNEL_SOURCES = ("poseidon2", "keccak", "mulchain", "curve", "lane_probe")

_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and no
    card is present (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else "nvcc"


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=KERNEL_SOURCES) -> dict:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns {name: path}; raises with the compiler's output if
    any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log.decode(errors='replace')}")
        else:
            out.with_suffix(".log").write_bytes(log)
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: _library_path(name) for name in names}


def build_log(name: str) -> str:
    """The compiler's report for ``csrc/<name>.cu`` (after ``build_all``)."""
    return _library_path(name).with_suffix(".log").read_text(errors="replace")


def load(name: str) -> ctypes.CDLL:
    """Load the library for ``csrc/<name>.cu``, building it if missing."""
    return ctypes.CDLL(str(build_all((name,))[name]))


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")


def stream_handle(t: torch.Tensor) -> int:
    """The current CUDA stream on ``t``'s device, as the int a launch takes:
    PyTorch's raw accessor, which builds no ``torch.cuda.Stream`` object
    per call."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
