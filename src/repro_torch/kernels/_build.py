"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

No reference counterpart: Pallas kernels compile inside ``jax.jit``. Here
each source is compiled on first use with ``nvcc -gencode
arch=compute_90a,code=sm_90a`` into a shared library with a plain C
interface, which ``ctypes`` loads. The libraries land in ``build/kernels/``
at the root of the checkout (listed in ``.gitignore``), named by a hash of
their sources and flags, so an edited kernel is rebuilt and an unchanged one
is reused. ``build_all`` starts one ``nvcc`` per source, all at once.

Nothing here runs at import time: the CPU tests import every module, and
this machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

__all__ = ["SOURCES", "Launches", "build_all", "kernel", "check_launch",
           "forward_only", "dtype_code", "lib_path", "BUILD_DIR",
           "ptxas_report", "sass_count"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# kernel entry point -> (source file, C symbol, ctypes argtypes); entry
# points that share a source share its library
SOURCES = {
    "gossip_mix": ("gossip_mix.cu", "gossip_mix_launch",
                   [_I, _I, _P, _P, _P, _LL, _F, _F, _P, _LL, _P]),
    "gossip_mix_q": ("gossip_mix.cu", "gossip_mix_q_launch",
                     [_I, _I, _P, _P, _P, _LL, _F, _F, _P, _LL, _P]),
    "fused_sgd": ("fused_sgd.cu", "fused_sgd_launch",
                  [_I, _I, _P, _P, _P, _P, _P, _LL, _F, _F, _P, _LL, _F, _F,
                   _F, _P]),
    "fused_adamw": ("fused_adamw.cu", "fused_adamw_launch",
                    [_I, _I, _P, _P, _P, _P, _P, _P, _LL, _F, _F, _P, _LL]
                    + [_F] * 9 + [_P]),
    "fused_lars": ("fused_lars.cu", "fused_lars_launch",
                   [_I, _I, _P, _P, _P, _P, _P, _LL, _F, _F, _P, _LL, _F, _F,
                    _F, _P]),
    "ssm_scan": ("ssm_scan.cu", "ssm_scan_launch",
                 [_P, _P, _P, _LL, _LL, _LL, _P]),
    "flash_attention": ("flash_attention.cu", "flash_attention_launch",
                        [_I, _I, _I, _P, _P, _P, _P, _LL, _LL, _LL, _I, _F,
                         _I, _I, _LL, _LL, _LL, _P]),
}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
                torch.float8_e4m3fn: 3}
BUCKET_DTYPES = (torch.float32, torch.bfloat16)
CODE_DTYPES = (torch.int8, torch.float8_e4m3fn)


class Launches:
    """Launch count of one kernel wrapper: ``count`` grows by one where the
    wrapper launches its kernel, and nowhere else."""

    def __init__(self) -> None:
        self.count = 0

    def reset(self) -> None:
        self.count = 0


def dtype_code(dtype: torch.dtype, allowed=BUCKET_DTYPES) -> int:
    """The kernels' code of ``dtype``; raises unless it is ``allowed``."""
    if dtype not in allowed:
        raise TypeError(f"kernel takes {[str(d) for d in allowed]}, "
                        f"got {dtype}")
    return _DTYPE_CODES[dtype]


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    cand = Path("/usr/local/cuda/bin") / name
    if cand.exists():
        return str(cand)
    raise RuntimeError(f"{name} not found: the CUDA kernels build only where "
                       f"the CUDA toolkit is installed")


def lib_path(source: str) -> Path:
    """Where the library of ``csrc/<source>`` is built (its nvcc output,
    ptxas report included, sits beside it with the suffix ``.log``)."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}-{h.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, float]:
    """Build the sources of the named entry points that are not built yet,
    one ``nvcc`` per source, all started together. Returns the seconds each
    source took (0.0 for a library that was already there); raises on a
    failed build, with the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for src in dict.fromkeys(SOURCES[n][0] for n in names):
        out = lib_path(src)
        if out.exists():
            seconds[src] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out, time.perf_counter())
    failed = []
    for src, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[src] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


@functools.lru_cache(maxsize=None)
def kernel(name: str):
    """The bound C entry point ``name``, its source built on first use."""
    build_all([name])
    src, symbol, argtypes = SOURCES[name]
    fn = getattr(ctypes.CDLL(str(lib_path(src))), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def forward_only(name: str, *tensors: torch.Tensor) -> None:
    """Refuse a call that autograd would record: the kernel has no backward
    (nor has the reference's), and its output would carry no ``grad_fn``,
    so gradients upstream of it would silently be zero. Checked on every
    device, so the CPU path refuses what the card's would."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only: call it under torch.no_grad() or on "
            f"tensors that do not require grad")


def check_launch(name: str, rc: int) -> None:
    """A refused launch never runs and ``synchronize`` does not report it,
    so every wrapper checks the launch's own error code."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError_t {rc})")


def ptxas_report(source: str) -> Dict[str, dict]:
    """Per kernel of the built ``csrc/<source>``, from its ``-Xptxas -v``
    log: registers and spill bytes (stores and loads), and the warnings
    ptxas gave for it."""
    out: Dict[str, dict] = {}
    cur = None
    for line in lib_path(source).with_suffix(".log").read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$.]+)'?", line)
        if m:
            cur = out.setdefault(m.group(1), {"registers": None,
                                              "spill_bytes": 0,
                                              "warnings": []})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_bytes"] += int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        if "warning" in line.lower():
            cur["warnings"].append(line.strip())
    return out


def sass_count(source: str, opcode: str) -> Dict[str, int]:
    """Per kernel of the built ``csrc/<source>``, how many instructions of
    its SASS (``cuobjdump -sass``) start with ``opcode`` (``HGMMA`` for
    Hopper's warpgroup products). Raises where ``cuobjdump`` is missing."""
    sass = subprocess.run([_tool("cuobjdump"), "-sass",
                           str(lib_path(source))], capture_output=True,
                          text=True, check=True).stdout
    out: Dict[str, int] = {}
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            out[cur] = 0
        elif cur is not None and re.search(rf"\*/\s+(@!?U?P\w+\s+)?"
                                           rf"{opcode}\b", line):
            out[cur] += 1
    return out
