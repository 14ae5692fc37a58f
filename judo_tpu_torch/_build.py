"""Build and load the port's hand-written kernels.

The CUDA sources in ``judo_tpu_torch/csrc`` are compiled on first use with
``nvcc`` for Hopper (``sm_90a``) into a shared library with a plain C
interface, loaded with ``ctypes``: each source is compiled to an object by its
own compiler process, all started together, and the objects are linked into
one ``libjt.so``. The same step body also builds with ``g++`` into a CPU
library (the host twins, ``*_host.cpp``) that the CPU tests use to check the
kernels' arithmetic. Builds land in ``build/judo_tpu_torch/`` at the
repository root, keyed by a hash of the sources, so a changed source rebuilds
and an unchanged one loads at once. A failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "judo_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
GXX_FLAGS = ["-std=c++17", "-O2", "-fPIC"]

_LOADED: dict = {}


class KernelBuildError(RuntimeError):
    """A kernel library failed to compile; the message holds the compiler output."""


def _sources(kind: str) -> list[Path]:
    headers = sorted(CSRC.glob("*.cuh"))
    main = sorted(CSRC.glob("*.cu")) if kind == "cuda" else sorted(CSRC.glob("*_host.cpp"))
    return main + headers


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise KernelBuildError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")
    return found


def _compile(kind: str, out: Path) -> str:
    """Compile every source of ``kind`` to an object in parallel, then link."""
    srcs = [p for p in _sources(kind) if p.suffix in (".cu", ".cpp")]
    if kind == "cuda":
        cc, flags = _nvcc(), [*NVCC_FLAGS, "-Xptxas", "-v"]
    else:
        cc = shutil.which("g++")
        if cc is None:
            raise KernelBuildError("g++ not found")
        flags = GXX_FLAGS
    objs = [out.parent / f"{out.stem}.{p.stem}.o" for p in srcs]
    cmds = [[cc, *flags, "-c", "-o", str(o), str(p)] for p, o in zip(srcs, objs)]
    cmds.append([cc, "-shared", "-o", str(out), *map(str, objs)])
    log = ""
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=CSRC) for c in cmds[:-1]]
        results = [(c, p.communicate()[0], p.returncode) for c, p in zip(cmds, procs)]
        if all(rc == 0 for _, _, rc in results):
            proc = subprocess.run(cmds[-1], capture_output=True, text=True, cwd=CSRC)
            results.append((cmds[-1], proc.stdout + proc.stderr, proc.returncode))
        for c, text, rc in results:
            log += f"$ {' '.join(c)}\n{text}"
            if rc != 0:
                raise KernelBuildError(f"{kind} build failed (exit {rc}):\n{log}")
    finally:
        for o in objs:
            if o.exists():
                o.unlink()
    return log


def library_path(kind: str) -> Path:
    """Path of the built library for ``kind`` ("cuda" or "host"); builds it if missing."""
    h = hashlib.sha256()
    for p in _sources(kind):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS if kind == "cuda" else GXX_FLAGS).encode())
    out = BUILD_DIR / f"{kind}-{h.hexdigest()[:16]}" / "libjt.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        t0 = time.perf_counter()
        log = _compile(kind, Path(tmp))
        (out.parent / "build.log").write_text(f"{log}\nbuild seconds: {time.perf_counter() - t0:.1f}\n")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(kind: str) -> ctypes.CDLL:
    """Build (once) and load the kernel library, with argument types set."""
    lib = _LOADED.get(kind)
    if lib is not None:
        return lib
    lib = ctypes.CDLL(str(library_path(kind)))
    from judo_tpu_torch.physics.fused_rollout import JtSizes

    p = ctypes.c_void_p
    lib.jt_scratch_per_lane.argtypes = [ctypes.POINTER(JtSizes)]
    lib.jt_scratch_per_lane.restype = ctypes.c_longlong
    lib.jt_jslab_per_lane.argtypes = [ctypes.POINTER(JtSizes)]
    lib.jt_jslab_per_lane.restype = ctypes.c_longlong
    lib.jt_model_sizes.argtypes = [ctypes.POINTER(JtSizes), ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.jt_model_sizes.restype = None
    for name in ("jt_fused_rollout_f32", "jt_fused_rollout_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(JtSizes)] + [p] * 12
        fn.restype = ctypes.c_int
    lib.jt_policy_scratch_per_lane.argtypes = [ctypes.POINTER(JtSizes), ctypes.c_int]
    lib.jt_policy_scratch_per_lane.restype = ctypes.c_longlong
    for name in ("jt_fused_policy_rollout_f32", "jt_fused_policy_rollout_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(JtSizes)] + [p] * 13 + [ctypes.c_int, p]
        fn.restype = ctypes.c_int
    if kind == "cuda":
        i, pi = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
        lib.jt_smem_optin.argtypes = [pi]
        lib.jt_rollout_blocks_per_sm.argtypes = [i, i, i, i, pi]
        lib.jt_policy_blocks_per_sm.argtypes = [i, i, i, pi]
        for fn in (lib.jt_smem_optin, lib.jt_rollout_blocks_per_sm, lib.jt_policy_blocks_per_sm):
            fn.restype = ctypes.c_int
    if kind == "host":
        lib.jt_pair_contacts_f64.argtypes = [ctypes.c_int] + [p] * 9
        lib.jt_pair_contacts_f64.restype = ctypes.c_int
    lib.jt_error_string.argtypes = [ctypes.c_int]
    lib.jt_error_string.restype = ctypes.c_char_p
    _LOADED[kind] = lib
    return lib


def build_log(kind: str) -> str:
    """The compiler output of the current build of ``kind``."""
    log = library_path(kind).parent / "build.log"
    return log.read_text() if log.exists() else ""
