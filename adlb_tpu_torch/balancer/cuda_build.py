"""Building the port's CUDA sources (``adlb_tpu_torch/csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, named by the source's content hash, in the git-ignored
``adlb_tpu_torch/_build/``; the kernel modules load it with ``ctypes``.
:func:`build_all` starts one ``nvcc`` per source that is not built yet, all
at once, and waits for them; nothing is built when a module is imported.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Sequence

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

#: the compiler's output (-Xptxas -v) of each library built by this process
logs: Dict[Path, str] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the port's CUDA kernels cannot "
                           "be built (CUDA toolkit missing)")
    return nvcc


def library_path(source: Path) -> Path:
    """Where ``source`` builds to: one library per source revision."""
    digest = hashlib.sha1(source.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def build_all(sources: Sequence[Path]) -> List[Path]:
    """Compile every source not built yet, one ``nvcc`` each, all started
    together; returns the libraries' paths in the order of ``sources``.
    Raises with the compiler's output when a build fails."""
    jobs = []
    for src in sources:
        out = library_path(src)
        if out.exists():
            jobs.append((src, out, None, None))
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp, str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, out, tmp, proc))
    failed = []
    for src, out, tmp, proc in jobs:
        if proc is None:
            continue
        log = proc.communicate()[0]
        logs[out] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({proc.returncode}) building {src}:\n"
                          f"{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return [out for _, out, _, _ in jobs]
