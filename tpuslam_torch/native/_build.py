"""Build the native libraries with the Makefile beside their sources.

Each output goes to `tpuslam_torch/build/native/` (git-ignored), named by a
hash of the sources and the Makefile, so an edited source is never served by
a stale build. `make` writes into a fresh temporary directory and the result
is renamed into place, so processes that build at once never load a
half-written file. Nothing is built at import.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "build" / "native"
_INPUTS = ("Makefile", "od4codec.cpp", "od4recv.cpp", "od4recv_tsan_test.cpp")


def output_path(target: str) -> Path:
    """Where Makefile target `target` (a file name under OUT) lands."""
    h = hashlib.sha256()
    for name in _INPUTS:
        h.update((SRC_DIR / name).read_bytes())
    stem, dot, ext = target.partition(".")
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}{dot}{ext}"


def build(target: str, timeout_s: float = 180.0) -> Path:
    """The path of `target`, built first if it is missing. Raises
    RuntimeError with the compiler's output when the build fails (no
    `make`, no g++, no ThreadSanitizer runtime)."""
    out = output_path(target)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=".make-", dir=BUILD_DIR))
    try:
        r = subprocess.run(["make", "-C", str(SRC_DIR), f"OUT={tmp}", str(tmp / target)],
                           capture_output=True, text=True, timeout=timeout_s)
        if r.returncode != 0:
            raise RuntimeError(f"make {target} failed ({r.returncode}): {r.stderr[-2000:]}")
        os.replace(tmp / target, out)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"make {target}: {e}") from e
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out
