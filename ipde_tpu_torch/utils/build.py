"""Build a native source into a shared library under ``build/ipde_tpu_torch/``.

The library name carries a hash of the source and of the compile command,
so an edited source or flag set builds anew and a stale library is never
loaded.  The compiler writes to a temporary name that is renamed into place,
so processes that build the same library at once never load a partial file.
A missing compiler or a failed build raises.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ipde_tpu_torch"


def host_cpu() -> str:
    """The host CPU's model and feature flags: keys libraries built for
    ``-march=native``, so a checkout copied to another machine builds anew."""
    found = {}
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                name = line.split(":")[0].strip()
                if name in ("model name", "flags"):
                    found.setdefault(name, line.strip())
    except OSError:
        pass
    return "\n".join(found.values()) or platform.processor()


def build_shared(source: Path, compiler: Sequence[str], stem: str,
                 key_extra: str = "") -> Path:
    """Compile ``source`` with ``compiler + [source, -o, lib]``; return the
    path of ``lib``, reusing it when it was already built."""
    cmd = [str(c) for c in compiler]
    key = hashlib.sha256(Path(source).read_bytes()
                         + "\0".join(cmd + [key_extra]).encode()
                         ).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{stem}-{key}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(cmd + [str(source), "-o", tmp],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {source} failed "
                               f"({' '.join(cmd)}):\n{res.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib
