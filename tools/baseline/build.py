"""Build the C++ baseline binary from ``sid_baseline.cpp``.

    python tools/baseline/build.py

``ensure_built()`` is what every user of the binary calls (``bench.py``,
``chip_smoke.py``, the differential tests): it rebuilds when the binary is
missing or older than its source, and returns the binary's path.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "sid_baseline.cpp")
EXE = os.path.join(HERE, "sid_baseline")


def ensure_built() -> str:
    if os.path.exists(EXE) and os.path.getmtime(EXE) >= os.path.getmtime(SRC):
        return EXE
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: cannot build tools/baseline/sid_baseline")
    # build beside the target and rename, so a concurrent user never runs a
    # half-written binary
    fd, tmp = tempfile.mkstemp(dir=HERE, prefix=".sid_baseline.")
    os.close(fd)
    try:
        subprocess.run([gxx, "-O2", "-fopenmp", "-o", tmp, SRC, "-lm"], check=True)
        os.chmod(tmp, 0o755)
        os.replace(tmp, EXE)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return EXE


if __name__ == "__main__":
    print(ensure_built())
