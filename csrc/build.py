"""Build the native host library: g++ -O2 -shared -> sba_native.so.

Usage: python csrc/build.py   (idempotent; skips if up to date)
"""

import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "sba_native.cpp")
OUT = os.path.join(HERE, "sba_native.so")


def build(force=False):
    """Compile to a temporary file beside OUT, then rename it into place:
    concurrent builds (e.g. from parallel test workers) never load a
    half-written library."""
    if (
        not force
        and os.path.exists(OUT)
        and os.path.getmtime(OUT) >= os.path.getmtime(SRC)
    ):
        return OUT
    fd, tmp = tempfile.mkstemp(prefix=".sba_native.", suffix=".so", dir=HERE)
    os.close(fd)
    cmd = [
        "g++",
        "-O2",
        "-std=c++17",
        "-shared",
        "-fPIC",
        SRC,
        "-o",
        tmp,
        "-lpng",
        "-ljpeg",
        "-lz",
        "-lpthread",
    ]
    try:
        subprocess.run(cmd, check=True)
        os.replace(tmp, OUT)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return OUT


if __name__ == "__main__":
    print(build(force="--force" in sys.argv))
