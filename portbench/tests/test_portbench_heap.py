"""run.py keeps the heap the port frees: glibc takes both thresholds, in
a process of its own so that the test process keeps glibc's defaults."""

from __future__ import annotations

import platform
import subprocess
import sys

import pytest

from portbench.spec import CHECKOUT


@pytest.mark.skipif(platform.libc_ver()[0] != "glibc", reason="glibc only")
def test_glibc_takes_both_thresholds():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from portbench.run import keep_freed_heap; "
            "print(keep_freed_heap())")
    out = subprocess.run([sys.executable, "-c", code, CHECKOUT],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "True"
