"""Fixtures of the benchmark's CPU tests: a checkout at a tiny size.

``tiny_checkout`` copies BENCHMARK.json and the benchmark's data files
into a temporary checkout and shrinks each configuration and mix (frames,
window, geometry, keyframes), so the whole harness runs on the CPU with
the port's plain twins.  The code stays the package's own.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

SP = dict(width=192, height=128)
MSV1 = dict(width=64, height=48)
T, W = 24, 16


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where "
        "torch.cuda.is_available() is False")


def make_tiny(dst: str) -> str:
    os.makedirs(dst, exist_ok=True)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    shutil.copytree(PKG, os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    root = os.path.join(dst, "portbench")
    for name in os.listdir(os.path.join(root, "configs")):
        p = os.path.join(root, "configs", name)
        with open(p) as f:
            c = json.load(f)
        c.update(SP if c["codec"] == "sp4" else MSV1, frames=T)
        c["ingest"]["window"] = W
        with open(p, "w") as f:
            json.dump(c, f)
    for name in os.listdir(os.path.join(root, "traffic")):
        p = os.path.join(root, "traffic", name)
        with open(p) as f:
            t = json.load(f)
        if t["recipe"] == "video_call":
            t["recipe_params"] = dict(vw=96, vh=48)
        if "period" in t:
            t["period"] = 8
        else:
            t["keyframes"] = [0, 10]
        if "lane" in t:
            t["lane"]["window"] = W
        with open(p, "w") as f:
            json.dump(t, f)
    return dst


@pytest.fixture(scope="session")
def tiny_checkout(tmp_path_factory):
    return make_tiny(str(tmp_path_factory.mktemp("checkout")))


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided here, at run
    time, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False")
    return "cuda:0"
