"""The run's no-JAX check compares whole top-level names."""

from __future__ import annotations

import ast
import glob
import os

from portbench.nojax import forbidden
from portbench.spec import PKG_DIR


def test_whole_names():
    assert forbidden(["jsplayer_tpu_torch", "jsplayer_tpu_torch.native",
                      "jaxtyping", "flaxen", "numpy", "torch"]) == []
    assert forbidden(["jsplayer_tpu.codecs", "numpy"]) == ["jsplayer_tpu"]
    assert forbidden(["jax", "jax.numpy", "jaxlib.xla_client",
                      "flax.linen"]) == ["flax", "jax", "jaxlib"]


def test_no_file_imports_jax_or_the_jax_package():
    """No file of the benchmark imports JAX or the JAX package, and the
    reference imports nothing of the port."""
    for path in glob.glob(os.path.join(PKG_DIR, "**", "*.py"),
                          recursive=True):
        if os.sep + "tests" + os.sep in path:
            continue
        with open(path) as f:
            tree = ast.parse(f.read())
        tops = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and not node.level:
                tops.add(node.module.split(".")[0])
        assert forbidden(tops) == [], path
        if os.sep + "references" + os.sep in path:
            assert "jsplayer_tpu_torch" not in tops, path
