"""A cell's inputs, made from the run's seed by the benchmark's own code.

The traffic file names a content recipe (``recipes/<recipe>.py``) and a
pool of content seeds; the configuration names the codec (a module of
``encode/``), the geometry and the batch.  Every seed gets the same pool
of distinct streams, so every seed asks the same work of the program: the
run's seed draws their order, a permutation of the pool over the batch's
slots (slot b holds pool stream b % len(pool) before it).  Content drawn
from the run's seed itself moved the work with the seed: rotating each
stream's timeline by a drawn offset spread delivered frames/s over
13-18% between seeds on the card.

A traffic with ``"period"`` draws that many frames a stream and repeats
their chunks to the configuration's length (keyframes at the period's
``keyframes``).  ``"container": "lane"`` hands each encoded AVI to the
port's own transcoder (the deployment's step, so it is the port's and not
a frozen copy) with the traffic's ``lane`` arguments.
"""

from __future__ import annotations

import importlib
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from .encode.avi_mux import mux_avi


@dataclass
class Inputs:
    """containers[b]: slot b's bytes as the pipeline reads them; frames[b]:
    slot b's source frames [T, Y, X] u32 (slots of one pool stream share
    the array); coded[b]: slot b's coded bytes a frame [T] (an AVI's
    chunk sizes; a lane container's size spread evenly over its frames)."""

    containers: list
    frames: list
    coded: list
    pool: list  # slot b -> pool index
    seconds: dict  # what making them took, by step


def _pool_stream(cell, content_seed: int):
    """One distinct stream → (AVI bytes, source frames [T, Y, X] u32, chunk
    sizes [T], (recipe seconds, encode and mux seconds))."""
    cfg, traffic = cell.config, cell.traffic
    codec = importlib.import_module(f"{__package__}.encode.{cfg['codec']}")
    recipe = cell.bench.module("recipes", traffic["recipe"])
    T, Y, X = cfg["frames"], cfg["height"], cfg["width"]
    period = traffic.get("period") or T
    keys = set(traffic["keyframes"])
    t0 = time.perf_counter()
    src = recipe.frames(content_seed, period, Y, X,
                        **traffic.get("recipe_params", {}))
    t1 = time.perf_counter()
    chunks = codec.encode(src, [t in keys for t in range(period)])
    reps = -(-T // period)
    chunks = (chunks * reps)[:T]
    frames = np.concatenate([src] * reps)[:T] if reps > 1 else src
    avi = mux_avi(chunks, X, Y, codec.BPP, codec=codec.FOURCC,
                  keyflags=[t % period in keys for t in range(T)])
    t2 = time.perf_counter()
    return avi, frames, np.array([len(c) for c in chunks]), (t1 - t0, t2 - t1)


def make_inputs(cell, seed: int, workers: int = 4) -> Inputs:
    """The cell's inputs for `seed` (the same seed, the same bytes)."""
    cfg, traffic = cell.config, cell.traffic
    rng = np.random.default_rng(seed)
    pool = list(traffic["pool_seeds"])
    T = cfg["frames"]
    slots = [int(p) for p in rng.permutation(
        [b % len(pool) for b in range(cfg["streams"])])]
    cell.bench.module("recipes", traffic["recipe"])  # loaded before threads
    with ThreadPoolExecutor(min(workers, len(pool))) as ex:
        made = list(ex.map(lambda c: _pool_stream(cell, c), pool))
    seconds = {"recipe": sum(m[3][0] for m in made),
               "encode": sum(m[3][1] for m in made)}
    avis = [m[0] for m in made]
    coded = [m[2] for m in made]
    if traffic.get("container", "avi") == "lane":
        from jsplayer_tpu_torch import transcode_to_lane

        lane = traffic["lane"]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(min(workers, len(pool))) as ex:
            avis = list(ex.map(lambda a: transcode_to_lane(a, **lane), avis))
        seconds["transcode"] = time.perf_counter() - t0
        coded = [np.full(T, len(a) / T) for a in avis]
    return Inputs(containers=[avis[p] for p in slots],
                  frames=[made[p][1] for p in slots],
                  coded=[coded[p] for p in slots], pool=slots,
                  seconds=seconds)
