"""Find a cell's files by the names in BENCHMARK.json.

A checkout holds ``BENCHMARK.json`` and the benchmark's folder (its
``paths[0]``).  Everything that belongs to one configuration, traffic mix,
span list, counter list or per-layer metric sits in a file of its own
there, found by name:

  configs/<config>.json    the deployment (the path BENCHMARK.json gives);
                           an optional ``audio``: {"format": <module of
                           encode/>, ...} gives every stream a track
  traffic/<traffic>.json   the mix: recipe, pool, keyframes, container,
                           IngestConfig fields
  recipes/<recipe>.py      a content generator: frames(seed, n, Y, X, ...)
  encode/<codec>.py        a codec: FOURCC, BPP, encode(frames, keys); an
                           optional PALETTE (256 u32 0x00RRGGBB) makes the
                           recipe's frames palette indices, the palette
                           the container's and PALETTE[indices] the source
  encode/<format>.py       an audio format: track(seed, video_frames, fps,
                           ...) and wave_format(...) (mp3.py)
  spans/<set>.json         port functions to time, by module and name
  counters/<set>.json      port wrappers whose ``.launches`` to read
  metrics/<metric>.py      read(ctx) -> the metric's value, or None
  references/<ref>.py      a configuration's plain reference; with audio
                           it has ``audio_frames_wrong`` in LIMITS and a
                           ``control_audio`` (ds2_frames_mp3.py), or the
                           cell is refused when it loads

So a later change adds a cell, a configuration, a mix, a span list or a
metric by adding files and entries, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(PKG_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    bench: "Bench"

    def ingest_fields(self) -> dict:
        """The IngestConfig fields: the configuration's, then the mix's."""
        return {**self.config.get("ingest", {}),
                **self.traffic.get("ingest", {})}


class Bench:
    """BENCHMARK.json of a checkout and the files under its folder."""

    def __init__(self, checkout: str = CHECKOUT):
        self.checkout = checkout
        with open(os.path.join(checkout, "BENCHMARK.json")) as f:
            self.spec = json.load(f)
        self.root = os.path.join(checkout, self.spec["paths"][0])
        self._modules: dict = {}

    def path(self, kind: str, name: str, ext: str) -> str:
        return os.path.join(self.root, kind, f"{name}{ext}")

    def data(self, kind: str, name: str) -> dict:
        with open(self.path(kind, name, ".json")) as f:
            return json.load(f)

    def names(self, kind: str) -> list:
        """The names of the files of `kind` (sorted, extension dropped)."""
        d = os.path.join(self.root, kind)
        return sorted(os.path.splitext(f)[0] for f in os.listdir(d)
                      if not f.startswith((".", "_")))

    def module(self, kind: str, name: str):
        """<kind>/<name>.py loaded by its path (the files stand alone)."""
        key = (kind, name)
        if key not in self._modules:
            path = self.path(kind, name, ".py")
            mod_name = "portbench_{}_{}".format(
                kind, "".join(c if c.isalnum() else "_" for c in name))
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def cell(self, name: str) -> Cell:
        ws = [w for w in self.spec["workloads"] if w["name"] == name]
        if not ws:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                           f"{[w['name'] for w in self.spec['workloads']]})")
        w = ws[0]
        cfg_entry = next(c for c in self.spec["configs"]
                         if c["name"] == w["config"])
        with open(os.path.join(self.checkout, cfg_entry["file"])) as f:
            config = json.load(f)
        if config.get("audio"):
            ref = self.module("references", config["reference"])
            if ("audio_frames_wrong" not in ref.LIMITS
                    or not hasattr(ref, "control_audio")):
                raise ValueError(
                    f"{name}: configuration {cfg_entry['name']} has audio, "
                    f"but references/{config['reference']}.py judges none "
                    f"(no audio_frames_wrong in LIMITS, or no "
                    f"control_audio): the track would go unjudged")
        return Cell(name=name, chips=int(w["chips"]), config=config,
                    traffic=self.data("traffic", w["traffic"]), bench=self)

    def metrics(self, cell: str, kind: str) -> list:
        """The `kind` ("end_to_end" or "per_layer") entries that `cell`
        reports: those that list it, and those that list no cells."""
        return [m for m in self.spec[kind]
                if cell in m.get("workloads", [cell])]
