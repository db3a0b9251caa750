"""The ds2 experiment kernels: csrc/ds_probe.cu behind one wrapper.

``ds_probe(frames, mode, BH)`` runs one mode of the kernel on a [C, Y, X]
stack of int32 bit-view frames, one launch for all C.  The modes replace
the Pallas kernels of scripts/exp_pallas_ds.py, exp_pallas_ds2.py and
exp_pallas_bisect.py; their plain twins, output shapes and the scripts'
names for them are in experiments/probes.py.  Tensors on the CPU take the
twin; tensors on the card launch the kernel or raise.  The row modes
(passthru, hpair_i32, wpair_i32) take a 16-byte instance where the views
allow it and a 4-byte one elsewhere: ``ds_probe.by_instance`` /
``.last_instance`` say which ran.
"""

from __future__ import annotations

import collections

import torch

from .. import _build
from ..device import cuda_launch_checks
from ..experiments.probes import MODES, probe_ref, probe_shape


def ds_probe(frames: torch.Tensor, mode: str, BH: int = 128,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """[C, Y, X] int32 bit views → the `mode` plane stack of
    probes.probe_shape (allocated unless `out` is given: it may be a
    strided view whose [Ho, Wo] rows are contiguous).  BH is the Pallas
    block height (a multiple of 4); rows past Y of the last block read 0."""
    if mode not in MODES:
        raise ValueError(f"ds_probe: unknown mode {mode!r} "
                         f"(one of {sorted(MODES)})")
    if frames.dim() != 3:
        raise ValueError(f"ds_probe: frames must be [C, Y, X], got "
                         f"{tuple(frames.shape)}")
    if BH <= 0 or BH % 4:
        raise ValueError(f"ds_probe: BH must be a positive multiple of 4, "
                         f"got {BH}")
    C, Y, X = frames.shape
    shape = probe_shape(mode, C, Y, X, BH)
    if out is not None and tuple(out.shape) != shape:
        raise ValueError(f"ds_probe: out must be {list(shape)}, got "
                         f"{tuple(out.shape)}")
    if frames.device.type == "cpu":
        res = probe_ref(frames, mode, BH)
        return res if out is None else out.copy_(res)
    if mode == "bitcast_fold" and X % 2:
        raise ValueError("ds_probe: bitcast_fold needs an even width")
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=frames.device)
    cuda_launch_checks("ds_probe", frames, out)
    Ho, Wo = shape[1:]
    if frames.stride(-1) != 1 or frames.stride(-2) != X:
        raise ValueError("ds_probe: frames must be row-contiguous [C, Y, X]")
    if out.stride(-1) != 1 or out.stride(-2) != max(Wo, 1):  # [.., 0]: 1
        raise ValueError("ds_probe: out must be row-contiguous [C, Ho, Wo]")
    if C and Y and X and Ho and Wo:
        lib = _build.load()
        instance = lib.jsp_ds_probe_instance(
            MODES[mode][0], frames.data_ptr(), frames.stride(0),
            out.data_ptr(), out.stride(0), X, Wo)
        with torch.cuda.device(frames.device):
            rc = lib.jsp_ds_probe(
                MODES[mode][0], frames.data_ptr(), frames.stride(0),
                out.data_ptr(), out.stride(0), C, Y, X, BH, Ho, Wo,
                torch.cuda.current_stream(frames.device).cuda_stream)
        _build.check(rc, f"ds_probe[{mode}]")
        ds_probe.launches += 1
        ds_probe.by_mode[mode] += 1
        if instance >= 0:
            ds_probe.by_instance[mode][PROBE_INSTANCES[instance]] += 1
            ds_probe.last_instance = PROBE_INSTANCES[instance]
    return out


#: the instances of a mode that has two (the row modes), by
#: jsp_ds_probe_instance's answer: 4-byte units, or 16-byte units
PROBE_INSTANCES = ("scalar", "vec")
ds_probe.launches = 0  # kernel launches (the plain path does not count)
ds_probe.by_mode = collections.Counter()  # the same, per mode
# mode → its launches per instance, for the modes that have two; and the
# instance of the last launch of such a mode
ds_probe.by_instance = collections.defaultdict(collections.Counter)
ds_probe.last_instance = None
