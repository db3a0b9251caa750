"""ScreenPressor kmv frame reconstruction — the port's device stage.

Counterpart of the kmv part of jsplayer_tpu/kernels/sp_recon.py.  The host
(native decoder or numpy oracle) emits the kmv transport per frame: a u32
paycode plane packing pixel (24b) | type (2b: 0 copy, 1 data, 2 motion) |
k-slot (3b), and K distinct motion vectors.  The device composes each
P-frame from the previous one:

    out[y,x] = paycode & 0xFFFFFF             if type == 1
             = prev[(y+my_k) % Y, (x+mx_k) % X] if type == 2, slot k < K
             = prev[y,x]                       otherwise

``kmv_compose`` is that step for all B streams of a batch in ONE launch of
csrc/kmv_compose.cu (tensors on the card) or its plain twin
``kmv_compose_ref`` (torch.roll + where, tensors on the CPU).  The JAX
scan (`lax.scan`, unrolled over B because vmapped rolls gather on a TPU)
becomes a Python loop over frames; per-stream shifts are index arithmetic
inside the kernel.  ``kmv_compose_ds2`` is the same step fused with the
packed ds2 plane of its output (the in-scan ds2 experiment,
experiments/exp_model_fusion2.py); the ingest scan does not use it.

The bc transport has the same pixel rule with the block structure in two
small per-block arrays (bcode, rloc) and a plane that holds only data-rect
pixels: ``bc_compose`` is its step (csrc/bc_compose.cu, twin
``bc_compose_ref``).  The kmv_sparse transport keeps whole-block motion
codes per block and ships the rest as final-content 16x16 tiles:
``kmv_sparse_compose`` (csrc/kmv_sparse.cu, twin
``kmv_sparse_compose_ref``) composes a step for all B streams from one flat
tile array read through a per-stream index.

The general block-command compose (``compose_frame``, the per-pixel
gather of the reference's ``decode_sequence``/``decode_batch``) is mode
"general" of csrc/sp_motion.cu behind ``sp_compose_general``; the same
kernel's other modes serve sp_motion_pallas.py and sp_motion_mxu.py, whose
wrappers share ``launch_block_kernel`` below.

The numpy host helpers at the end are copies of the JAX module's (that
module imports jax at the top, which the port never does); tests pin each
copy against the original.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import _build
from ..device import cuda_launch_checks
from .rgb_convert import ds2_pack, ds2_pack_ref, to_model_input, unpack_ds2


# ---------------------------------------------------------------------------
# The compose step
# ---------------------------------------------------------------------------

def compose_frame_kmv_ref(prev: torch.Tensor, paycode: torch.Tensor,
                          mvk: torch.Tensor) -> torch.Tensor:
    """Plain twin of one frame's compose: prev/paycode [Y, X] int32 bit
    views, mvk [K, 2] (mx, my) → [Y, X].  The reference's ops one for one:
    jnp.roll wraps, and so does torch.roll."""
    ptype = (paycode >> 24) & 3
    out = torch.where(ptype == 1, paycode & 0x00FFFFFF, prev)
    kslot = (paycode >> 26) & 7
    is_motion = ptype == 2
    for k, (mx, my) in enumerate(mvk.tolist()):
        shifted = torch.roll(prev, shifts=(-my, -mx), dims=(0, 1))
        out = torch.where(is_motion & (kslot == k), shifted, out)
    return out


def per_stream_ref(frame_ref, prev, changed, *per_stream) -> torch.Tensor:
    """A batched step's plain twin from its one-frame twin: stream b is
    frame_ref(prev[b], *(a[b] for a in per_stream)) where changed[b], a
    copy of prev[b] elsewhere → [B, Y, X]."""
    outs = [frame_ref(prev[b], *(a[b] for a in per_stream))
            if bool(changed[b]) else prev[b].clone()
            for b in range(prev.shape[0])]
    return torch.stack(outs) if outs else prev.clone()


def kmv_compose_ref(prev, paycode, mvk, changed) -> torch.Tensor:
    """Plain twin of the batched step: prev/paycode [B, Y, X], mvk
    [B, K, 2], changed [B] bool → [B, Y, X] (unchanged streams copy
    prev)."""
    return per_stream_ref(compose_frame_kmv_ref, prev, changed, paycode, mvk)


def cpu_result(res: torch.Tensor, out) -> torch.Tensor:
    """A wrapper's CPU branch: the plain twin's result, copied into `out`
    when one was given."""
    if out is None:
        return res
    out.copy_(res)
    return out


def _planes_overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether any [Y, X] plane of a shares bytes with any plane of b
    (both [B, Y, X], row-contiguous)."""
    if a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr():
        return False
    n = a.shape[-2] * a.shape[-1] * a.element_size()
    sa = [a.data_ptr() + i * a.stride(0) * a.element_size()
          for i in range(a.shape[0])]
    sb = [b.data_ptr() + i * b.stride(0) * b.element_size()
          for i in range(b.shape[0])]
    return any(x < y + n and y < x + n for x in sa for y in sb)


def step_checks(what, prev, mvk, changed, out, planes=()) -> None:
    """The CUDA branch's checks of a compose step's frame arguments: prev,
    out and each (name, plane) of `planes` row-contiguous int32 [B, Y, X]
    on one card, mvk [B, K, 2] with contiguous [K, 2], changed [B] bool,
    out apart from prev."""
    cuda_launch_checks(what, prev, mvk, out, *(t for _, t in planes))
    if changed.device != prev.device or changed.dtype != torch.bool:
        raise TypeError(f"{what}: changed must be a bool tensor on the "
                        f"frames' device")
    B, Y, X = prev.shape
    K = mvk.shape[-2]
    for name, t in (("prev", prev), *planes, ("out", out)):
        if t.shape != (B, Y, X) or t.stride(-1) != 1 or t.stride(-2) != X:
            raise ValueError(f"{what}: {name} must be row-contiguous "
                             f"[{B}, {Y}, {X}], got {tuple(t.shape)} "
                             f"strides {t.stride()}")
    # an empty [B, 0, 2] has no layout to check: the kernel reads no slot
    if mvk.shape != (B, K, 2) or K and (mvk.stride(-1) != 1
                                        or mvk.stride(-2) != 2):
        raise ValueError(f"{what}: mvk must be [B, K, 2] with "
                         f"contiguous [K, 2], got {tuple(mvk.shape)}")
    if changed.shape != (B,):
        raise ValueError(f"{what}: changed must be [B]")
    if _planes_overlap(out, prev):
        raise ValueError(f"{what}: out must not alias prev (shifted "
                         f"reads would see written pixels)")


def block_code_checks(what, prev, bcode, rloc) -> None:
    """The CUDA branch's checks of per-block codes [B, NB] u8 and block-
    local rects [B, NB, 4] u8 (contiguous rows) for frames prev [B, Y, X]."""
    B, Y, X = prev.shape
    nb = math.prod(block_grid(Y, X))
    for name, t, tail in (("bcode", bcode, ()), ("rloc", rloc, (4,))):
        if t.device != prev.device or t.dtype != torch.uint8:
            raise TypeError(f"{what}: {name} must be a uint8 tensor on "
                            f"the frames' device, got {t.dtype} on "
                            f"{t.device}")
        if tuple(t.shape) != (B, nb) + tail or t.stride(-1) != 1 or (
                tail and t.stride(-2) != 4):
            raise ValueError(f"{what}: {name} must be "
                             f"{[B, nb, *tail]} with contiguous rows, got "
                             f"{tuple(t.shape)} strides {t.stride()}")


def _kmv_launch_args(what, prev, paycode, mvk, changed, out,
                     pix_name="paycode") -> list:
    """step_checks for kmv_compose, kmv_compose_ds2 and bc_compose (whose
    pixel plane, `pix_name`, is the bc plane) → the (pointer, batch stride)
    arguments prev, paycode, mvk, changed, out of their entry points."""
    step_checks(what, prev, mvk, changed, out, [(pix_name, paycode)])
    args = []
    for t in (prev, paycode, mvk, changed, out):
        args += [t.data_ptr(), t.stride(0)]
    return args


def kmv_compose(prev: torch.Tensor, paycode: torch.Tensor, mvk: torch.Tensor,
                changed: torch.Tensor, out: torch.Tensor | None = None
                ) -> torch.Tensor:
    """One kmv scan step for every stream of a batch: prev/paycode
    [B, Y, X] int32 bit views, mvk [B, K, 2] int32, changed [B] bool →
    out [B, Y, X] (allocated unless given; it must not alias prev).

    CUDA kernel csrc/kmv_compose.cu for tensors on the card — one launch
    for all B streams; the plain twin only for tensors on the CPU.  Each
    argument may be a strided view (e.g. paycode[:, t] of a [B, T, Y, X]
    window) as long as its [Y, X] rows are contiguous."""
    if prev.device.type == "cpu":
        return cpu_result(kmv_compose_ref(prev, paycode, mvk, changed), out)
    if out is None:
        out = torch.empty_like(prev, memory_format=torch.contiguous_format)
    args = _kmv_launch_args("kmv_compose", prev, paycode, mvk, changed, out)
    B, Y, X = prev.shape
    if B and Y and X:
        lib = _build.load()
        with torch.cuda.device(prev.device):
            rc = lib.jsp_kmv_compose(
                *args, B, Y, X, mvk.shape[-2],
                torch.cuda.current_stream(prev.device).cuda_stream)
        _build.check(rc, "kmv_compose")
        kmv_compose.launches += 1
    return out


kmv_compose.launches = 0  # kernel launches (the plain path does not count)


def kmv_compose_ds2_ref(prev, paycode, mvk, changed
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the fused step: kmv_compose_ref, then the unflipped
    packed ds2 plane of its output → (out [B, Y, X], red [B, Y//2, X//2])."""
    out = kmv_compose_ref(prev, paycode, mvk, changed)
    return out, ds2_pack_ref(out, flip=False)


def kmv_compose_ds2(prev: torch.Tensor, paycode: torch.Tensor,
                    mvk: torch.Tensor, changed: torch.Tensor,
                    out: torch.Tensor | None = None,
                    red: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """kmv_compose and ds2_pack(flip=False) of its output in ONE launch:
    the arguments of kmv_compose, plus red [B, Y//2, X//2] int32 (allocated
    unless given; a strided view with contiguous rows is fine) → (out,
    red).  An odd last row or column is composed and dropped from red.

    The kDs2 instance of csrc/kmv_compose.cu for tensors on the card; the
    plain twin only for tensors on the CPU.  It replaces the in-scan Pallas
    ds2 of scripts/exp_model_fusion2.py (variant E1); the ingest scan does
    not use it."""
    if prev.device.type == "cpu":
        o, r = kmv_compose_ds2_ref(prev, paycode, mvk, changed)
        return cpu_result(o, out), cpu_result(r, red)
    B, Y, X = prev.shape
    if out is None:
        out = torch.empty_like(prev, memory_format=torch.contiguous_format)
    if red is None:
        red = torch.empty((B, Y // 2, X // 2), dtype=torch.int32,
                          device=prev.device)
    args = _kmv_launch_args("kmv_compose_ds2", prev, paycode, mvk, changed,
                            out)
    cuda_launch_checks("kmv_compose_ds2", prev, red)
    Wo = X // 2
    # an empty [.., Ho, 0] plane has row stride 1
    if red.shape != (B, Y // 2, Wo) or red.stride(-1) != 1 or (
            red.stride(-2) != max(Wo, 1)):
        raise ValueError(f"kmv_compose_ds2: red must be row-contiguous "
                         f"[{B}, {Y // 2}, {Wo}], got {tuple(red.shape)} "
                         f"strides {red.stride()}")
    if B and Y and X:
        lib = _build.load()
        with torch.cuda.device(prev.device):
            rc = lib.jsp_kmv_compose_ds2(
                *args, red.data_ptr(), red.stride(0), B, Y, X, mvk.shape[-2],
                torch.cuda.current_stream(prev.device).cuda_stream)
        _build.check(rc, "kmv_compose_ds2")
        kmv_compose_ds2.launches += 1
    return out, red


kmv_compose_ds2.launches = 0  # kernel launches (the plain path does not count)


def compose_frame_kmv(prev, paycode, mvk):
    """Single-frame compose, the reference's signature: prev/paycode
    [Y, X], mvk [K, 2] → [Y, X]."""
    chg = torch.ones(1, dtype=torch.bool, device=prev.device)
    return kmv_compose(prev[None], paycode[None], mvk[None], chg)[0]


# ---------------------------------------------------------------------------
# Scans
# ---------------------------------------------------------------------------

def scan_steps(step, init_frames, per_step, changed):
    """The P-frame scan over a batch: init [B,Y,X], per_step a tuple of
    [B,T,...] inputs, changed [B,T] → frames [B,T,Y,X].  Step t calls
    step(prev, *(a[:, t] for a in per_step), changed[:, t],
    out=frames[:, t]) with prev = frames[:, t-1]: one launch per step over
    all B, written straight into the stack through its batch stride."""
    B, T = changed.shape
    frames = torch.empty((B, T) + tuple(init_frames.shape[1:]),
                         dtype=init_frames.dtype, device=init_frames.device)
    prev = init_frames
    for t in range(T):
        step(prev, *(a[:, t] for a in per_step), changed[:, t],
             out=frames[:, t])
        prev = frames[:, t]
    return frames


def decode_batch_kmv(init_frames, paycode, mvk, changed):
    """Batched kmv scan: init [B,Y,X], paycode [B,T,Y,X], mvk [B,T,K,2],
    changed [B,T] → frames [B,T,Y,X]."""
    return scan_steps(kmv_compose, init_frames, (paycode, mvk), changed)


def decode_sequence_kmv(init_frame, paycode, mvk, changed):
    """One stream: init [Y,X], paycode [T,Y,X], mvk [T,K,2], changed [T]
    → frames [T,Y,X]."""
    return decode_batch_kmv(init_frame[None], paycode[None], mvk[None],
                            changed[None])[0]


def decode_sequence_kmv_compact(init_frame, paycode, mvk):
    """kmv scan over changed frames only (every input frame composes)."""
    chg = torch.ones(paycode.shape[0], dtype=torch.bool,
                     device=paycode.device)
    return decode_sequence_kmv(init_frame, paycode, mvk, chg)


def _model_emit(model_kw):
    """(per-step emit fn, post-scan finish fn) for the fused model path.

    downscale == 2 rides the packed plane: each step emits ONE packed
    [H/2, W/2] i32 plane (the ds2 kernel, with the row flip folded into
    its stores) and the unpack/normalize/NHWC runs once on the small stack
    after the scan.  Other downscale factors emit to_model_input per step."""
    kw = dict(model_kw)
    packed = kw.pop("packed", False)
    if kw.get("downscale") == 2:
        kw.pop("downscale")
        flip = kw.pop("flip_vertical", True)

        def emit(out):
            return ds2_pack(out, flip=flip)

        if packed:  # the packed plane IS the product
            return emit, (lambda red: red)
        return emit, (lambda red: unpack_ds2(red, flip_vertical=False, **kw))
    if packed:
        raise ValueError("model_packed requires downscale == 2")
    return (lambda out: to_model_input(out, **kw)), (lambda m: m)


def _scan_model(step, init_frames, per_step, changed, model_kw):
    """The model-only scan of a step (kmv_compose or bc_compose) over
    per_step [B,T,...] inputs: frames live in two ping-pong buffers (the
    full-res stack is never written); each step's emit is kept."""
    emit, finish = _model_emit(model_kw)
    B, T = changed.shape
    if T == 0:
        raise ValueError("model scan over zero frames")
    bufs = (torch.empty_like(init_frames, memory_format=torch.contiguous_format),
            torch.empty_like(init_frames, memory_format=torch.contiguous_format))
    prev, ys = init_frames, []
    for t in range(T):
        out = bufs[t % 2]
        step(prev, *(a[:, t] for a in per_step), changed[:, t], out=out)
        ys.append(emit(out))
        prev = out
    return prev, finish(torch.stack(ys, dim=1))


def decode_batch_kmv_model(init_frames, paycode, mvk, changed,
                           dtype=torch.bfloat16, layout="NHWC", downscale=1,
                           bpp16=False, packed=False):
    """Batched kmv decode fused straight into model tensors.
    → (carry [B,Y,X] for the next window, model [B,T,...])."""
    kw = dict(dtype=dtype, layout=layout, downscale=downscale, bpp16=bpp16,
              packed=packed)
    return _scan_model(kmv_compose, init_frames, (paycode, mvk), changed, kw)


def decode_sequence_kmv_compact_model(init_frame, paycode, mvk,
                                      dtype=torch.bfloat16, layout="NHWC",
                                      downscale=1, packed=False):
    """Still-elision + fused model emission for one stream: decode only
    changed frames, emit only their model tensors.
    → (carry [Y,X], model [T', ...])."""
    kw = dict(dtype=dtype, layout=layout, downscale=downscale,
              packed=packed)
    chg = torch.ones((1, paycode.shape[0]), dtype=torch.bool,
                     device=paycode.device)
    carry, model = _scan_model(kmv_compose, init_frame[None],
                               (paycode[None], mvk[None]), chg, kw)
    return carry[0], model[0]


# ---------------------------------------------------------------------------
# The bc transport (csrc/bc_compose.cu)
#
# bcode [NB] u8 (0 copy / 1 data / 2+k motion slot k) and block-local rects
# rloc [NB, 4] u8 (x0, y0, x1, y1) carry the block structure; the u32 plane
# holds only the data-rect pixels, and its other bytes are never read.
# ---------------------------------------------------------------------------

def bc_row_map(bcode, rect, nby: int, nbx: int, X: int) -> torch.Tensor:
    """Per-block commands → the reference's packed [nby, X] row map
    ``btype | y1<<8 | y2<<16`` per column; columns outside a block's
    x-rect read 0 (copy)."""
    bt = bcode.reshape(nby, nbx).to(torch.int32)
    r = rect.reshape(nby, nbx, 4).to(torch.int32)
    lx = torch.arange(16, dtype=torch.int32, device=bcode.device)
    act = (lx >= r[..., 0, None]) & (lx < r[..., 2, None])
    packed = torch.where(
        act, bt[..., None] | (r[..., 1, None] << 8) | (r[..., 3, None] << 16),
        0)
    return packed.reshape(nby, nbx * 16)[:, :X]


def row_expand(rows: torch.Tensor, Y: int, X: int) -> torch.Tensor:
    """[nby, X] → [Y, X]: each row repeated 16 times."""
    nby = rows.shape[0]
    return rows[:, None, :].expand(nby, 16, X).reshape(nby * 16, X)[:Y]


def _neg32(v: int) -> int:
    """-v in int32 arithmetic, as the reference negates a vector before its
    roll: -(-2**31) wraps to -2**31."""
    return v if v == -2**31 else -v


def compose_codes_ref(prev, data, bcode, rect, mvk) -> torch.Tensor:
    """The block-code compose of the reference's compose_frame_bc and
    compose_frame_lane, its ops one for one: prev and data [Y, X] int32 bit
    views, bcode [NB] u8, rect [NB, 4] u8 block-local, mvk [K, 2] (mx, my)
    → [Y, X].  The row map and its row expansion, then code 1 inside the
    rect takes data, code 2+k (k < K) inside the rect takes prev rolled by
    mvk[k] (wrapping), the rest keeps prev."""
    Y, X = prev.shape
    nby, nbx = block_grid(Y, X)
    rowv = row_expand(bc_row_map(bcode, rect, nby, nbx, X), Y, X)
    bt = rowv & 0xFF
    y1 = (rowv >> 8) & 0xFF
    y2 = (rowv >> 16) & 0xFF
    ly = torch.arange(Y, dtype=torch.int32, device=prev.device)[:, None] & 15
    in_y = (ly >= y1) & (ly < y2)
    out = torch.where((bt == 1) & in_y, data, prev)
    for k, (mx, my) in enumerate(mvk.tolist()):
        shifted = torch.roll(prev, shifts=(_neg32(my), _neg32(mx)),
                             dims=(0, 1))
        out = torch.where((bt == 2 + k) & in_y, shifted, out)
    return out


def compose_frame_bc_ref(prev, plane, bcode, rect, mvk) -> torch.Tensor:
    """Plain twin of the reference's compose_frame_bc: compose_codes_ref
    whose data is plane & 0xFFFFFF (prev/plane [Y, X], bcode [NB], rect
    [NB, 4], mvk [K, 2] → [Y, X])."""
    return compose_codes_ref(prev, plane & 0x00FFFFFF, bcode, rect, mvk)


def bc_compose_ref(prev, plane, bcode, rloc, mvk, changed) -> torch.Tensor:
    """Plain twin of the batched bc step: prev/plane [B, Y, X], bcode
    [B, NB], rloc [B, NB, 4], mvk [B, K, 2], changed [B] → [B, Y, X]
    (unchanged streams copy prev)."""
    return per_stream_ref(compose_frame_bc_ref, prev, changed, plane, bcode,
                          rloc, mvk)


def bc_compose(prev: torch.Tensor, plane: torch.Tensor, bcode: torch.Tensor,
               rloc: torch.Tensor, mvk: torch.Tensor, changed: torch.Tensor,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """One bc scan step for every stream of a batch: prev/plane [B, Y, X]
    int32 bit views, bcode [B, NB] u8, rloc [B, NB, 4] u8, mvk [B, K, 2]
    int32, changed [B] bool → out [B, Y, X] (allocated unless given; it
    must not alias prev).  The plane is read only inside code-1 rects.

    CUDA kernel csrc/bc_compose.cu for tensors on the card — one launch for
    all B streams; the plain twin only for tensors on the CPU.  Each
    argument may be a strided view (e.g. plane[:, t] of a [B, T, Y, X]
    window) as long as its rows are contiguous."""
    if prev.device.type == "cpu":
        return cpu_result(bc_compose_ref(prev, plane, bcode, rloc, mvk,
                                         changed), out)
    if out is None:
        out = torch.empty_like(prev, memory_format=torch.contiguous_format)
    args = _kmv_launch_args("bc_compose", prev, plane, mvk, changed, out,
                            pix_name="plane")
    block_code_checks("bc_compose", prev, bcode, rloc)
    B, Y, X = prev.shape
    if B and Y and X:
        lib = _build.load()
        with torch.cuda.device(prev.device):
            rc = lib.jsp_bc_compose(
                *args, bcode.data_ptr(), bcode.stride(0), rloc.data_ptr(),
                rloc.stride(0), B, Y, X, mvk.shape[-2],
                torch.cuda.current_stream(prev.device).cuda_stream)
        _build.check(rc, "bc_compose")
        bc_compose.launches += 1
    return out


bc_compose.launches = 0  # kernel launches (the plain path does not count)


def compose_frame_bc(prev, plane, bcode, rect, mvk):
    """Single-frame compose, the reference's signature: prev/plane [Y, X],
    bcode [NB] u8, rect [NB, 4] u8, mvk [K, 2] → [Y, X]."""
    chg = torch.ones(1, dtype=torch.bool, device=prev.device)
    return bc_compose(prev[None], plane[None], bcode[None], rect[None],
                      mvk[None], chg)[0]


def decode_batch_bc(init_frames, plane, bcode, rect, mvk, changed):
    """Batched bc scan: init [B,Y,X], plane [B,T,Y,X], bcode [B,T,NB],
    rect [B,T,NB,4], mvk [B,T,K,2], changed [B,T] → frames [B,T,Y,X]; one
    launch per step over all B."""
    return scan_steps(bc_compose, init_frames, (plane, bcode, rect, mvk),
                      changed)


def decode_sequence_bc(init_frame, plane, bcode, rect, mvk, changed):
    """One stream: init [Y,X], plane [T,Y,X], … → frames [T,Y,X]."""
    return decode_batch_bc(init_frame[None], plane[None], bcode[None],
                           rect[None], mvk[None], changed[None])[0]


def decode_sequence_bc_compact(init_frame, plane, bcode, rect, mvk):
    """bc scan over changed frames only (every input frame composes)."""
    chg = torch.ones(plane.shape[0], dtype=torch.bool, device=plane.device)
    return decode_sequence_bc(init_frame, plane, bcode, rect, mvk, chg)


def decode_batch_bc_model(init_frames, plane, bcode, rect, mvk, changed,
                          dtype=torch.bfloat16, layout="NHWC", downscale=1,
                          bpp16=False, packed=False):
    """Batched bc decode fused straight into model tensors.
    → (carry [B,Y,X] for the next window, model [B,T,...])."""
    kw = dict(dtype=dtype, layout=layout, downscale=downscale, bpp16=bpp16,
              packed=packed)
    return _scan_model(bc_compose, init_frames, (plane, bcode, rect, mvk),
                       changed, kw)


# ---------------------------------------------------------------------------
# The kmv_sparse transport (csrc/kmv_sparse.cu)
#
# bcode [NB] u8 per block (0 copy, 2+k whole-block motion slot k; other
# codes copy), K vectors, and M final-content 16x16 tiles written in order
# at tile_yx (y0, x0), each start clamped into [0, Y-16] x [0, X-16] as
# dynamic_update_slice clamps it: a pixel takes the LAST tile whose clamped
# window covers it.  Tiles travel as one flat [S, 256] u32 array and a
# per-frame index tile_idx [M] into it (the reference's ragged transport;
# its dense [M, 16, 16] layout is a flat view with an identity index).
# ---------------------------------------------------------------------------

def take_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src[idx] along axis 0 with jnp.take's default semantics: an index in
    [-n, -1] wraps, any other index outside [0, n) reads all ones
    (0xFFFFFFFF) → idx.shape + src.shape[1:].  Like jnp.take, a non-empty
    take from an empty axis raises IndexError."""
    n = src.shape[0]
    if n == 0 and idx.numel():
        raise IndexError("a non-empty take from an empty axis")
    i = idx.to(torch.int64)
    i = torch.where(i < 0, i + n, i)
    ok = (i >= 0) & (i < n)
    got = src[i.clamp(0, max(n - 1, 0))]
    ok = ok.reshape(tuple(ok.shape) + (1,) * (src.dim() - 1))
    return torch.where(ok, got, torch.full_like(got, -1))


def tile_start(v: int, n: int) -> int:
    """Where dynamic_update_slice puts a 16-wide update starting at v along
    an axis of n: a negative start counts from the end (v + n, its
    allow_negative_indices default), then the start is clamped into
    [0, n - 16]."""
    if v < 0:
        v += n
    return min(max(v, 0), n - 16)


def _tile_frame_check(what: str, Y: int, X: int) -> None:
    if Y < 16 or X < 16:
        raise ValueError(f"{what}: 16x16 tiles need a frame of at least "
                         f"16x16, got {Y}x{X} (dynamic_update_slice "
                         f"refuses a larger update)")


def compose_frame_kmv_sparse_ref(prev, bcode, mvk, tiles, tile_yx
                                 ) -> torch.Tensor:
    """Plain twin of the reference's compose_frame_kmv_sparse, its ops one
    for one: prev [Y, X] int32 bit view, bcode [NB] u8, mvk [K, 2] (mx,
    my), tiles [M, 16, 16], tile_yx [M, 2] (y0, x0) → [Y, X].  The block
    map and K wrapping rolls, then each tile in order at its clamped
    start."""
    Y, X = prev.shape
    _tile_frame_check("compose_frame_kmv_sparse_ref", Y, X)
    nbx = (X + 15) // 16
    nby = bcode.shape[0] // nbx
    bmap = block_broadcast(bcode.to(torch.int32), nby, nbx, Y, X)
    out = prev
    for k, (mx, my) in enumerate(mvk.tolist()):
        shifted = torch.roll(prev, shifts=(_neg32(my), _neg32(mx)),
                             dims=(0, 1))
        out = torch.where(bmap == 2 + k, shifted, out)
    out = out.clone()
    for tile, (ty, tx) in zip(tiles, tile_yx.tolist()):
        y0, x0 = tile_start(ty, Y), tile_start(tx, X)
        out[y0:y0 + 16, x0:x0 + 16] = tile
    return out


def kmv_sparse_compose_ref(prev, bcode, mvk, tiles, tile_idx, tile_yx,
                           changed) -> torch.Tensor:
    """Plain twin of the batched step: prev [B, Y, X], bcode [B, NB], mvk
    [B, K, 2], tiles [S, 256] (one flat array for every stream), tile_idx
    [B, M] int32 rows of tiles (jnp.take's reads: [-S, -1] wraps, other
    indices outside [0, S) read 0xFFFFFFFF), tile_yx [B, M, 2], changed [B]
    → [B, Y, X] (unchanged streams copy prev)."""
    def frame(prev_b, bc, mk, idx, yx):
        return compose_frame_kmv_sparse_ref(
            prev_b, bc, mk, take_rows(tiles, idx).reshape(-1, 16, 16), yx)

    return per_stream_ref(frame, prev, changed, bcode, mvk, tile_idx,
                          tile_yx)


def kmv_sparse_compose(prev: torch.Tensor, bcode: torch.Tensor,
                       mvk: torch.Tensor, tiles: torch.Tensor,
                       tile_idx: torch.Tensor, tile_yx: torch.Tensor,
                       changed: torch.Tensor, out: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """One kmv_sparse scan step for every stream of a batch: prev [B, Y, X]
    int32 bit views (Y, X >= 16), bcode [B, NB] u8, mvk [B, K, 2] int32,
    tiles [S, 256] int32 (rows of 256 contiguous words, any row stride),
    tile_idx [B, M] int32, tile_yx [B, M, 2] int32, changed [B] bool →
    out [B, Y, X] (allocated unless given; it must not alias prev).

    CUDA kernel csrc/kmv_sparse.cu for tensors on the card — one call for
    all B streams: the tile-owner pass and the compose, over a per-cell
    scratch that the compose leaves as it found it (``cell_scratch``); the
    plain twin only for tensors on the CPU.  Strided views such as
    bcode[:, t] of a window are fine where their rows are contiguous."""
    if prev.device.type == "cpu":
        return cpu_result(kmv_sparse_compose_ref(
            prev, bcode, mvk, tiles, tile_idx, tile_yx, changed), out)
    what = "kmv_sparse_compose"
    if out is None:
        out = torch.empty_like(prev, memory_format=torch.contiguous_format)
    cuda_launch_checks(what, tiles, tile_idx, tile_yx)
    step_checks(what, prev, mvk, changed, out)
    B, Y, X = prev.shape
    _tile_frame_check(what, Y, X)
    nb = math.prod(block_grid(Y, X))
    if bcode.device != prev.device or bcode.dtype != torch.uint8:
        raise TypeError(f"{what}: bcode must be a uint8 tensor on the "
                        f"frames' device, got {bcode.dtype} on {bcode.device}")
    if tuple(bcode.shape) != (B, nb) or bcode.stride(-1) != 1:
        raise ValueError(f"{what}: bcode must be [{B}, {nb}] with "
                         f"contiguous rows, got {tuple(bcode.shape)}")
    if tiles.dim() != 2 or tiles.shape[1] != 256 or tiles.stride(1) != 1:
        raise ValueError(f"{what}: tiles must be [S, 256] with contiguous "
                         f"rows, got {tuple(tiles.shape)} strides "
                         f"{tiles.stride()}")
    M = tile_idx.shape[-1] if tile_idx.dim() == 2 else -1
    if tuple(tile_idx.shape) != (B, M) or (M and tile_idx.stride(-1) != 1):
        raise ValueError(f"{what}: tile_idx must be [{B}, M] with "
                         f"contiguous rows, got {tuple(tile_idx.shape)}")
    if tuple(tile_yx.shape) != (B, M, 2) or M and (
            tile_yx.stride(-1) != 1 or tile_yx.stride(-2) != 2):
        raise ValueError(f"{what}: tile_yx must be [{B}, {M}, 2] with "
                         f"contiguous [M, 2], got {tuple(tile_yx.shape)}")
    S = tiles.shape[0]
    if S == 0 and B and M:
        raise IndexError(f"{what}: a tile gather from zero rows (as "
                         f"jnp.take refuses)")
    if B and Y and X:
        stream = torch.cuda.current_stream(prev.device).cuda_stream
        cells = cell_scratch(prev.device, stream, B * nb)
        lib = _build.load()
        with torch.cuda.device(prev.device):
            rc = lib.jsp_kmv_sparse_compose(
                prev.data_ptr(), prev.stride(0), mvk.data_ptr(),
                mvk.stride(0), changed.data_ptr(), changed.stride(0),
                out.data_ptr(), out.stride(0), bcode.data_ptr(),
                bcode.stride(0), tiles.data_ptr(), S, tiles.stride(0),
                tile_idx.data_ptr(), tile_idx.stride(0), tile_yx.data_ptr(),
                tile_yx.stride(0), cells.data_ptr(), B, Y, X, mvk.shape[-2],
                M, stream)
        if rc != 0:  # the compose may not have put the headers back
            _REFILL.add((prev.device, stream))
        _build.check(rc, what)
        kmv_sparse_compose.launches += 1
    return out


kmv_sparse_compose.launches = 0  # kernel launches (the plain path does not count)

#: (device, CUDA stream) → every csrc/kmv_sparse.cu per-cell scratch handed
#: to a launch on that stream, oldest first, each [n, 8] int32: a cell's
#: owner header (top, full, count - 1, -) and its list of partial tiles
_CELLS: dict = {}
#: the keys of _CELLS whose newest scratch a failed launch may have left
#: with headers set: it is refilled in place before its next use
_REFILL: set = set()


def cell_scratch(device: torch.device, stream: int,
                 cells: int) -> torch.Tensor:
    """At least `cells` cells of kmv_sparse_compose's scratch for launches
    on `stream` (the raw CUDA stream handle) of `device`, every header -1.
    Made (filled with -1) once and kept: each call's compose writes back -1
    into every header it read, so the scratch stays clean from call to
    call, in stream order, and two streams never share one.

    A scratch once handed out is never released, since a CUDA graph
    captured with it holds its raw pointer: one too small for a call is
    kept beside its larger successor, and one that a failed launch left
    dirty is refilled in place (same storage) before its next use.  That
    holds 32 bytes a cell, B*NB cells: ~1 MB at B=4 1080p, once for each
    size a stream grew through.  One made while a CUDA graph is being
    captured is not kept: its fill is a node of that graph."""
    key = (device, stream)
    kept = _CELLS.get(key)
    capturing = (device.type == "cuda"
                 and torch.cuda.is_current_stream_capturing())
    if kept and kept[-1].shape[0] >= cells:
        have = kept[-1]
        if key in _REFILL:
            have.fill_(-1)
            if not capturing:
                _REFILL.discard(key)
        return have
    got = torch.full((cells, 8), -1, dtype=torch.int32, device=device)
    if not capturing:
        _CELLS.setdefault(key, []).append(got)
        _REFILL.discard(key)
    return got


def compose_frame_kmv_sparse(prev, bcode, mvk, tiles, tile_yx):
    """Single-frame compose, the reference's signature: prev [Y, X], bcode
    [NB] u8, mvk [K, 2], tiles [M, 16, 16], tile_yx [M, 2] → [Y, X]."""
    M = tiles.shape[0]
    chg = torch.ones(1, dtype=torch.bool, device=prev.device)
    idx = torch.arange(M, dtype=torch.int32, device=prev.device)[None]
    return kmv_sparse_compose(prev[None], bcode[None], mvk[None],
                              tiles.reshape(M, 256), idx, tile_yx[None],
                              chg)[0]


def decode_batch_kmv_sparse_ragged(init_frames, bcode, mvk, tiles_flat,
                                   tile_idx, tile_yx, changed):
    """Ragged tile transport: init [B,Y,X], bcode [B,T,NB], mvk [B,T,K,2],
    tiles_flat [S,256] (the window's real tiles and pad rows), tile_idx
    [B,T,M] rows of tiles_flat, tile_yx [B,T,M,2], changed [B,T] → frames
    [B,T,Y,X]; one kmv_sparse_compose call a step for all B, reading the
    tiles through tile_idx (no [B,T,M,16,16] gather)."""
    def step(prev, bc, mk, idx, yx, chg, out):
        return kmv_sparse_compose(prev, bc, mk, tiles_flat, idx, yx, chg,
                                  out=out)

    return scan_steps(step, init_frames, (bcode, mvk, tile_idx, tile_yx),
                      changed)


def decode_batch_kmv_sparse(init_frames, bcode, mvk, tiles, tile_yx,
                            changed):
    """Batched sparse-kmv scan with dense tiles [B,T,M,16,16]: the ragged
    scan over their flat view and an identity index."""
    B, T, M = tiles.shape[:3]
    idx = torch.arange(B * T * M, dtype=torch.int32,
                       device=tiles.device).reshape(B, T, M)
    return decode_batch_kmv_sparse_ragged(
        init_frames, bcode, mvk, tiles.reshape(B * T * M, 256), idx, tile_yx,
        changed)


def decode_sequence_kmv_sparse(init_frame, bcode, mvk, tiles, tile_yx,
                               changed):
    """One stream: init [Y,X], bcode [T,NB], mvk [T,K,2], tiles
    [T,M,16,16], tile_yx [T,M,2], changed [T] → frames [T,Y,X]."""
    return decode_batch_kmv_sparse(init_frame[None], bcode[None], mvk[None],
                                   tiles[None], tile_yx[None],
                                   changed[None])[0]


# ---------------------------------------------------------------------------
# Block-command composes (csrc/sp_motion.cu): the general mode here, the
# fused and mxu modes in sp_motion_pallas.py and sp_motion_mxu.py
# ---------------------------------------------------------------------------

def block_broadcast(vals: torch.Tensor, nby: int, nbx: int, Y: int,
                    X: int) -> torch.Tensor:
    """Per-block values [NB, ...] → per-pixel [Y, X, ...] over 16×16 tiles
    (a ceil-divided block grid, cropped to the frame)."""
    tail = tuple(vals.shape[1:])
    v = vals.reshape((nby, 1, nbx, 1) + tail)
    v = v.expand((nby, 16, nbx, 16) + tail)
    return v.reshape((nby * 16, nbx * 16) + tail)[:Y, :X]


def block_grid(Y: int, X: int) -> tuple[int, int]:
    """(nby, nbx): the SP block grid of a [Y, X] frame, ceil-divided."""
    return (Y + 15) // 16, (X + 15) // 16


def pixel_grid(Y: int, X: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(yy, xx) int32 [Y, X] row and column indices."""
    yy = torch.arange(Y, dtype=torch.int32, device=device)[:, None]
    xx = torch.arange(X, dtype=torch.int32, device=device)[None, :]
    return yy.expand(Y, X), xx.expand(Y, X)


def block_masks(bts, rect, Y: int, X: int):
    """→ (yy, xx, per-pixel block type b, in_rect) for one frame's bts [NB]
    and rect [NB, 4] (x0, y0, x1, y1)."""
    nby, nbx = block_grid(Y, X)
    yy, xx = pixel_grid(Y, X, bts.device)
    b = block_broadcast(bts, nby, nbx, Y, X)
    r = block_broadcast(rect, nby, nbx, Y, X)
    in_rect = ((xx >= r[..., 0]) & (xx < r[..., 2])
               & (yy >= r[..., 1]) & (yy < r[..., 3]))
    return yy, xx, b, in_rect


def read_or_zero(prev: torch.Tensor, sy: torch.Tensor,
                 sx: torch.Tensor) -> torch.Tensor:
    """prev[sy, sx] per pixel (int64 source indices), 0 where the source
    lies outside the frame."""
    Y, X = prev.shape
    inside = (sy >= 0) & (sy < Y) & (sx >= 0) & (sx < X)
    idx = sy.clamp(0, Y - 1) * X + sx.clamp(0, X - 1)
    got = prev.reshape(-1)[idx.reshape(-1)].reshape(sy.shape)
    return torch.where(inside, got, torch.zeros_like(got))


def compose_frame_ref(prev, bts, mv, rect, payload) -> torch.Tensor:
    """Plain twin of the reference's compose_frame: prev/payload [Y, X]
    int32 bit views, bts [NB], mv [NB, 2] (mx, my), rect [NB, 4] → [Y, X].
    Active pixels (bts > 0, inside the rect) of motion blocks ((bts-1) & 2:
    bts 3 and 4) read prev at the clipped source, the others payload; the
    rest keep prev.  Sources add in int32 (wrapping, as jnp does), then
    clip."""
    Y, X = prev.shape
    yy, xx, b, in_rect = block_masks(bts, rect, Y, X)
    active = (b > 0) & in_rect
    is_motion = active & (((b - 1) & 2) > 0)
    is_data = active & (((b - 1) & 2) == 0)
    m = block_broadcast(mv, *block_grid(Y, X), Y, X)
    src_y = (yy + m[..., 1]).clamp(0, Y - 1).long()
    src_x = (xx + m[..., 0]).clamp(0, X - 1).long()
    moved = prev.reshape(-1)[(src_y * X + src_x).reshape(-1)].reshape(Y, X)
    return torch.where(is_motion, moved, torch.where(is_data, payload, prev))


def launch_block_kernel(wrapper, cfn: str, prev, pix, cmds, changed, out):
    """The CUDA branch shared by csrc/sp_motion.cu's wrappers: check, launch
    entry point `cfn` once for all B streams, count the launch on
    `wrapper`.  prev/pix [B, Y, X] and out are row-contiguous int32 planes
    (strided views such as frames[:, t] are fine), cmds [(name, tensor
    [B, NB, *tail] with contiguous rows, tail)] in the entry point's order,
    changed [B] bool."""
    what = wrapper.__name__
    if out is None:
        out = torch.empty_like(prev, memory_format=torch.contiguous_format)
    cuda_launch_checks(what, prev, pix, *(t for _, t, _ in cmds), out)
    if changed.device != prev.device or changed.dtype != torch.bool:
        raise TypeError(f"{what}: changed must be a bool tensor on the "
                        f"frames' device")
    B, Y, X = prev.shape
    nby, nbx = block_grid(Y, X)
    for name, t in (("prev", prev), ("pixels", pix), ("out", out)):
        if t.shape != (B, Y, X) or t.stride(-1) != 1 or t.stride(-2) != X:
            raise ValueError(f"{what}: {name} must be row-contiguous "
                             f"[{B}, {Y}, {X}], got {tuple(t.shape)} "
                             f"strides {t.stride()}")
    for name, t, tail in cmds:
        want = (B, nby * nbx) + tail
        if t.shape != want or (B and not t[0].is_contiguous()):
            raise ValueError(f"{what}: {name} must be {list(want)} with "
                             f"contiguous rows, got {tuple(t.shape)} "
                             f"strides {t.stride()}")
    if changed.shape != (B,):
        raise ValueError(f"{what}: changed must be [B]")
    if _planes_overlap(out, prev):
        raise ValueError(f"{what}: out must not alias prev (motion reads "
                         f"would see written pixels)")
    if B and Y and X:
        lib = _build.load()
        args = [prev.data_ptr(), prev.stride(0), pix.data_ptr(), pix.stride(0)]
        for _, t, _ in cmds:
            args += [t.data_ptr(), t.stride(0)]
        with torch.cuda.device(prev.device):
            rc = getattr(lib, cfn)(
                *args, changed.data_ptr(), changed.stride(0), out.data_ptr(),
                out.stride(0), B, Y, X,
                torch.cuda.current_stream(prev.device).cuda_stream)
        _build.check(rc, what)
        wrapper.launches += 1
    return out


def sp_compose_general(prev, bts, mv, rect, payload, changed, out=None):
    """One general-compose scan step for every stream of a batch:
    prev/payload [B, Y, X] int32 bit views, bts [B, NB], mv [B, NB, 2],
    rect [B, NB, 4] int32, changed [B] bool → out [B, Y, X] (allocated
    unless given; it must not alias prev).  Unchanged streams copy prev and
    their commands are not read.

    Mode "general" of csrc/sp_motion.cu for tensors on the card, one launch
    for all B; the plain twin (compose_frame_ref per stream) only for
    tensors on the CPU."""
    if prev.device.type == "cpu":
        return cpu_result(per_stream_ref(compose_frame_ref, prev, changed,
                                         bts, mv, rect, payload), out)
    return launch_block_kernel(
        sp_compose_general, "jsp_sp_compose_general", prev, payload,
        [("bts", bts, ()), ("mv", mv, (2,)), ("rect", rect, (4,))], changed,
        out)


sp_compose_general.launches = 0  # kernel launches (the plain path does not count)


def compose_frame(prev, bts, mv, rect, payload):
    """The reference's signature: prev/payload [Y, X], bts [NB], mv
    [NB, 2], rect [NB, 4] → [Y, X]."""
    chg = torch.ones(1, dtype=torch.bool, device=prev.device)
    return sp_compose_general(prev[None], bts[None], mv[None], rect[None],
                              payload[None], chg)[0]


def significance(bts, changed, insignificant_blocks) -> torch.Tensor:
    """The scan's significant-change verdict (ScreenPressor.hx:346-352):
    bts [..., NB], changed [...] → changed & any block above the
    insignificant band has bts > 0."""
    above = torch.arange(bts.shape[-1], device=bts.device) >= \
        insignificant_blocks
    return changed & ((bts > 0) & above).any(-1)


def decode_batch(init_frames, bts, mv, rect, payload, changed,
                 insignificant_blocks):
    """Batched general decode: init [B,Y,X], bts [B,T,NB], mv [B,T,NB,2],
    rect [B,T,NB,4], payload [B,T,Y,X], changed [B,T] → (frames
    [B,T,Y,X], signif [B,T]); one launch per step over all B."""
    frames = scan_steps(sp_compose_general, init_frames,
                        (bts, mv, rect, payload), changed)
    return frames, significance(bts, changed, insignificant_blocks)


def decode_sequence(init_frame, bts, mv, rect, payload, changed,
                    insignificant_blocks):
    """One stream: init [Y,X], bts [T,NB], … → (frames [T,Y,X],
    signif [T])."""
    frames, signif = decode_batch(init_frame[None], bts[None], mv[None],
                                  rect[None], payload[None], changed[None],
                                  insignificant_blocks)
    return frames[0], signif[0]


# ---------------------------------------------------------------------------
# numpy host helpers (copies of jsplayer_tpu/kernels/sp_recon.py's)
# ---------------------------------------------------------------------------

def derive_kmv_commands(bts, mv, rect, K: int = 4):
    """numpy host step: [T,...] commands → (mvk [T,K,2], group [T,NB] int32
    in [-1, K), data_mask_extra: blocks demoted to data).  group == -1 means
    not motion.  Motion blocks are bts 3 (full block) AND 4 (subrect motion,
    (bts-1)&2 — the encoder's common shape for scrolls over flat regions);
    for bts 4 the roll applies only inside the captured rect."""
    T, NB = bts.shape
    mvk = np.zeros((T, K, 2), dtype=np.int32)
    group = np.full((T, NB), -1, dtype=np.int32)
    demoted = np.zeros((T, NB), dtype=bool)
    for t in range(T):
        motion = np.nonzero((bts[t] == 3) | (bts[t] == 4))[0]
        if motion.size == 0:
            continue
        vecs, inv, counts = np.unique(
            mv[t, motion], axis=0, return_inverse=True, return_counts=True)
        order = np.argsort(-counts)[:K]
        remap = np.full(len(vecs), -1, dtype=np.int32)
        for slot, vi in enumerate(order):
            remap[vi] = slot
            mvk[t, slot] = vecs[vi]
        g = remap[inv]
        group[t, motion] = g
        demoted[t, motion[g < 0]] = True
    return mvk, group, demoted


def prepare_kmv(bts, mv, rect, payload, K: int = 4):
    """Host prep (numpy): → (paycode [T,Y,X] u32, mvk [T,K,2]).  Demoted-
    motion and subrect/data blocks all read from payload; rect masks and the
    motion k-slot are packed into paycode's top byte."""
    T, NB = bts.shape
    Y, X = payload.shape[-2:]
    # ceil-divided like the capture's block grid (ScreenPressor.hx:361)
    nby, nbx = (Y + 15) // 16, (X + 15) // 16
    assert K <= 8, "k-slot field is 3 bits"
    mvk, group, demoted = derive_kmv_commands(bts, mv, rect, K)
    yy, xx = np.mgrid[0:Y, 0:X]
    bi = (yy >> 4) * nbx + (xx >> 4)
    out_pc = np.empty((T, Y, X), dtype=np.uint32)
    for t in range(T):
        b = bts[t][bi]
        r = rect[t][bi]
        in_rect = ((xx >= r[..., 0]) & (xx < r[..., 2])
                   & (yy >= r[..., 1]) & (yy < r[..., 3]))
        is_mot_block = (b == 3) | (b == 4)
        is_data = (b > 0) & ~is_mot_block & in_rect
        is_data |= demoted[t][bi]
        gp = np.where(demoted[t][bi], -1, group[t][bi])
        is_motion = (gp >= 0) & in_rect  # bts 4: roll only inside the rect
        ptype = np.where(is_data, 1, np.where(is_motion, 2, 0)).astype(np.uint32)
        kbits = np.where(is_motion, gp, 0).astype(np.uint32)
        # pixel bits only where ptype==1 (the native twin's zero convention)
        pix = np.where(is_data, payload[t] & 0x00FFFFFF, 0).astype(np.uint32)
        out_pc[t] = pix | (ptype << 24) | (kbits << 26)
    return out_pc, mvk


def compact_changed(paycode, mvk, changed):
    """Still-elision (host, numpy): drop unchanged frames from the device
    scan — stills don't alter the P-chain carry, so decoding only changed
    frames is exact.  Returns (paycode', mvk', outmap) where outmap[t] is
    the compacted index holding original frame t's pixels (-1 → the init
    frame)."""
    changed = np.asarray(changed, dtype=bool)
    idx = np.nonzero(changed)[0]
    outmap = np.cumsum(changed).astype(np.int32) - 1
    return paycode[idx], mvk[idx], outmap


def _elision_bucket(n: int, cap: int, nbuckets: int = 8) -> int:
    """Round n up to one of `nbuckets` linear bucket sizes (0 stays 0),
    capped at `cap`.  The port has no recompiles to bound; it keeps the
    bucket so its window dicts (flat-stack shape, outmap) equal the
    reference's."""
    if n <= 0:
        return 0
    step = -(-cap // nbuckets)
    return min(-(-n // step) * step, cap)


def compact_changed_batch(paycode, mvk, changed):
    """Batched still-elision (host, numpy): per-stream compaction of the
    changed frames, padded to a shared bucketed length.  Returns
    (paycode' [B,Cpad,...], mvk' [B,Cpad,...], valid [B,Cpad] bool,
    outmap [B,T] i32) where outmap[b,t] is the compacted index holding
    stream b's original frame t (-1 → the window's carry-in frame).  Pad
    slots have valid=False, so the scan passes the carry through them."""
    changed = np.asarray(changed, dtype=bool)
    B, T = changed.shape
    counts = changed.sum(axis=1)
    cpad = _elision_bucket(int(counts.max(initial=0)), T)
    pcc = np.zeros((B, cpad) + paycode.shape[2:], dtype=paycode.dtype)
    mvkc = np.zeros((B, cpad) + mvk.shape[2:], dtype=mvk.dtype)
    valid = np.zeros((B, cpad), dtype=bool)
    outmap = np.empty((B, T), dtype=np.int32)
    for b in range(B):
        idx = np.nonzero(changed[b])[0]
        c = len(idx)
        pcc[b, :c] = paycode[b, idx]
        mvkc[b, :c] = mvk[b, idx]
        valid[b, :c] = True
        outmap[b] = np.cumsum(changed[b]).astype(np.int32) - 1
    return pcc, mvkc, valid, outmap


def prepare_bc(bts, mv, rect, payload, K: int = 4):
    """Host prep (numpy reference): → (plane [T,Y,X] u32, bcode [T,NB] u8,
    rloc [T,NB,4] u8, mvk [T,K,2]).  The plane here is simply the decoded
    frame (data pixels are a subset); the native twin writes only data-rect
    pixels — both are valid bc transports because non-data plane bytes are
    never read."""
    T, NB = bts.shape
    Y, X = payload.shape[-2:]
    nbx = (X + 15) // 16
    mvk, group, demoted = derive_kmv_commands(bts, mv, rect, K)
    bcode = np.zeros((T, NB), dtype=np.uint8)
    rloc = np.zeros((T, NB, 4), dtype=np.uint8)
    bxy = np.empty((NB, 4), dtype=np.int64)
    bxy[:, 0] = bxy[:, 2] = (np.arange(NB) % nbx) * 16
    bxy[:, 1] = bxy[:, 3] = (np.arange(NB) // nbx) * 16
    for t in range(T):
        loc = np.clip(rect[t] - bxy, 0, 16).astype(np.uint8)
        is_mot = (bts[t] == 3) | (bts[t] == 4)
        data_blk = (bts[t] > 0) & ~is_mot & ~demoted[t]
        bcode[t, data_blk] = 1
        rloc[t, data_blk] = loc[data_blk]
        bcode[t, demoted[t]] = 1
        rloc[t, demoted[t]] = (0, 0, 16, 16)
        mot = (group[t] >= 0) & ~demoted[t]
        bcode[t, mot] = (2 + group[t, mot]).astype(np.uint8)
        rloc[t, mot] = loc[mot]
    plane = (payload & np.uint32(0x00FFFFFF)).astype(np.uint32)
    return plane, bcode, rloc, mvk


def compact_arrays_batch(arrays, changed):
    """Batched still-elision over a tuple of [B, T, ...] arrays (the
    generalization of compact_changed_batch for transports with more than
    two per-frame inputs).  → (compacted tuple, valid [B,Cpad], outmap
    [B,T])."""
    changed = np.asarray(changed, dtype=bool)
    B, T = changed.shape
    counts = changed.sum(axis=1)
    cpad = _elision_bucket(int(counts.max(initial=0)), T)
    outs = [np.zeros((B, cpad) + a.shape[2:], dtype=a.dtype) for a in arrays]
    valid = np.zeros((B, cpad), dtype=bool)
    outmap = np.empty((B, T), dtype=np.int32)
    for b in range(B):
        idx = np.nonzero(changed[b])[0]
        c = len(idx)
        for o, a in zip(outs, arrays):
            o[b, :c] = a[b, idx]
        valid[b, :c] = True
        outmap[b] = np.cumsum(changed[b]).astype(np.int32) - 1
    return tuple(outs), valid, outmap


def prepare_kmv_sparse(bts, mv, rect, payload, K: int = 4, M: int | None = None,
                       prev0=None):
    """Host prep (numpy): → (bcode [T,NB] u8: 0 copy / 2+k motion-slot,
    mvk [T,K,2], tiles [T,M,16,16] u32, tile_yx [T,M,2] i32).  Blocks with
    data content (bts 1/2 subrect/gradient fills, ScreenPressor.hx:317-353)
    and motion blocks demoted from the K slots become tiles; padding tiles
    re-write block 0's final content (a no-op).

    prev0: the decoded frame preceding payload[0] (the previous window's
    last frame); without it frame 0's motion blocks can't pass the slot-
    safety check and all ride as tiles."""
    import numpy as _np

    T, NB = bts.shape
    Y, X = payload.shape[-2:]
    nbx = (X + 15) // 16
    assert K <= 8
    mvk, group, demoted = derive_kmv_commands(bts, mv, rect, K)
    # The sparse compose rolls WHOLE blocks (bcode is per block), but bts 4
    # motion is rect-limited: a slot is safe iff the full-block roll
    # reproduces the decoded block (256-pixel compare vs payload[t-1] per
    # motion block — the whole-frame roll+reduction variant measured 2 s
    # per 64-frame 1080p window; this is ~50 ms)
    pay = payload & _np.uint32(0x00FFFFFF)
    safe = _np.zeros((T, NB), dtype=bool)
    prev0 = None if prev0 is None else (prev0 & _np.uint32(0x00FFFFFF))
    for t in range(T):
        prev = pay[t - 1] if t > 0 else prev0
        if prev is None:
            continue
        for bi in _np.nonzero(group[t] >= 0)[0]:
            by, bx = divmod(int(bi), nbx)
            y1, y2 = by * 16, min(by * 16 + 16, Y)
            x1, x2 = bx * 16, min(bx * 16 + 16, X)
            mx, my = mv[t, bi]
            if (y1 + my < 0 or y2 + my > Y or x1 + mx < 0 or x2 + mx > X):
                continue
            safe[t, bi] = bool(
                (prev[y1 + my:y2 + my, x1 + mx:x2 + mx]
                 == pay[t, y1:y2, x1:x2]).all())
    mot = group >= 0
    need_tile = (((bts > 0) & (bts != 3) & (bts != 4)) | demoted
                 | (mot & ~safe))
    counts = need_tile.sum(axis=1)
    if M is None:
        M = max(1, int(counts.max()))
    if int(counts.max()) > M:
        raise ValueError(f"M={M} < max tiles/frame {int(counts.max())}")
    bcode = _np.zeros((T, NB), dtype=_np.uint8)
    g = _np.where(demoted | ~safe, -1, group)
    bcode[g >= 0] = (2 + g[g >= 0]).astype(_np.uint8)
    tiles = _np.zeros((T, M, 16, 16), dtype=_np.uint32)
    tile_yx = _np.zeros((T, M, 2), dtype=_np.int32)
    for t in range(T):
        blocks = _np.nonzero(need_tile[t])[0]
        for m, bi in enumerate(blocks):
            by, bx = divmod(int(bi), nbx)
            # edge blocks: clamp the 16x16 window into the frame; the
            # extra rows/cols re-write the neighbor's FINAL content
            # (exact, since payload is the fully decoded frame)
            y0, x0 = min(by * 16, Y - 16), min(bx * 16, X - 16)
            tiles[t, m] = pay[t, y0:y0 + 16, x0:x0 + 16]
            tile_yx[t, m] = (y0, x0)
        # pad with block (0,0)'s final content — a no-op rewrite
        if len(blocks) < M:
            tiles[t, len(blocks):] = pay[t, :16, :16]
            tile_yx[t, len(blocks):] = 0
    return bcode, mvk, _np.ascontiguousarray(tiles), tile_yx
