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
inside the kernel.

The numpy host helpers at the end are copies of the JAX module's (that
module imports jax at the top, which the port never does); tests pin each
copy against the original.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..device import cuda_launch_checks
from .rgb_convert import ds2_pack, to_model_input, unpack_ds2


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


def kmv_compose_ref(prev, paycode, mvk, changed) -> torch.Tensor:
    """Plain twin of the batched step: prev/paycode [B, Y, X], mvk
    [B, K, 2], changed [B] bool → [B, Y, X] (unchanged streams copy
    prev)."""
    outs = [compose_frame_kmv_ref(prev[b], paycode[b], mvk[b])
            if bool(changed[b]) else prev[b].clone()
            for b in range(prev.shape[0])]
    return torch.stack(outs) if outs else prev.clone()


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
        res = kmv_compose_ref(prev, paycode, mvk, changed)
        if out is None:
            return res
        out.copy_(res)
        return out
    if out is None:
        out = torch.empty_like(prev, memory_format=torch.contiguous_format)
    cuda_launch_checks("kmv_compose", prev, paycode, mvk, out)
    if changed.device != prev.device or changed.dtype != torch.bool:
        raise TypeError("kmv_compose: changed must be a bool tensor on the "
                        "frames' device")
    B, Y, X = prev.shape
    K = mvk.shape[-2]
    for name, t in (("prev", prev), ("paycode", paycode), ("out", out)):
        if t.shape != (B, Y, X) or t.stride(-1) != 1 or t.stride(-2) != X:
            raise ValueError(f"kmv_compose: {name} must be row-contiguous "
                             f"[{B}, {Y}, {X}], got {tuple(t.shape)} "
                             f"strides {t.stride()}")
    if mvk.shape != (B, K, 2) or mvk.stride(-1) != 1 or mvk.stride(-2) != 2:
        raise ValueError(f"kmv_compose: mvk must be [B, K, 2] with "
                         f"contiguous [K, 2], got {tuple(mvk.shape)}")
    if changed.shape != (B,):
        raise ValueError("kmv_compose: changed must be [B]")
    if _planes_overlap(out, prev):
        raise ValueError("kmv_compose: out must not alias prev (shifted "
                         "reads would see written pixels)")
    if B and Y and X:
        lib = _build.load()
        with torch.cuda.device(prev.device):
            rc = lib.jsp_kmv_compose(
                prev.data_ptr(), prev.stride(0),
                paycode.data_ptr(), paycode.stride(0),
                mvk.data_ptr(), mvk.stride(0),
                changed.data_ptr(), changed.stride(0),
                out.data_ptr(), out.stride(0), B, Y, X, K,
                torch.cuda.current_stream(prev.device).cuda_stream)
        _build.check(rc, "kmv_compose")
        kmv_compose.launches += 1
    return out


kmv_compose.launches = 0  # kernel launches (the plain path does not count)


def compose_frame_kmv(prev, paycode, mvk):
    """Single-frame compose, the reference's signature: prev/paycode
    [Y, X], mvk [K, 2] → [Y, X]."""
    chg = torch.ones(1, dtype=torch.bool, device=prev.device)
    return kmv_compose(prev[None], paycode[None], mvk[None], chg)[0]


# ---------------------------------------------------------------------------
# Scans
# ---------------------------------------------------------------------------

def decode_batch_kmv(init_frames, paycode, mvk, changed):
    """Batched kmv scan: init [B,Y,X], paycode [B,T,Y,X], mvk [B,T,K,2],
    changed [B,T] → frames [B,T,Y,X].  Step t composes straight into
    frames[:, t] from frames[:, t-1]: one launch per step over all B."""
    B, T = paycode.shape[:2]
    frames = torch.empty((B, T) + tuple(init_frames.shape[1:]),
                         dtype=init_frames.dtype, device=init_frames.device)
    prev = init_frames
    for t in range(T):
        kmv_compose(prev, paycode[:, t], mvk[:, t], changed[:, t],
                    out=frames[:, t])
        prev = frames[:, t]
    return frames


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


def _scan_model(init_frames, paycode, mvk, changed, model_kw):
    """The model-only scan: frames live in two ping-pong buffers (the
    full-res stack is never written); each step's emit is kept."""
    emit, finish = _model_emit(model_kw)
    B, T = paycode.shape[:2]
    if T == 0:
        raise ValueError("model scan over zero frames")
    bufs = (torch.empty_like(init_frames, memory_format=torch.contiguous_format),
            torch.empty_like(init_frames, memory_format=torch.contiguous_format))
    prev, ys = init_frames, []
    for t in range(T):
        out = bufs[t % 2]
        kmv_compose(prev, paycode[:, t], mvk[:, t], changed[:, t], out=out)
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
    return _scan_model(init_frames, paycode, mvk, changed, kw)


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
    carry, model = _scan_model(init_frame[None], paycode[None], mvk[None],
                               chg, kw)
    return carry[0], model[0]


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
