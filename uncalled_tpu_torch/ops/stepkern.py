"""The pooled step's ring assembly (port of ``uncalled_tpu.ops.stepkern``).

``new[i, :] = keep[i] ? (j == rslot[i] ? rval[i] : (rsrc[i] >= 0 ?
old[rsrc[i], :] : 0)) : 0`` over the RING = seed_len + 1 cumulative-sum
ring of every pool slot — the prob-ring copy/update of the reference's
child creation (PathBuffer::make_child, mapper.cpp:204-247).

A plain PyTorch version plus a hand-written CUDA kernel
(``csrc/stepkern.cu``), bit-exact to each other: the kernel moves the
32-bit patterns, so NaN payloads and -0.0 survive the copy.  The kernel
maps its threads onto the flat [S * RING] output, four words each.
"""

from __future__ import annotations

import torch

from . import _cuda

I32, F32 = torch.int32, torch.float32


def ring_assemble_plain(old_ring, rsrc, rslot, rval, keep):
    S, RING = old_ring.shape
    rows = old_ring.index_select(0, rsrc.clamp(0, S - 1).to(torch.int64))
    zero = torch.zeros((), dtype=F32, device=old_ring.device)
    base = torch.where((rsrc >= 0)[:, None], rows, zero)
    lane = torch.arange(RING, dtype=I32, device=old_ring.device)[None, :]
    return torch.where(
        keep[:, None],
        torch.where(lane == rslot[:, None], rval[:, None], base),
        zero,
    )


def ring_assemble(old_ring, rsrc, rslot, rval, keep):
    """old_ring [S, RING] f32, rsrc/rslot [S] i32 (rsrc < 0 = zero base,
    rslot -1 = no write), rval [S] f32, keep [S] bool -> new [S, RING]."""
    if old_ring.device.type == "cpu":
        return ring_assemble_plain(old_ring, rsrc, rslot, rval, keep)
    dev = old_ring.device
    _cuda.check(old_ring, "ring.old", (F32,), 2, dev)
    S, RING = old_ring.shape
    for t, name, dt in ((rsrc, "rsrc", I32), (rslot, "rslot", I32),
                        (rval, "rval", F32), (keep, "keep", torch.bool)):
        _cuda.check(t, "ring." + name, (dt,), 1, dev)
        if t.shape[0] != S:
            raise ValueError(f"ring.{name}: length {t.shape[0]} != {S}")
    if RING > 32:
        raise ValueError("ring_assemble: RING must be <= 32")
    if S * RING >= 2**31:
        raise ValueError(f"ring_assemble: S * RING = {S * RING} >= 2^31")
    # the kernel stores four words at a time: round the flat output up to
    # a multiple of four (the last store's tail lands in the padding)
    flat = torch.empty(-(-S * RING // 4) * 4, dtype=F32, device=dev)
    _cuda.launch(
        "ring_assemble_i32", old_ring.view(I32), rsrc, rslot, rval.view(I32),
        keep, flat.view(I32), S, RING,
    )
    _cuda.COUNTS["ring_assemble"] += 1
    return flat[: S * RING].view(S, RING)
