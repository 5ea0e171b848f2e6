"""Row halo exchanges of the row-sharded frame: the only code of the port
that communicates (counterpart of the JAX package's `lax.ppermute` halos,
`ops/reproject.py:_gather2x2_halo` and `ops/svgf_pallas.py:_fill_pads`).

Rank r of a mesh of n owns image rows [r h, (r + 1) h) of an H = n h
row frame.  `exchange_rows` hands each rank the `top` image rows just
above its first row and the `bottom` rows just below its last, as one
batch of point-to-point sends and receives with its two neighbours
(`torch.distributed.batch_isend_irecv`); where a strip is longer than a
shard (a short shard) the strips come from one all-gather of every
rank's rows instead, so a rank reaches as many neighbours as it needs.
Rows past the image edge read zero.  Under NCCL the strips stay on the
card; gloo moves only host tensors, so under gloo each strip is copied to
host memory, exchanged and copied back to the rank's device.

`COUNTS` counts, for this rank, the exchanges (`calls`), the bytes of
its rows it sends (`bytes`; an all-gather's rows count once per
receiving rank), the host time spent inside the calls (`ms`: under gloo
it holds the copies to and from the device; under NCCL the transfer is
queued on the device and not waited for) and the all-reduces
(`all_reduces`).  A caller resets it with `reset_counts()` to read one
frame's."""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

COUNTS = {"calls": 0, "bytes": 0, "ms": 0.0, "all_reduces": 0}


def reset_counts() -> None:
    COUNTS.update(calls=0, bytes=0, ms=0.0, all_reduces=0)


def _wire(t, mesh):
    """The tensor as the backend moves it: on the card under NCCL, in host
    memory under gloo."""
    t = t.contiguous()
    return t if mesh.backend == "nccl" else t.cpu()


def _peer(mesh, r: int) -> int:
    return r if mesh.group is None else dist.get_global_rank(mesh.group, r)


def exchange_rows(planes, top: int, bottom: int, mesh):
    """planes (C, h, W): this rank's rows of C planes.  -> (above (C, top,
    W), below (C, bottom, W)): the image rows [r0 - top, r0) and
    [r1, r1 + bottom) around this rank's rows [r0, r1), zero where they lie
    past the image edge.  Every rank of the mesh calls it with the same
    `top` and `bottom`."""
    t0 = time.perf_counter()
    C, h, W = planes.shape
    n, r = mesh.size, mesh.rank
    dev = planes.device
    above = torch.zeros((C, top, W), dtype=planes.dtype, device=dev)
    below = torch.zeros((C, bottom, W), dtype=planes.dtype, device=dev)
    per_row = C * W * planes.element_size()
    if top <= h and bottom <= h:
        ops, recv = [], []
        if r > 0:  # the rank above: it sends its last `top` rows, takes our first `bottom`
            if top:
                buf = _wire(above, mesh)
                ops.append(dist.P2POp(dist.irecv, buf, _peer(mesh, r - 1), mesh.group))
                recv.append((above, buf))
            if bottom:
                ops.append(dist.P2POp(dist.isend, _wire(planes[:, :bottom], mesh),
                                      _peer(mesh, r - 1), mesh.group))
                COUNTS["bytes"] += bottom * per_row
        if r < n - 1:
            if top:
                ops.append(dist.P2POp(dist.isend, _wire(planes[:, h - top:], mesh),
                                      _peer(mesh, r + 1), mesh.group))
                COUNTS["bytes"] += top * per_row
            if bottom:
                buf = _wire(below, mesh)
                ops.append(dist.P2POp(dist.irecv, buf, _peer(mesh, r + 1), mesh.group))
                recv.append((below, buf))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for dst, buf in recv:
            if buf is not dst:
                dst.copy_(buf)
    else:
        # a short shard: one all-gather of every rank's rows, the strips cut
        # from the frame they make
        mine = _wire(planes, mesh)
        parts = [torch.empty_like(mine) for _ in range(n)]
        dist.all_gather(parts, mine, group=mesh.group)
        frame = torch.cat(parts, dim=1).to(dev)
        COUNTS["bytes"] += (n - 1) * h * per_row
        r0, r1, H = r * h, (r + 1) * h, n * h
        a0 = max(0, r0 - top)
        above[:, top - (r0 - a0):] = frame[:, a0:r0]
        b1 = min(H, r1 + bottom)
        below[:, :b1 - r1] = frame[:, r1:b1]
    COUNTS["calls"] += 1
    COUNTS["ms"] += (time.perf_counter() - t0) * 1e3
    return above, below


def extend_rows(planes, rows: int, mesh):
    """planes (C, h, W) with up to `rows` image rows of the neighbours on
    each side, none past the image edge: -> (ext (C, t + h + b, W), t),
    t and b the rows added above and below."""
    above, below = mesh.exchange(planes, rows, rows)
    h = planes.shape[1]
    r0 = mesh.rank * h
    t = min(rows, r0)
    b = min(rows, (mesh.size - 1 - mesh.rank) * h)
    return torch.cat([above[:, rows - t:], planes, below[:, :b]], dim=1), t


def all_reduce_sum(x, mesh):
    """The sum of `x` over the ranks (one all-reduce), on x's device."""
    buf = _wire(x, mesh)
    buf = buf.clone() if buf is x else buf
    dist.all_reduce(buf, group=mesh.group)
    COUNTS["all_reduces"] += 1
    return buf.to(x.device)


def all_gather_rows(x, mesh, dim: int = 0):
    """Every rank's rows of `x` along `dim`, concatenated in rank order, on
    x's device (one all-gather)."""
    mine = _wire(x, mesh)
    parts = [torch.empty_like(mine) for _ in range(mesh.size)]
    dist.all_gather(parts, mine, group=mesh.group)
    return torch.cat(parts, dim=dim).to(x.device)
