"""H-axis (spatial) sharding with explicit halos, and the shard layout of
the flat scales.

Port of ``msau_tpu.parallel.spatial``.  The chargrid's rows are this
workload's sequence: an image's H is cut into ``sp`` blocks of rows, and
an op that reads ``top`` rows above and ``bottom`` rows below a pixel runs
on its block extended by those rows of the neighbouring blocks (zeros at
the image's true edges: TF-SAME padding), then the extra rows are
dropped.  The extension is differentiable, so a halo row's gradient goes
back to the block that owns the row.

  * ``halo_exchange``: a rank's block [N, C, Hs, W] gains rows from the
    ranks above and below it in a process group (``dist.batch_isend_irecv``);
    its backward sends each halo row's gradient to its owner and adds it.
  * ``sharded_conv2d``: a SAME conv with H split over a group: the halo
    exchange, then a conv that is VALID in H (``F.conv2d``: the JAX package
    runs ``lax.conv`` here too, outside any Pallas kernel).
  * ``spatial_shardings``: the slices a rank takes of the input and the
    label.
  * ``SpatialShards``: the layout the model's flat scales run in, with its
    halos from one of two sources on one code path: the neighbouring
    entries of the batch axis (all ``sp`` blocks of an image in one
    process, shard-major, as the JAX package's ``FlatGeom.sp``), or the
    neighbouring ranks of a spatial group (one block per rank).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F


def _swap(up: torch.Tensor, down: torch.Tensor, group):
    """Send ``up`` to the rank above (index i - 1 in ``group``) and
    ``down`` to the rank below -> (what the rank below sent up, what the
    rank above sent down); None at the group's edges.  Empty tensors are
    not sent (their sizes are the same on every rank)."""
    ranks = dist.get_process_group_ranks(group)
    i, n = dist.get_rank(group), len(ranks)
    ops, from_below, from_above = [], None, None
    if i > 0 and down.shape[2]:
        from_above = down.new_empty(down.shape)
        ops.append(dist.P2POp(dist.irecv, from_above, ranks[i - 1], group))
    if i > 0 and up.shape[2]:
        ops.append(dist.P2POp(dist.isend, up.contiguous(), ranks[i - 1],
                              group))
    if i < n - 1 and up.shape[2]:
        from_below = up.new_empty(up.shape)
        ops.append(dist.P2POp(dist.irecv, from_below, ranks[i + 1], group))
    if i < n - 1 and down.shape[2]:
        ops.append(dist.P2POp(dist.isend, down.contiguous(), ranks[i + 1],
                              group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_below, from_above


def _rows(x: torch.Tensor, r: int, like: Optional[torch.Tensor]) -> torch.Tensor:
    """``like`` or, at an image edge (None), ``r`` zero rows."""
    if like is not None:
        return like
    return x.new_zeros(x.shape[:2] + (r,) + x.shape[3:])


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, top, bottom, group):
        ctx.top, ctx.bottom, ctx.group = top, bottom, group
        hs = x.shape[2]
        if top > hs or bottom > hs:
            raise ValueError(f"halo ({top}, {bottom}) is more than a "
                             f"block's {hs} rows")
        from_below, from_above = _swap(x[:, :, :bottom], x[:, :, hs - top:],
                                       group)
        return torch.cat([_rows(x, top, from_above), x,
                          _rows(x, bottom, from_below)], dim=2)

    @staticmethod
    def backward(ctx, g):
        top, bottom = ctx.top, ctx.bottom
        hs = g.shape[2] - top - bottom
        # the top halo's rows belong to the rank above, the bottom's below
        from_below, from_above = _swap(g[:, :, :top], g[:, :, top + hs:],
                                       ctx.group)
        dx = g[:, :, top:top + hs].clone()
        if from_above is not None:
            dx[:, :, :bottom] += from_above
        if from_below is not None:
            dx[:, :, hs - top:] += from_below
        return dx, None, None, None


def halo_exchange(x: torch.Tensor, halo, group) -> torch.Tensor:
    """Pad this rank's [N, C, Hs, W] block with ``halo`` rows (an int, or
    (top, bottom)) from the ranks above and below it in ``group``; the
    group's first and last ranks pad the image's edge with zeros."""
    top, bottom = (halo, halo) if isinstance(halo, int) else halo
    if top == 0 and bottom == 0:
        return x
    return _HaloExchange.apply(x, int(top), int(bottom), group)


def sharded_conv2d(x: torch.Tensor, kernel: torch.Tensor, group) -> torch.Tensor:
    """SAME conv of this rank's [N, C, Hs, W] block of an image whose H is
    split over ``group`` (rank order = row order), ``kernel`` OIHW with an
    odd height: the halo exchange, then a conv VALID in H and SAME in W
    (the extra column at right)."""
    kh, kw = kernel.shape[-2:]
    if kh % 2 != 1:
        raise ValueError(f"sharded_conv2d needs an odd kernel height, got {kh}")
    xe = halo_exchange(x, kh // 2, group)
    xe = F.pad(xe, ((kw - 1) // 2, kw // 2)) if kw > 1 else xe
    return F.conv2d(xe, kernel)


def spatial_shardings(mesh, batch_axis: str = "data",
                      spatial_axis: str = "spatial"):
    """(input, label) slices a rank takes for spatial training: NHWC
    inputs and [N, H, W] labels, batch over ``batch_axis``, H over
    ``spatial_axis``."""
    from msau_tpu_torch.parallel.sharding import spatial_sharding

    return (spatial_sharding(mesh, 4, batch_axis, spatial_axis),
            spatial_sharding(mesh, 3, batch_axis, spatial_axis))


class _GatherRows(torch.autograd.Function):
    """The blocks of a group, joined along H (dim 2) in rank order; the
    backward sums the gradient over the group (each rank's holds only its
    own loss's share) and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=2)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        n = dist.get_world_size(ctx.group)
        hs = g.shape[2] // n
        i = dist.get_rank(ctx.group)
        return g[:, :, i * hs:(i + 1) * hs], None


class _TakeRows(torch.autograd.Function):
    """This rank's block of rows of a tensor every rank of the group holds
    whole; the backward places the gradient at those rows (the sum over
    the group happens where the whole tensor was gathered)."""

    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        if x.shape[2] % n:
            raise ValueError(f"H {x.shape[2]} does not split over {n} ranks")
        hs = x.shape[2] // n
        ctx.i, ctx.hs, ctx.shape = dist.get_rank(group), hs, x.shape
        return x[:, :, ctx.i * hs:(ctx.i + 1) * hs].contiguous()

    @staticmethod
    def backward(ctx, g):
        dx = g.new_zeros(ctx.shape)
        dx[:, :, ctx.i * ctx.hs:(ctx.i + 1) * ctx.hs] = g
        return dx, None


class SpatialShards:
    """How the flat scales' tensors cut each image's H into ``shards``
    blocks, and where a block's halos come from.

    With no ``group``, all blocks sit on this process's batch axis in
    shard-major order: [sp*N, C, H/sp, W], entry i*N + j holding rows
    block i of image j (``split_spatial``), and a block's halo rows come
    from its neighbouring entries.  With a ``group`` of ``shards`` ranks
    (rank order = row order), a rank holds its one block [N, C, H/sp, W]
    and its halos come from ``halo_exchange``.  ``shards`` 1 (or a group
    of one rank) is no sharding.

    "Global" below is the whole image in one process, and this rank's
    block under a group (its input is already its rows: ``shard_batch``);
    ``enter`` / ``leave`` move between that and the blocks, ``merge`` /
    ``split`` between the blocks and the whole image of the deep scales.
    """

    def __init__(self, shards: int = 1):
        if shards < 1:
            raise ValueError(f"spatial shards {shards} < 1")
        self.base = self.shards = shards
        self.group = None

    def set_group(self, group) -> None:
        """One block per rank of ``group``; None: back to ``shards`` blocks
        of each image on the batch axis."""
        self.group = group
        self.shards = self.base if group is None else dist.get_world_size(
            group)

    @property
    def active(self) -> bool:
        return self.shards > 1

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return split_spatial(x, self.shards) if self.group is None else x

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        return merge_spatial(x, self.shards) if self.group is None else x

    def merge(self, x: torch.Tensor) -> torch.Tensor:
        """The blocks -> the whole image (into the deep scales)."""
        if self.group is None:
            return merge_spatial(x, self.shards)
        return _GatherRows.apply(x, self.group)

    def split(self, x: torch.Tensor) -> torch.Tensor:
        """The whole image -> the blocks (back into the flat scales)."""
        if self.group is None:
            return split_spatial(x, self.shards)
        return _TakeRows.apply(x, self.group)

    def extend(self, x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
        """Each block with ``top`` rows of the block above and ``bottom``
        of the block below (zeros at the image's edges)."""
        if top == 0 and bottom == 0:
            return x
        if self.group is not None:
            return halo_exchange(x, (top, bottom), self.group)
        ne, c, hs, w = x.shape
        if top > hs or bottom > hs:
            raise ValueError(f"halo ({top}, {bottom}) is more than a "
                             f"block's {hs} rows")
        xs = x.reshape(self.shards, ne // self.shards, c, hs, w)
        parts = []
        if top:
            parts.append(torch.cat([xs.new_zeros(xs[:1, :, :, :top].shape),
                                    xs[:-1, :, :, hs - top:]], dim=0))
        parts.append(xs)
        if bottom:
            parts.append(torch.cat([xs[1:, :, :, :bottom],
                                    xs.new_zeros(xs[:1, :, :, :bottom].shape)],
                                   dim=0))
        return torch.cat(parts, dim=3).reshape(ne, c, hs + top + bottom, w)

    def halo(self, fn: Callable, xs: Sequence[torch.Tensor], top: int,
             bottom: int, scale: int = 1) -> torch.Tensor:
        """``fn`` of the blocks ``xs`` extended by (top, bottom) rows, its
        output cropped back to the blocks' rows; ``scale`` is the op's
        output rows per input row (2 for the stride-2 deconv)."""
        hs = xs[0].shape[2]
        y = fn(*(self.extend(x, top, bottom) for x in xs))
        return y[:, :, top * scale:(top + hs) * scale].contiguous()


def split_spatial(x: torch.Tensor, sp: int) -> torch.Tensor:
    """NCHW [N, C, H, W] -> shard-major [sp*N, C, H/sp, W]: entry i*N + j
    holds rows block i of image j (``msau_tpu.models.flat_layers.
    split_spatial`` on NCHW)."""
    if sp == 1:
        return x
    n, c, h, w = x.shape
    if h % sp:
        raise ValueError(f"H {h} does not split into {sp} shards")
    xs = x.reshape(n, c, sp, h // sp, w).permute(2, 0, 1, 3, 4)
    return xs.reshape(sp * n, c, h // sp, w)


def merge_spatial(x: torch.Tensor, sp: int) -> torch.Tensor:
    """Inverse of ``split_spatial``: [sp*N, C, Hs, W] -> [N, C, sp*Hs, W]."""
    if sp == 1:
        return x
    ne, c, hs, w = x.shape
    if ne % sp:
        raise ValueError(f"{ne} entries do not hold {sp} shards each")
    xs = x.reshape(sp, ne // sp, c, hs, w).permute(1, 2, 0, 3, 4)
    return xs.reshape(ne // sp, c, sp * hs, w)
