"""Scale-out over a (dp x cand) mesh of ``torch.distributed`` ranks.

The torch twin of :mod:`maple_tpu.parallel.mesh`, under the same function
names.  The JAX package shards one program's arrays over a
``jax.sharding.Mesh``; its multi-process form carries over unchanged:
**every rank runs the same deterministic pipeline and holds the identical
full host arrays**.  A rank owns one (dp, cand) coordinate and one device.
It uploads only its own shard (``put_global``), computes its
``[K / dp, N / cand]`` tile, and ``host_fetch`` all-gathers the tiles, so
that every rank ends with the same full ``[K, N]`` matrix, bit for bit,
and the serial decisions that follow stay replicated.

- query batches shard over the ``dp`` axis (data-parallel placement),
- the candidate-node axis shards over ``cand`` (each rank scores every
  query of its dp row against its slice of the tree's anchors),
- ``make_genome_mesh`` replaces ``cand`` by ``gen``: the per-site rate and
  error tables, the only O(lRef) state, shard along the genome.

A :class:`Mesh` carries its process group, the sub-group of each axis, the
rank's coordinates and its device; nothing here reads a default device, and
every collective names its group.  Collectives are issued in program order:
every rank must make the same calls in the same order (a rank that skips a
chunk blocks the others).  gloo moves CPU tensors and NCCL CUDA tensors, so
tiles are gathered on the mesh's device and copied to the host afterwards.
A mesh of one rank still goes through its group.

Pools and queries reach the scorers as packed field dicts (full arrays, or
``GlobalArray`` shards from ``put_global`` / ``shard_batch``) or as one
stacked ``GlobalArray`` in the pair kernel's layout (``[N, F, B1]`` /
``[K, 1, B2 * F]``, :mod:`maple_tpu_torch.ops.layout`), which the
interval-algebra scorers read through ``fields_view`` without a copy.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.append_batch import DeviceModel, _grid_scores_impl, _model_args
from ..ops.append_pairs import append_scores_prestacked, stack_fields
from ..ops.layout import NFIELDS, fields_view
from .stacked_pool import upload

_MODEL_ARRAYS = ("mut_matrix", "root_freqs", "site_rates", "error_rates",
                 "global_tot_rate", "tot_error")


class Mesh:
    """A 2-D grid of ranks: ``ranks[i, j]`` is the rank (within ``group``)
    at coordinate i of the first axis and j of the second."""

    def __init__(self, ranks: np.ndarray, axis_names: Tuple[str, str],
                 device: torch.device, group):
        self.axis_names = tuple(axis_names)
        self.ranks = ranks
        self.shape: Dict[str, int] = dict(zip(self.axis_names, ranks.shape))
        self.device = torch.device(device)
        self.group = group
        self.rank = dist.get_rank(group)
        where = np.argwhere(ranks == self.rank)
        if len(where) != 1:
            raise ValueError(f"rank {self.rank} is not on the mesh")
        self.coords: Dict[str, int] = dict(
            zip(self.axis_names, (int(c) for c in where[0])))
        # one sub-group per row and per column; every rank of the group
        # creates all of them, in the same order, and keeps its own two
        world = dist.get_process_group_ranks(group)
        self.axis_groups = {}
        for axis, lines in ((self.axis_names[1], ranks),
                            (self.axis_names[0], ranks.T)):
            for line in lines:
                g = dist.new_group([world[r] for r in line.tolist()])
                if self.rank in line:
                    self.axis_groups[axis] = g

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def coords_of(self, rank: int) -> Dict[str, int]:
        i, j = np.argwhere(self.ranks == rank)[0]
        return {self.axis_names[0]: int(i), self.axis_names[1]: int(j)}


class GlobalArray(NamedTuple):
    """One rank's shard of an array that is laid out over a mesh."""

    local: torch.Tensor     # this rank's shard, on mesh.device
    mesh: Mesh
    spec: tuple             # per dimension: a mesh axis name or None
    shape: tuple            # the whole array's shape


def _shard(mesh: Mesh, shape, spec, coords=None):
    """The slices of one rank's shard of an array of ``shape``."""
    coords = mesh.coords if coords is None else coords
    out = []
    for n, axis in zip(shape, tuple(spec) + (None,) * len(shape)):
        if axis is None:
            out.append(slice(None))
            continue
        parts = mesh.shape[axis]
        if n % parts:
            raise ValueError(f"a dimension of {n} does not divide over the "
                             f"{parts} ranks of mesh axis {axis!r}")
        step = n // parts
        out.append(slice(coords[axis] * step, (coords[axis] + 1) * step))
    return tuple(out)


def put_global(mesh: Mesh, arr, spec) -> GlobalArray:
    """This rank's shard of ``arr`` on the mesh's device.

    Every rank holds the identical full array (the replicated-tree
    contract: each rank runs the same deterministic pipeline) and uploads
    only the slice its coordinates own; an axis of ``spec`` that is None is
    replicated."""
    spec = tuple(spec)
    if isinstance(arr, torch.Tensor):
        local = arr[_shard(mesh, arr.shape, spec)].to(mesh.device)
    else:
        arr = np.asarray(arr)
        local = upload(arr[_shard(mesh, arr.shape, spec)], mesh.device)
    return GlobalArray(local, mesh, spec + (None,) * (arr.ndim - len(spec)),
                       tuple(arr.shape))


def host_fetch(x) -> np.ndarray:
    """Full host copy of a mesh-spanning array: the serial-apply fine phase
    runs on every rank with the complete score matrix, so decisions stay
    replicated.  The shards are all-gathered on the mesh's device (one
    collective over the whole group, a group of one rank included) and put
    together there; along a replicated axis the shard of coordinate 0 is
    taken."""
    if not isinstance(x, GlobalArray):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
    mesh = x.mesh
    local = x.local.contiguous()
    tiles = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(tiles, local, group=mesh.group)
    full = torch.empty(x.shape, dtype=local.dtype, device=local.device)
    for rank, tile in enumerate(tiles):
        coords = mesh.coords_of(rank)
        if any(c for axis, c in coords.items() if axis not in x.spec):
            continue
        full[_shard(mesh, x.shape, x.spec, coords)] = tile
    return full.cpu().numpy()


def replicate_model(mesh: Mesh, dm: DeviceModel) -> DeviceModel:
    """The model arrays on the mesh's device (every rank holds all of
    them)."""
    return dm._replace(**{name: getattr(dm, name).to(mesh.device)
                          for name in _MODEL_ARRAYS})


def _grid(n: int, first: int, names, device, group) -> Mesh:
    group = dist.group.WORLD if group is None else group
    world = dist.get_world_size(group)
    if n != world:
        raise ValueError(f"a mesh of {n} ranks over a group of {world}: "
                         f"every rank of the group takes part")
    if n % first:
        raise ValueError(f"{n} ranks do not divide by {names[0]}={first}")
    return Mesh(np.arange(n).reshape(first, n // first), names, device,
                group)


def mesh_factors(n: int, dp: Optional[int] = None) -> Tuple[int, int]:
    """(dp, cand) of a mesh of n ranks, as the JAX package factors it."""
    if dp is None:
        # favor data parallelism; use a cand axis when n has a factor
        dp = n
        for f in (2, 4):
            if n % f == 0 and n // f > 1:
                dp = n // 2
                break
    return dp, n // dp


def genome_mesh_factors(n: int, dp: Optional[int] = None) -> Tuple[int, int]:
    """(dp, gen) of a genome mesh of n ranks."""
    if dp is None:
        dp = 2 if (n % 2 == 0 and n > 2) else 1
    return dp, n // dp


def _group_size(group) -> int:
    return dist.get_world_size(dist.group.WORLD if group is None else group)


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None, *,
              device: torch.device, group=None) -> Mesh:
    """Build a 2D (dp, cand) mesh over the ranks of ``group`` (None: the
    group that ``init_process_group`` made); ``device`` is this rank's."""
    n = n_devices or _group_size(group)
    return _grid(n, mesh_factors(n, dp)[0], ("dp", "cand"), device, group)


def make_genome_mesh(n_devices: Optional[int] = None,
                     dp: Optional[int] = None, *, device: torch.device,
                     group=None) -> Mesh:
    """Build a 2D (dp, gen) mesh: queries shard data-parallel over ``dp``
    and the dense per-site tables shard over the genome axis ``gen``, the
    sequence-parallelism analogue of this workload (the genome lists are
    sparse O(#diffs) state, so the O(lRef) site-rate / error-rate tables
    are the only state worth sharding along the genome)."""
    n = n_devices or _group_size(group)
    return _grid(n, genome_mesh_factors(n, dp)[0], ("dp", "gen"), device,
                 group)


def shard_batch(mesh: Mesh, tree_pool: dict, queries: dict):
    """Place the packed node pool (sharded over cand) and the query batch
    (sharded over dp) onto the mesh."""
    return ({k: put_global(mesh, v, ("cand",)) for k, v in tree_pool.items()},
            {k: put_global(mesh, v, ("dp",)) for k, v in queries.items()})


# ----------------------------------------------------------------------
# this rank's operands

def _local(mesh: Mesh, v, axis):
    """This rank's shard along ``axis`` (None: replicated) of a full array
    or of a GlobalArray that is already laid out so."""
    if isinstance(v, GlobalArray):
        if v.mesh is not mesh or v.spec[0] != axis or any(v.spec[1:]):
            raise ValueError(f"an array laid out as {v.spec} where "
                             f"({axis!r}, None, ...) is needed")
        return v.local
    return put_global(mesh, v, (axis,)).local


def _local_fields(mesh: Mesh, X, axis, stacked_axis: int) -> dict:
    """This rank's pool (``stacked_axis`` -2) or queries (-1) as a packed
    field dict: a dict's values are sharded; a stacked GlobalArray is read
    through views."""
    if isinstance(X, dict):
        return {k: _local(mesh, v, axis) for k, v in X.items()}
    stk = _local(mesh, X, axis)
    if stacked_axis == -1:
        stk = stk.reshape(stk.shape[0], -1, NFIELDS)
    return fields_view(stk, stacked_axis)


def _local_stacked(mesh: Mesh, X, axis, stacked_axis: int, dm: DeviceModel):
    """This rank's pool [n, F, B1] or queries [k, 1, B2 * F] in the pair
    kernel's layout: a stacked GlobalArray as it is, a field dict stacked
    on the device (per call: a placer keeps its pool stacked)."""
    if isinstance(X, dict):
        stk = stack_fields(_local_fields(mesh, X, axis, stacked_axis),
                           dm.site_rates, dm.error_rates, stacked_axis)
    else:
        stk = _local(mesh, X, axis)
    if stacked_axis == -1:
        stk = stk.reshape(stk.shape[0], 1, -1)
    return stk.contiguous()


def _tile(mesh: Mesh, tile: torch.Tensor, spec) -> GlobalArray:
    return GlobalArray(tile, mesh, spec, tuple(
        n * (mesh.shape[axis] if axis else 1)
        for n, axis in zip(tile.shape, spec)))


def _k8_tile(mesh: Mesh, pool, queries, blens, tips, dm: DeviceModel):
    """This rank's [K / dp, N / cand] tile by the interval-algebra
    scorer."""
    dm = replicate_model(mesh, dm)
    return _grid_scores_impl(
        _local_fields(mesh, pool, "cand", -2),
        _local_fields(mesh, queries, "dp", -1), blens, tips,
        *_model_args(dm))


# ----------------------------------------------------------------------
# scorers

def placement_step(mesh: Mesh, pool, queries, blen, dm: DeviceModel):
    """Sharded (dp x cand) batched placement step; returns per-query best
    candidate index and score (GlobalArrays over ``dp``), plus the
    evidence scalar reduced over both axes.

    Each rank takes the max and argmax over its own candidates, then the
    pairs are gathered over ``cand``; ties go to the lowest global index,
    as one argmax over the whole row would resolve them."""
    tile = _k8_tile(mesh, pool, queries, blen, True, dm)
    score, idx = tile.max(dim=-1)
    idx = idx + mesh.coords["cand"] * tile.shape[1]
    cand = mesh.shape["cand"]
    scores = [torch.empty_like(score) for _ in range(cand)]
    idxs = [torch.empty_like(idx) for _ in range(cand)]
    dist.all_gather(scores, score, group=mesh.axis_groups["cand"])
    dist.all_gather(idxs, idx, group=mesh.axis_groups["cand"])
    # the first maximum along the cand axis: lower coordinates hold the
    # lower global indices
    best_score, j = torch.stack(scores).max(dim=0)
    best_idx = torch.stack(idxs).gather(0, j[None])[0]
    # both-axes sanity reduction (finite scores only), useful for
    # convergence traces; NOT an EM statistic
    total_evidence = torch.where(torch.isfinite(tile), tile, 0.0).sum()
    dist.all_reduce(total_evidence, op=dist.ReduceOp.SUM, group=mesh.group)
    return (_tile(mesh, best_idx, ("dp",)), _tile(mesh, best_score, ("dp",)),
            total_evidence)


def placement_scores(mesh: Mesh, pool, queries, blen, dm: DeviceModel):
    """Sharded (dp x cand) scoring returning the full [K, N] score matrix
    (each rank computes its dp x cand tile; ``host_fetch`` assembles the
    tiles for the serial-apply fine phase).  The mesh-parallel twin of
    ops.append_batch.grid_append_scores used by the legacy BatchedPlacer."""
    return _tile(mesh, _k8_tile(mesh, pool, queries, blen, True, dm),
                 ("dp", "cand"))


def spr_screen_scores(mesh: Mesh, pool, queries, blens, tips,
                      dm: DeviceModel):
    """Sharded (dp x cand) SPR screen scoring: K pruned-subtree queries
    (each at its own branch length / tip flag, dp-sharded) against the
    anchor pool (cand-sharded); returns the full [K, N] matrix for the
    host's subtree masking + serial apply (parallel/batch_spr.py)."""
    return _tile(mesh, _k8_tile(
        mesh, pool, queries, _local(mesh, blens, "dp"),
        _local(mesh, tips, "dp"), dm), ("dp", "cand"))


def placement_scores_genome_sharded(mesh: Mesh, pool, queries, blen,
                                    dm: DeviceModel):
    """Genome-axis-sharded scoring returning the full [K, N] score matrix.

    The per-site tables (``dm.site_rates`` / ``dm.error_rates``) are
    sharded over the ``gen`` mesh axis, so each rank holds lRef/G table
    entries; the sparse packed genome lists are replicated over ``gen``
    (candidate pool) / sharded over ``dp`` (queries).  Each rank runs the
    interval-algebra scorer but lets only union segments whose genome
    position falls inside its slice contribute (a contributing segment
    spans exactly one position: segment ownership is position ownership),
    then the per-(query, candidate) partial log-factor sums are summed
    over ``gen`` and the position-independent terms (blen * globalTotRate,
    the tip error total) are added once."""
    dm = replicate_model(mesh, dm)
    gen = mesh.shape["gen"]
    lRef = dm.site_rates.shape[0]
    span = -(-lRef // gen)
    pad = span * gen - lRef
    # pad tables to a multiple of the gen axis; padded positions are never
    # indexed (genome positions are < lRef)
    sr = torch.nn.functional.pad(dm.site_rates, (0, pad), value=1.0)
    er = torch.nn.functional.pad(dm.error_rates, (0, pad))
    off = mesh.coords["gen"] * span
    uer = dm.using_error_rate
    part = _grid_scores_impl(
        _local_fields(mesh, pool, None, -2),
        _local_fields(mesh, queries, "dp", -1), blen, True, dm.mut_matrix,
        dm.root_freqs, sr[off:off + span], er[off:off + span],
        dm.global_tot_rate, dm.tot_error, uer, gen_offset=off)
    dist.all_reduce(part, op=dist.ReduceOp.SUM,
                    group=mesh.axis_groups["gen"])
    score = part + torch.as_tensor(blen, dtype=part.dtype,
                                   device=part.device) * dm.global_tot_rate
    if uer:
        score = score + dm.tot_error
    return _tile(mesh, score, ("dp", None))


def placement_scores_pallas(mesh: Mesh, pool, queries, blen,
                            dm: DeviceModel):
    """Sharded (dp x cand) scoring through the pair kernel: each rank
    hands its query-rows x candidate-columns tile to
    ``append_scores_prestacked`` (the CUDA kernel on a card, its plain
    version on CPU tensors); ``host_fetch`` reassembles the full [K, N]
    matrix.  Model state is replicated."""
    dm = replicate_model(mesh, dm)
    dtype = dm.mut_matrix.dtype
    Pstk = _local_stacked(mesh, pool, "cand", -2, dm)
    Cflat = _local_stacked(mesh, queries, "dp", -1, dm)
    k = Cflat.shape[0]
    prm = torch.stack([
        torch.as_tensor(blen, dtype=dtype, device=mesh.device).expand(k),
        torch.ones(k, dtype=dtype, device=mesh.device),
        dm.global_tot_rate.expand(k), dm.tot_error.expand(k)],
        dim=-1).reshape(k, 1, 4).contiguous()
    tile = append_scores_prestacked(
        Pstk, Cflat, prm, dm.mut_matrix.reshape(1, 1, 16).contiguous(),
        dm.root_freqs.reshape(1, 1, 4).contiguous(),
        uer=dm.using_error_rate)
    return _tile(mesh, tile, ("dp", "cand"))
