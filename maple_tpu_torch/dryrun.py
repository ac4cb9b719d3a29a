"""Entry points: the single-device forward check and the multi-rank dry run
of the mesh.

The torch twin of the JAX package's ``__graft_entry__.py``, on data that is
in the repository (``tests/goldens/example_sub80.maple`` by default).  The
"flagship model" is the batched placement-likelihood scorer
(:mod:`maple_tpu_torch.ops.append_batch`): the forward step scores a query
genome against every candidate attachment point in one call.  The
multi-rank step shards queries over the ``dp`` mesh axis and candidate
nodes over ``cand`` (:mod:`maple_tpu_torch.parallel.mesh`).

    python3 -m maple_tpu_torch.dryrun

starts one NCCL rank for every CUDA card of this host (rank r on
``cuda:r``), runs :func:`dryrun_multichip` on each, and checks that every
rank ended on the same tree.  Without a card it exits with an error; the
CPU is used only when the caller names it:

    python3 -m maple_tpu_torch.dryrun --backend gloo --procs 4
"""
from __future__ import annotations

import argparse
import hashlib
import os
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLE = os.path.join(os.path.dirname(HERE), "tests", "goldens",
                       "example_sub80.maple")
RANK_TIMEOUT = 600.0     # seconds a rank of ``main`` may take
PLACEMENT_TOL = 1.0      # log-LK between the mesh placement and what it is
                         # held to


def _example_state(n_candidates=64, n_queries=8, budget=128, input=EXAMPLE):
    """Small real-data state: packed candidate/query genome lists and model
    arrays from an alignment in MAPLE format."""
    from .config import DerivedConfig, MapleConfig
    from .io.maple_format import read_maple_alignment
    from .core.genomelist import terminal_node_genome_list, shorten
    from .core import kernels as K
    from .ops import pack as OP
    from .refdata import Model, RefData

    ref, data = read_maple_alignment(input)
    refd = RefData.build(ref, model="GTR")
    model = Model.initial(refd, "GTR")
    cfg = MapleConfig()
    dc = DerivedConfig.build(cfg, refd.lRef)
    ctx = K.KernelCtx(refd, model, dc)
    names = list(data)
    tips = []
    for name in names[:n_candidates + n_queries]:
        v = terminal_node_genome_list(refd, data[name])
        shorten(v, dc.thresholdProb)
        tips.append(v)
    # candidate "upper" vectors: root-frame uppers of the first tips
    uppers = [K.root_vector_frame(ctx, v, dc.oneMutBLen, True)
              for v in tips[:n_candidates]]
    queries = tips[n_candidates:n_candidates + n_queries]
    P = OP.pack_genome_lists(uppers, refd.lRef, budget, False, np.float32)
    C = OP.pack_genome_lists(queries, refd.lRef, budget, False, np.float32)
    return refd, model, dc, P, C


def entry(device: torch.device, input=EXAMPLE):
    """Returns (fn, example_args): a forward step (batch placement scoring
    of one query against N candidates by the interval-algebra scorer) and
    arguments for it, on ``device``."""
    from .ops.append_batch import (_append_scores_impl, device_model_from,
                                   to_device)

    refd, model, dc, P, C = _example_state(input=input)
    dm = device_model_from(model, dc, device=device, dtype=torch.float32)
    P_dev = to_device(P, device=device)
    C_one = {k: v[0] for k, v in to_device(C, device=device).items()}

    def forward(P_arrays, C_arrays, blen, mm, rf, sr, er, gtr, te):
        return _append_scores_impl(P_arrays, C_arrays, blen, True, mm, rf,
                                   sr, er, gtr, te, False)

    example_args = (P_dev, C_one, dc.oneMutBLen, dm.mut_matrix,
                    dm.root_freqs, dm.site_rates, dm.error_rates,
                    dm.global_tot_rate, dm.tot_error)
    return forward, example_args


def _check(ok: bool, what):
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def placed(run) -> int:
    """Samples accounted for: the leaves still attached to the root, with
    their minor sequences."""
    tree = run.tree
    n = 0
    for node in range(len(tree.up)):
        if tree.children[node]:
            continue
        p, hops = node, 0
        while p is not None and hops <= len(tree.up):
            if p == run.root:
                n += 1 + len(tree.minorSequences[node])
                break
            p = tree.up[p]
            hops += 1
    return n


def tree_signature(run) -> str:
    """A digest of the run's tree (topology, branch lengths, minor
    sequences): equal on two ranks only if they decided the same."""
    tree = run.tree
    h = hashlib.sha256()
    h.update(repr((run.root, tree.up, tree.children, tree.dist,
                   tree.minorSequences)).encode())
    return h.hexdigest()


PLACERS = ("proxy", "legacy")


def dryrun_multichip(mesh, input=EXAMPLE, use_pallas: bool = False,
                     warmup: int = 48, batch_size: int = 16,
                     reference_lk: float | None = None,
                     placer: str = "proxy") -> dict:
    """Run the device-batched placement pipeline over ``mesh`` on ``input``
    (every rank of the mesh calls this): a serial warmup builds a real
    tree, then every remaining batch is screened with the candidate axis
    sharded over ``cand`` and applied serially on the host with
    re-validation (the reference's search-parallel / apply-serial
    contract, MAPLEv0.7.5.4.py:9470-9484).  Then one device-screened SPR
    pass over the same mesh, and the genome-axis-sharded scorer against
    the replicated-table scorer.

    ``placer`` picks the placement: ``"proxy"`` (the default, the JAX
    package's path with default flags: the proxy screen's feature pool
    sharded by candidate, the C++ engine's seeded placement; ``use_pallas``
    does not apply to it) or ``"legacy"`` (``MAPLE_DEVICE_LEGACY=1`` for
    the placement: the batch placer's scorer tiled (dp x cand), the pair
    kernel with ``use_pallas``, else the interval-algebra scorer).

    Asserts that the tree accounts for every sample, that its likelihood
    is within ``PLACEMENT_TOL`` of the serial stepwise path's (reported
    exactly; on the example the batched path reproduces the serial
    decisions), that the SPR pass does not lower it, and that the two
    scorers agree.  On thousands of samples the legacy placer is known to
    land a few log-units off serial: there the caller gives
    ``reference_lk``, the placement likelihood of the single-device legacy
    placer on the same input and scorer, and the mesh run is held to that
    instead.  Returns what it measured."""
    from .config import MapleConfig
    from .pipeline import Run
    from .ops.append_pairs import append_scores_prestacked

    if placer not in PLACERS:
        raise ValueError(f"placer {placer!r} (one of {PLACERS})")
    out = {"mesh": dict(mesh.shape), "rank": mesh.rank,
           "use_pallas": bool(use_pallas), "placer": placer}
    saved = os.environ.pop("MAPLE_DEVICE_LEGACY", None)
    if placer == "legacy":
        os.environ["MAPLE_DEVICE_LEGACY"] = "1"
    launches0 = append_scores_prestacked.launches
    try:
        with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
            # sharded run: serial warmup, then sharded batches
            cfg = MapleConfig(input=input,
                              output=os.path.join(tmp, f"dev{mesh.rank}"),
                              model="GTR", overwrite=True,
                              device_placement=True,
                              device_pallas=bool(use_pallas))
            run_dev = Run(cfg, mesh.device)
            run_dev.load()
            run_dev.build_initial_tree_device(warmup=warmup,
                                              batch_size=batch_size,
                                              mesh=mesh)
            ran = run_dev.proxy_placer if placer == "proxy" \
                else run_dev.legacy_placer
            _check(ran is not None and ran.pool.mesh is mesh,
                   f"the {placer} placer did not run over the mesh")
            run_dev.rt.recalculate_all(run_dev.root)
            lk_dev = run_dev.rt.calculate_tree_likelihood(run_dev.root)
            out["placement_launches"] = \
                append_scores_prestacked.launches - launches0

            # serial reference path on the same data
            cfg_s = MapleConfig(input=input,
                                output=os.path.join(tmp, f"ser{mesh.rank}"),
                                model="GTR", overwrite=True)
            run_ser = Run(cfg_s, mesh.device)
            run_ser.load()
            run_ser.build_initial_tree()
            run_ser.rt.recalculate_all(run_ser.root)
            lk_ser = run_ser.rt.calculate_tree_likelihood(run_ser.root)
    finally:
        os.environ.pop("MAPLE_DEVICE_LEGACY", None)
        if saved is not None:
            os.environ["MAPLE_DEVICE_LEGACY"] = saved

    n_dev, n_ser = placed(run_dev), placed(run_ser)
    _check(n_dev == n_ser, f"placed {n_dev}, serial placed {n_ser}")
    # the batched path reproduces the serial decisions on the example
    # (stale-anchor masking + touched-node host re-scoring + serial
    # model-refresh cadence); the gate is absolute log-LK, not a percentage
    against = "serial" if reference_lk is None else "the reference"
    lk_ref = lk_ser if reference_lk is None else reference_lk
    _check(abs(lk_dev - lk_ref) <= PLACEMENT_TOL,
           f"placement LK {lk_dev} against {against} {lk_ref}")
    n_mat = sum(1 for m in run_dev.tree.mutations if m)
    print(f"dryrun_multichip: mesh {dict(mesh.shape)}; placed {n_dev} "
          f"samples via sharded batches (MAT frames: {n_mat}); LK sharded "
          f"{lk_dev:.3f} vs serial {lk_ser:.3f}", flush=True)
    out.update(placed=n_dev, lk_placement=lk_dev, lk_serial=lk_ser,
               minors=run_dev.stats.num_minors_found,
               minors_serial=run_ser.stats.num_minors_found,
               placement_signature=tree_signature(run_dev))

    # --deviceTopology over the same mesh: one device-screened SPR pass
    # (proposal search sharded dp x cand, serial re-validated apply)
    from .parallel.batch_spr import device_topology_update
    from .runtime.tree import set_all_dirty
    from .search.spr import SprCounters
    set_all_dirty(run_dev.tree, run_dev.root)
    params = (cfg.strictTopologyStopRules, cfg.allowedFailsTopology,
              run_dev.dc.thresholdLogLKtopology,
              cfg.thresholdTopologyPlacement)
    new_root, improvement = device_topology_update(
        run_dev.rt, run_dev.root, params, counters=SprCounters(),
        device=mesh.device, mesh=mesh, use_pallas=bool(use_pallas))
    if new_root is not None:
        run_dev.root = new_root
    run_dev.rt.recalculate_all(run_dev.root)
    lk_spr = run_dev.rt.calculate_tree_likelihood(run_dev.root)
    _check(lk_spr >= lk_dev - 1e-6,
           f"the SPR pass lowered the LK: {lk_dev} -> {lk_spr}")
    print(f"dryrun_multichip: device SPR screen over the mesh applied "
          f"improvement {improvement:.3f}; LK {lk_spr:.3f}", flush=True)
    out.update(lk_spr=lk_spr, spr_improvement=improvement,
               signature=tree_signature(run_dev),
               launches=append_scores_prestacked.launches - launches0)

    # genome-axis-sharded scorer (the sequence-parallel analogue): the
    # per-site tables shard over ``gen``; scores must match the
    # replicated-table scorer in f32
    from .ops.append_batch import (device_model_from, grid_append_scores,
                                   to_device)
    from .parallel.mesh import (host_fetch, make_genome_mesh,
                                placement_scores_genome_sharded)
    refd, model, dcx, P, C = _example_state(n_candidates=32, n_queries=8,
                                            input=input)
    dm = device_model_from(model, dcx, device=mesh.device,
                           dtype=torch.float32)
    P_dev = to_device(P, device=mesh.device)
    C_dev = to_device(C, device=mesh.device)
    gmesh = make_genome_mesh(mesh.size, device=mesh.device, group=mesh.group)
    sharded = host_fetch(placement_scores_genome_sharded(
        gmesh, P_dev, C_dev, dcx.oneMutBLen, dm))
    dense = grid_append_scores(P_dev, C_dev, dcx.oneMutBLen, True,
                               dm).cpu().numpy()
    worst = float(np.max(np.abs(sharded - dense)))
    _check(np.allclose(sharded, dense, atol=1e-4),
           f"genome-sharded scores differ from dense by {worst}")
    print(f"dryrun_multichip: genome-sharded scorer over mesh "
          f"{dict(gmesh.shape)} matches the replicated scorer "
          f"(max |d|={worst:.2e})", flush=True)
    out.update(genome_mesh=dict(gmesh.shape), genome_max_abs_diff=worst)
    return out


def _rank_entry(rank, device, input, use_pallas, warmup, batch_size, placer):
    """One rank of ``main``: the forward step on its device, then the dry
    run over the mesh of all ranks."""
    from .parallel.mesh import make_mesh
    fn, args = entry(device, input=input)
    first = fn(*args)[:4].cpu().numpy()
    if rank == 0:
        print("entry() forward:", first, "...", flush=True)
    mesh = make_mesh(device=device)
    return dryrun_multichip(mesh, input=input, use_pallas=use_pallas,
                            warmup=warmup, batch_size=batch_size,
                            placer=placer)


def main(argv=None) -> int:
    from .parallel.ranks import backend_error, card_count, run_ranks
    ap = argparse.ArgumentParser(
        prog="python3 -m maple_tpu_torch.dryrun", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                    help="nccl: rank r on cuda:r (the default); gloo: "
                    "every rank on the CPU")
    ap.add_argument("--procs", type=int, default=None,
                    help="ranks to start (default: one for every CUDA "
                    "card; with gloo, 4)")
    ap.add_argument("--input", default=EXAMPLE,
                    help="alignment in MAPLE format")
    ap.add_argument("--placer", choices=PLACERS, default="proxy",
                    help="proxy: the proxy screen's pool sharded by "
                    "candidate (the default); legacy: the batch placer's "
                    "scorer tiled over the mesh")
    ap.add_argument("--pallas", action="store_true",
                    help="score the legacy placer's tiles and the mesh SPR "
                    "screen with the pair kernel")
    ap.add_argument("--warmup", type=int, default=48)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--timeout", type=float, default=RANK_TIMEOUT,
                    help="seconds every rank may take")
    args = ap.parse_args(argv)
    if args.procs is None:
        args.procs = card_count() if args.backend == "nccl" else 4
    err = backend_error(args.backend, args.procs)
    if err:
        print(f"dryrun: {err}", file=sys.stderr)
        return 2
    results = run_ranks(_rank_entry, args.procs, backend=args.backend,
                        timeout=args.timeout,
                        args=(args.input, args.pallas, args.warmup,
                              args.batch_size, args.placer))
    same = {r["signature"] for r in results}
    if len(same) != 1:
        print(f"dryrun: the ranks ended on {len(same)} different trees",
              file=sys.stderr)
        return 1
    r = results[0]
    print(f"dryrun: {args.procs} {args.backend} ranks, mesh {r['mesh']}, "
          f"{r['placer']} placer: "
          f"every rank on the same tree; placement LK {r['lk_placement']} "
          f"(serial {r['lk_serial']}), after the SPR pass {r['lk_spr']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
