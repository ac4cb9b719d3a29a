"""The SPR rounds loop with the device screen on a torch device.

Copies of ``_parallel_update``, ``run_spr_rounds`` and
``_run_spr_rounds_body`` of :mod:`maple_tpu.search.spr` (:1358-1550).  The
only change is the ``--deviceTopology`` branch of ``_parallel_update``,
which runs :func:`maple_tpu_torch.parallel.batch_spr.device_topology_update`
on ``run.device``; everything below it (the serial crawl, the threaded and
forked passes, branch lengths, EM) is the shared host code.
"""
from __future__ import annotations

import time as _time
from typing import List

from maple_tpu.native.engine import (native_spr_supported,
                                     open_native_session,
                                     run_native_blen_loop,
                                     run_native_spr_parallel)
from maple_tpu.runtime.tree import count_dirty_nodes
from maple_tpu.search.blen import optimize_branch_lengths
from maple_tpu.search.parallel_spr import (assign_core_numbers,
                                           parallel_topology_update)
from maple_tpu.search.spr import SprCounters, start_topology_updates

from ..parallel.batch_spr import device_topology_update


def _parallel_update(run, params, abayes_on):
    """numCores>1 or --deviceTopology topology pass: the device screen,
    else the engine's threaded pass when the state allows it, else the
    reference-style fork path (maple_tpu/search/spr.py:1358-1387)."""
    rt = run.rt
    cfg = run.cfg
    tree = run.tree
    strict, fails, threshold, placement_thresh = params
    if cfg.device_topology and not abayes_on and not cfg.networkOutput:
        # device-screened proposals + the same serial re-validated apply;
        # SPRTA/network need the crawl's per-candidate posteriors and fall
        # through to the paths below
        return device_topology_update(rt, run.root, params, SprCounters(),
                                      device=run.device)
    if native_spr_supported(rt, abayes_on, cfg.networkOutput,
                            cfg.debugging):
        res = run_native_spr_parallel(rt, run.root, cfg.numCores, strict,
                                      fails, threshold, placement_thresh)
        if res is not None:
            return res
    if getattr(tree, "coreNum", None) is None:
        assign_core_numbers(tree, run.root, cfg.numCores)
    return parallel_topology_update(
        rt, run.root, params, SprCounters(), cfg.numCores,
        abayes_on=abayes_on, network_output=cfg.networkOutput)


def run_spr_rounds(run, rounds: List[tuple]):
    """SPR rounds + subrounds (reference :12241-12555), against one
    persistent native engine session where the configuration allows it
    (maple_tpu/search/spr.py:1390-1416)."""
    cfg = run.cfg
    rt = run.rt
    tree = run.tree
    abayes = cfg.SPRTA
    if abayes:
        tree.support = [None] * len(tree.up)
        if cfg.networkOutput:
            tree.alternativePlacements = [[] for _ in range(len(tree.up))]
    ses = None
    if run._native_session_eligible():
        ses = open_native_session(rt, run.root)
    try:
        _run_spr_rounds_body(run, rounds)
    finally:
        if ses is not None:
            ses.close()


def _run_spr_rounds_body(run, rounds):
    """maple_tpu/search/spr.py:1419-1550, calling this module's
    ``_parallel_update``."""
    cfg = run.cfg
    rt = run.rt
    tree = run.tree
    abayes = cfg.SPRTA
    for n_round, (strict, fails, threshold, placement_thresh) in \
            enumerate(rounds):
        abayes_on = abayes
        print(f"Starting topological improvement traversal number "
              f"{n_round + 1}", flush=True)
        start = _time.time()
        run._set_all_dirty(run.root)
        rt.recalculate_all(run.root)
        if not cfg.doNotOptimiseBLengths:
            lk = rt.calculate_tree_likelihood(run.root)
            print(f"Preliminary branch length optimization from LK: {lk}")
            sub_round = run_native_blen_loop(rt, run.root)
            if sub_round is None:
                improvement = optimize_branch_lengths(rt, run.root)
                sub_round = 0
                while sub_round < 20 and improvement:
                    sub_round += 1
                    improvement = optimize_branch_lengths(rt, run.root)
            lk = rt.calculate_tree_likelihood(run.root)
            print(f"branch length finalization subround {sub_round + 1} "
                  f"final LK: {lk}", flush=True)
        run._set_all_dirty(run.root)
        rt.recalculate_all(run.root)
        pre_lk = rt.calculate_tree_likelihood(run.root)
        print(f"Likelihood before SPR moves: {pre_lk}", flush=True)
        # the device screen cannot produce SPRTA posteriors: with SPRTA
        # requested and numCores 1 the pass stays serial
        parallelize = cfg.numCores > 1 \
            or (cfg.device_topology and not abayes_on)
        if parallelize:
            new_root, improvement = _parallel_update(
                run, (strict, fails, threshold, placement_thresh),
                abayes_on)
        else:
            new_root, improvement = start_topology_updates(
                rt, run.root, strict, fails, threshold, placement_thresh,
                check_each_spr=cfg.debugging, abayes_on=abayes_on,
                network_output=cfg.networkOutput)
        if new_root is not None:
            run.root = new_root
        run.timings["topology"] += _time.time() - start
        print(f"LK improvement apparently brought: {improvement}")
        rt.recalculate_all(run.root)
        post_lk = rt.calculate_tree_likelihood(run.root)
        print(f"Likelihood after SPR moves: {post_lk}")
        run.write_tree(f"_round{n_round + 1}_preliminary_tree.tree")

        # subrounds on nodes affected by changes
        start = _time.time()
        sub_round = 0
        while sub_round < 20:
            print(f"Topological subround {sub_round + 1}", flush=True)
            if parallelize:
                if rt.native_session is not None:
                    num_dirty, num_nodes = rt.native_session.count_dirty()
                else:
                    num_dirty, num_nodes = count_dirty_nodes(tree, run.root)
            if parallelize and num_dirty > 0.1 * num_nodes:
                new_root, improvement = _parallel_update(
                    run, (strict, fails, threshold, placement_thresh),
                    abayes_on)
            else:
                new_root, improvement = start_topology_updates(
                    rt, run.root, strict, fails, threshold,
                    placement_thresh, check_each_spr=cfg.debugging,
                    abayes_on=abayes_on,
                    network_output=cfg.networkOutput)
            if new_root is not None:
                run.root = new_root
            print(f"LK improvement apparently brought: {improvement}",
                  flush=True)
            if not cfg.noSubroundTrees:
                run.write_tree(f"_round{n_round + 1}_subround"
                               f"{sub_round + 1}_preliminary_tree.tree")
            if improvement < cfg.thresholdLogLKTopologySubRoundImprovement:
                break
            sub_round += 1
        rt.recalculate_all(run.root)
        post_lk = rt.calculate_tree_likelihood(run.root)
        print(f"Likelihood after SPR subrounds: {post_lk}", flush=True)
        run.timings["topology"] += _time.time() - start

        # EM + branch lengths after this round (reference :12397-12478)
        lk = rt.calculate_tree_likelihood(run.root)
        print(f"Initial LK before EM: {lk}", flush=True)
        run.run_em_step(rates_update="rounds")
        rt.recalculate_all(run.root)
        lk = rt.calculate_tree_likelihood(run.root)
        print(f"LK after one round of EM: {lk}")
        if cfg.estimateErrorRate or cfg.estimateSiteSpecificErrorRate:
            old_lk = float("-inf")
            num_steps = 0
            while lk - old_lk > 1.0 and num_steps < 20:
                if not cfg.doNotOptimiseBLengths:
                    run._set_all_dirty(run.root)
                    optimize_branch_lengths(rt, run.root)
                    rt.recalculate_all(run.root)
                run.run_em_step(rates_update="using")
                rt.recalculate_all(run.root)
                old_lk = lk
                lk = rt.calculate_tree_likelihood(run.root)
                num_steps += 1
        if not cfg.doNotOptimiseBLengths:
            rt.recalculate_all(run.root)
            run._set_all_dirty(run.root)
            improvement = optimize_branch_lengths(rt, run.root)
            sub_round = 0
            while sub_round < 20 and improvement:
                sub_round += 1
                improvement = optimize_branch_lengths(rt, run.root)
            rt.recalculate_all(run.root)
            lk = rt.calculate_tree_likelihood(run.root)
            print(f"branch length finalization final LK: {lk}")

        # EM round for the time-scaled mutation rate (reference
        # :12462-12480: unconditional first update, then continue while
        # the time LK improves by >0.1, max 20 steps)
        if rt.do_time_tree:
            run.run_time_em(f"SPR round {n_round + 1}")

        suffix = f"_round{n_round + 1}" if n_round < len(rounds) - 1 else ""
        run.write_outputs(suffix, from_rounds=True)
