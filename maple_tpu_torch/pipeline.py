"""The inference pipeline with its device stages on a torch device.

``Run`` is :class:`maple_tpu.pipeline.Run` with the device stages
re-written for PyTorch: the pipelined branch of ``--devicePlacement``
and the single-device ``--deviceTopology`` SPR screen.  Every other
stage (loading, EM, root search, the host SPR crawl, outputs) is the
shared host engine.  Of ``--devicePlacement``'s three branches only the
pipelined one is ported; the other two raise instead of falling back to
host placement.
"""
from __future__ import annotations

import os

import torch

from maple_tpu import pipeline as base
from maple_tpu.config import MapleConfig
from maple_tpu.native.engine import native_engine_supported
from maple_tpu.runtime.partials import TreeRuntime
from maple_tpu.runtime.tree import PhyloTree, give_internal_node_names
from maple_tpu.search.placement import (find_best_parent_for_new_sample,
                                        place_sample_on_tree)

PROXY_NOT_PORTED = (
    "maple_tpu_torch: the proxy-screen branch of --devicePlacement (native "
    "kernels, no active error model) is not ported yet; ROADMAP.md Queue 1 "
    "item 2 ports it.  Set MAPLE_DEVICE_RT=1 to select the ported "
    "pipelined branch.")
LEGACY_NOT_PORTED = (
    "maple_tpu_torch: the legacy/mesh branch of --devicePlacement (a mesh "
    "or MAPLE_DEVICE_LEGACY) is not ported yet; ROADMAP.md Queue 1 items "
    "5 and 6 port it.  Set MAPLE_DEVICE_RT=1 without MAPLE_DEVICE_LEGACY "
    "to select the ported pipelined branch.")


class Run(base.Run):
    """One inference run whose device stages run on ``device``."""

    def __init__(self, cfg: MapleConfig, device: torch.device):
        super().__init__(cfg)
        self.device = torch.device(device)
        self.pplacer = None   # kept for phase attribution

    def build_initial_tree_device(self, warmup: int = 256,
                                  batch_size: int = 64, mesh=None):
        """Host-serial warmup, then the pipelined device placer (see
        maple_tpu_torch.parallel.pipelined_placer).  Mirrors
        maple_tpu.pipeline.Run.build_initial_tree_device branch for
        branch."""
        from .parallel.pipelined_placer import PipelinedPlacer
        cfg = self.cfg
        distances = self.sorted_distances()
        first_key, first_sample = distances.pop()
        self.names_in_tree.append(first_sample)
        tree = PhyloTree(use_hnz=bool(cfg.HnZ))
        tree.add_node()
        tree.name[-1] = 0
        self.tree = tree
        self.rt = TreeRuntime(tree, self.refd, self.model, self.dc, cfg)
        t1 = 0
        if self.rt.kern.name == "native" \
                and native_engine_supported(self) \
                and not self.model.using_error_rate \
                and not os.environ.get("MAPLE_DEVICE_LEGACY") \
                and not os.environ.get("MAPLE_DEVICE_RT"):
            raise NotImplementedError(PROXY_NOT_PORTED)
        if mesh is not None or os.environ.get("MAPLE_DEVICE_LEGACY"):
            raise NotImplementedError(LEGACY_NOT_PORTED)
        tree.probVect[0] = self.rt.terminal_vector(self.data[first_sample])
        self.data[first_sample] = None
        num_samples = 1
        upd = cfg.updateSubstMatrixEveryThisSamples
        while distances and num_samples < warmup:
            if cfg.model != "JC" and num_samples % upd == 0:
                self.model.update_from_pseudo_counts()
            _, sample = distances.pop()
            self.names_in_tree.append(sample)
            new_partials = self.rt.terminal_vector(self.data[sample])
            self.data[sample] = None
            best_node, best_score, best_blens, best_vect = \
                find_best_parent_for_new_sample(
                    self.rt, t1, new_partials, num_samples, self.stats)
            if best_blens is not None:
                new_root = place_sample_on_tree(
                    self.rt, best_node, best_vect, num_samples,
                    best_score, best_blens[0], best_blens[1],
                    best_blens[2], self.model.pseudo_counts, self.stats)
                if new_root is not None:
                    t1 = new_root
            num_samples += 1

        def stream():
            nonlocal num_samples
            while distances:
                _, sample = distances.pop()
                self.names_in_tree.append(sample)
                v = self.rt.terminal_vector(self.data[sample])
                self.data[sample] = None
                yield (num_samples, v)
                num_samples += 1

        pplacer = PipelinedPlacer(
            self.rt, self.stats, self.device, batch_size=batch_size,
            expected_samples=len(distances) + num_samples)
        self.pplacer = pplacer
        t1 = pplacer.place_all(
            t1, stream(),
            refresh_every=(upd if cfg.model != "JC" else 0),
            n_placed=num_samples)
        self.root = t1
        self.timings["finding"] += (pplacer.time_scoring
                                    + pplacer.time_fine)
        self.timings["placing"] += pplacer.time_apply
        print("Device-batched sample placement completed", flush=True)

    def run(self):
        """Full pipeline: de-novo or online inference.  A copy of
        maple_tpu.pipeline.Run.run (maple_tpu/pipeline.py:1079-1176) whose
        SPR rounds are this package's (maple_tpu_torch.search.spr)."""
        cfg = self.cfg
        if cfg.assignmentFile or cfg.assignmentFileCSV:
            from maple_tpu.analysis.lineages import \
                run_lineage_assignment_mode
            run_lineage_assignment_mode(cfg)
            return
        if cfg.inputRFtrees:
            from maple_tpu.analysis.rf import run_rf_mode
            out = run_rf_mode(cfg)
            print(f"RF distances written to {out}")
            return
        if os.path.isfile(cfg.output + "_tree.tree") and not cfg.overwrite:
            raise FileExistsError(
                f"{cfg.output}_tree.tree exists; use overwrite")
        self.load()
        if cfg.inputTree:
            self.setup_input_tree()
        if cfg.findSamplePlacements:
            if not cfg.inputTree:
                raise ValueError("--findSamplePlacements requires "
                                 "--inputTree")
            from maple_tpu.analysis.placements import \
                find_sample_placements_mode
            find_sample_placements_mode(self)
            return
        if cfg.lineageRefs:
            if not cfg.inputTree:
                raise ValueError("--lineageRefs requires --inputTree")
            from maple_tpu.analysis.placements import (
                assign_lineages_by_reference_placement)
            from maple_tpu.io.maple_format import read_maple_alignment
            ref2, lineage_data = read_maple_alignment(cfg.lineageRefs)
            if ref2 != self.refd.ref:
                raise ValueError("lineage reference genome differs from "
                                 "the alignment reference")
            assign_lineages_by_reference_placement(self, lineage_data)
            return
        if getattr(cfg, "device_placement", False) and not cfg.inputTree:
            self.build_initial_tree_device(
                warmup=cfg.device_warmup, batch_size=cfg.device_batch_size)
        else:
            self.build_initial_tree()
        self.post_placement()

        if not cfg.doNotReroot:
            from maple_tpu.search.rootsearch import find_best_root
            print("Looking for possible better root", flush=True)
            new_t1 = find_best_root(self.rt, self.root,
                                    abayes_on=cfg.SPRTA)
            if new_t1 != self.root:
                self.root = new_t1
                self._after_reroot()

        if cfg.writeTreesToFileEveryTheseSteps > 0 \
                or cfg.writeLKsToFileEveryTheseSteps > 0:
            self.rt.trace = base.TraceState(cfg, self.names_in_tree)
            self.rt.trace.initial_snapshot(self.rt, self.root)

        give_internal_node_names(self.tree, self.root,
                                 names_in_tree=self.names_in_tree,
                                 replace_names=False)

        # SPR rounds (reference :12149-12160: full rounds only for de-novo,
        # largeUpdate, or SPRTA runs)
        rounds = []
        if cfg.fastTopologyInitialSearch:
            rounds.append((cfg.strictTopologyStopRulesInitial,
                           cfg.allowedFailsTopologyInitial,
                           self.dc.thresholdLogLKtopologyInitial,
                           cfg.thresholdTopologyPlacementInitial))
        if not cfg.inputTree or cfg.largeUpdate or cfg.SPRTA:
            for _ in range(cfg.numTopologyImprovements):
                rounds.append((cfg.strictTopologyStopRules,
                               cfg.allowedFailsTopology,
                               self.dc.thresholdLogLKtopology,
                               cfg.thresholdTopologyPlacement))
        if rounds:
            from .search.spr import run_spr_rounds
            run_spr_rounds(self, rounds)
        else:
            self.write_outputs()
        trace = getattr(self.rt, "trace", None)
        if trace is not None:
            trace.close()
        print("Number of final references in the MAT: "
              + str(self.rt.num_refs), flush=True)
        print("Time spent finding placement nodes: "
              + str(self.timings["finding"]))
        print("Time spent placing samples on the tree: "
              + str(self.timings["placing"]))
        print("Time spent in topology updates: "
              + str(self.timings["topology"]))
        phases = self.rt.phase_times
        if phases:
            breakdown = ", ".join(f"{k}={v:.2f}s"
                                  for k, v in sorted(phases.items()))
            print(f"Phase breakdown (beyond the reference's stats): "
                  f"{breakdown}", flush=True)


def run_inference(cfg: MapleConfig, device: torch.device) -> Run:
    run = Run(cfg, device)
    run.run()
    return run
