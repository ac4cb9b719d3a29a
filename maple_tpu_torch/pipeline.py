"""The inference pipeline with its device stages on a torch device.

``Run`` is :class:`maple_tpu.pipeline.Run` with the device placement
stage re-written for PyTorch; every other stage (loading, EM, root
search, SPR rounds, outputs) is the shared host engine.  Of
``--devicePlacement``'s three branches only the pipelined one is ported;
the other two raise instead of falling back to host placement.
"""
from __future__ import annotations

import os

import torch

from maple_tpu import pipeline as base
from maple_tpu.config import MapleConfig
from maple_tpu.native.engine import native_engine_supported
from maple_tpu.runtime.partials import TreeRuntime
from maple_tpu.runtime.tree import PhyloTree
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


def run_inference(cfg: MapleConfig, device: torch.device) -> Run:
    run = Run(cfg, device)
    run.run()
    return run
