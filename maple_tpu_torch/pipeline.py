"""Main inference driver.

De-novo pipeline (reference driver :11637-12660): sorted stepwise addition,
online substitution-model updates, post-placement EM + branch-length sweeps,
root search, SPR rounds, and output files (_tree.tree, _subs.txt, _LK.txt,
nexus/TSV when SPRTA or MAT estimation is on).

The device stages (``--devicePlacement``, ``--deviceTopology``) run on the
``torch.device`` the run is given.  ``--devicePlacement`` on one card has
three branches, all of them here: the proxy screen feeding the C++ engine
(the default with native kernels and no active error model), the pipelined
placer (``MAPLE_DEVICE_RT=1``, error-model runs, python kernels) and the
legacy batch placer (``MAPLE_DEVICE_LEGACY=1``: the interval-algebra scorer,
or the pair kernel with ``--devicePallas``).  Over a mesh of ranks
(:mod:`maple_tpu_torch.parallel.mesh`) the proxy branch shards its pool by
candidate, and the other branches take the legacy placer, sharded.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

import torch

from .config import DerivedConfig, MapleConfig
from .core import kernels as K
from .io.maple_format import (read_maple_alignment, read_reference_fasta,
                              sample_distance_from_ref)
from .io.newick import (AnnotationOptions, create_newick, read_newick,
                        write_nexus)
from .models.em import expectation_maximization_rates
from .refdata import Model, RefData
from .native.engine import native_engine_supported
from .runtime.partials import TreeRuntime
from .runtime.phases import Tracer, method_span
from .runtime.tree import (PhyloTree, give_internal_node_names,
                           make_tree_binary, set_all_dirty)
from .search.blen import optimize_branch_lengths
from .search.placement import (PlacementStats, find_best_parent_for_new_sample,
                               place_sample_on_tree)


class TraceState:
    """Opt-in intermediate-tree/LK traces written after every N applied
    SPR moves (reference :3128-3152, :9255-9270, :12004-12014)."""

    def __init__(self, cfg, names_in_tree):
        self.every_trees = cfg.writeTreesToFileEveryTheseSteps
        self.every_lks = cfg.writeLKsToFileEveryTheseSteps
        self.binary = not cfg.nonBinaryTree
        self.names_in_tree = names_in_tree
        self.changes = 0
        self.trees_file = None
        self.lks_file = None
        if self.every_trees > 0:
            path = cfg.output + "_intermediateTrees.tree"
            if os.path.isfile(path) and not cfg.overwrite:
                raise FileExistsError(f"{path} exists; use --overwrite")
            self.trees_file = open(path, "w")
        if self.every_lks > 0:
            path = cfg.output + "_intermediateLKs.txt"
            if os.path.isfile(path) and not cfg.overwrite:
                raise FileExistsError(f"{path} exists; use --overwrite")
            self.lks_file = open(path, "w")

    def _root_from(self, rt, node):
        while rt.tree.up[node] is not None:
            node = rt.tree.up[node]
        return node

    def _write(self, rt, root, label):
        if self.trees_file is not None:
            s = create_newick(rt.tree, root, binary=self.binary,
                              names_in_tree=self.names_in_tree)
            self.trees_file.write(label + "\n" + s + "\n")
        if self.lks_file is not None:
            total = rt.calculate_tree_likelihood(root)
            if rt.do_time_tree:
                from .models.timetree import calculate_tree_likelihood_time
                total += calculate_tree_likelihood_time(rt.time, rt.tree,
                                                        root)
            self.lks_file.write(label + ", LK: " + str(total) + "\n")

    def record_move(self, rt, node):
        self.changes += 1
        if self.every_trees > 0 and self.changes % self.every_trees == 0 \
                and self.trees_file is not None:
            root = self._root_from(rt, node)
            s = create_newick(rt.tree, root, binary=self.binary,
                              names_in_tree=self.names_in_tree)
            self.trees_file.write(f"Topology {self.changes}\n" + s + "\n")
        if self.every_lks > 0 and self.changes % self.every_lks == 0 \
                and self.lks_file is not None:
            root = self._root_from(rt, node)
            total = rt.calculate_tree_likelihood(root)
            if rt.do_time_tree:
                from .models.timetree import calculate_tree_likelihood_time
                total += calculate_tree_likelihood_time(rt.time, rt.tree,
                                                        root)
            self.lks_file.write(f"Topology {self.changes}, LK: "
                                + str(total) + "\n")

    def initial_snapshot(self, rt, root):
        if self.trees_file is not None:
            s = create_newick(rt.tree, root, binary=self.binary,
                              names_in_tree=self.names_in_tree)
            self.trees_file.write("Topology 0\n" + s + "\n")
        if self.lks_file is not None:
            total = rt.calculate_tree_likelihood(root)
            if rt.do_time_tree:
                from .models.timetree import calculate_tree_likelihood_time
                total += calculate_tree_likelihood_time(rt.time, rt.tree,
                                                        root)
            self.lks_file.write("Topology 0, LK: " + str(total) + "\n")

    def close(self):
        if self.trees_file is not None:
            self.trees_file.close()
        if self.lks_file is not None:
            self.lks_file.close()


class Run:
    """One inference run: all state bundled (no module globals)."""

    def __init__(self, cfg: MapleConfig, device: torch.device):
        self.cfg = cfg
        self.device = torch.device(device)   # where the device stages run
        # the placer of the --devicePlacement branch that ran, kept for
        # phase attribution
        self.proxy_placer = None
        self.pplacer = None
        self.legacy_placer = None
        self.timings = {"finding": 0.0, "placing": 0.0, "topology": 0.0}
        # the spans and counters of this run (runtime/phases.py)
        self.tracer = Tracer()
        self.names_in_tree = []
        self.stats = PlacementStats()

    # ------------------------------------------------------------------
    @method_span("load")
    def load(self):
        cfg = self.cfg
        from .refdata import reset_ambiguities
        reset_ambiguities()
        if cfg.reference:
            ref = read_reference_fasta(cfg.reference)
            data = read_maple_alignment(cfg.input, extract_reference=False,
                                        ref=ref)
        else:
            ref, data = read_maple_alignment(cfg.input)
        self.data = data
        self.refd = RefData.build(ref, model=cfg.model)
        self.dc = DerivedConfig.build(cfg, self.refd.lRef)
        self.model = Model.initial(self.refd, cfg.model)
        if cfg.rateVariation and not cfg.inputRates:
            self.model.site_rates = [1.0] * self.refd.lRef
            self.model.refresh_cumulative_rate()
        if cfg.inputRates:
            self.read_input_rates(cfg.inputRates)
        self.init_error_tables(activate=False)
        self.time_ctx = None
        self.dates = None
        if cfg.datesFile:
            from .models.timetree import TimeCtx, read_dates
            self.dates, self.min_year, self.min_day = read_dates(
                cfg.datesFile, strain_name=cfg.strainName,
                date_name=cfg.dateName,
                min_sampling_year=cfg.minSamplingYear,
                max_sampling_year=cfg.maxSamplingYear,
                interval_length=cfg.intervalLength)
            # internal rates are per interval (reference :182-185)
            self.time_ctx = TimeCtx(
                self.refd.lRef, cfg.mutRate * cfg.intervalLength,
                cfg.intervalLength, cfg.timeProbThreshold,
                cfg.minMutRate * cfg.intervalLength, cfg.mutRate)
            self.time_ctx.dates = self.dates
        if cfg.rootSearchBudget < 0:
            # auto root-search budget: quality-gated scale default (see
            # config.py note); exact everywhere the wall is already small
            cfg.rootSearchBudget = 1000 if (
                cfg.fast and len(data) >= 50000) else 0
        print(f"Length of reference genome: {self.refd.lRef}; "
              f"{len(data)} samples")

    def read_input_rates(self, path: str):
        """Pre-estimated model parameters in _subs.txt format (reference
        :6394-6427)."""
        cfg = self.cfg
        with open(path) as f:
            mat = []
            for i in range(4):
                mat.append([float(x) for x in f.readline().split()])
            self.model.mut_matrix = mat
            if cfg.rateVariation:
                line = f.readline()
                while line and line != "Site rates:\n":
                    line = f.readline()
                site_rates = []
                for i in range(self.refd.lRef):
                    site_rates.append(float(f.readline().split()[1]))
                self.model.site_rates = site_rates
            if cfg.estimateSiteSpecificErrorRate:
                line = f.readline()
                while line and line != "Site error rates:\n":
                    line = f.readline()
                err = []
                for i in range(self.refd.lRef):
                    err.append(float(f.readline().split()[1]))
                self.model.set_error_rates(sum(err) / self.refd.lRef, err)
        self.model.refresh_cumulative_rate()
        print("Read input rates")

    def error_model_requested(self) -> bool:
        cfg = self.cfg
        return bool(cfg.errorRateSiteSpecificFile or cfg.errorRateFixed
                    or cfg.estimateErrorRate
                    or cfg.estimateSiteSpecificErrorRate)

    def _restore_native_backend(self):
        """Return to the native kernels after the error-model activation
        window.  Between activation and the first full recompute, cached
        internal vectors hold pre-activation tuple layouts that the kernels
        reinterpret positionally (stale-tuple semantics, see the reference's
        len()-based flag tests e.g. :4496-4859) — that window runs on the
        Python kernels.  Once recalculate_all has rebuilt every internal
        vector, the layouts are steady-state and the native store represents
        them exactly; tips keep tuple-form vectors so shared-ambiguity
        aliasing keeps working (TreeRuntime.refresh_terminal_errors)."""
        rt = self.rt
        if rt.kern.name != "python" or self.cfg.kernel_backend != "native":
            return
        if self.time_ctx is not None:
            return  # time-tree phases stay on the tuple path
        if not getattr(self.cfg, "native_error_model", False):
            # The reference aliases tip ambiguity lists THROUGH merge
            # outputs: internal cached vectors built early in a recompute
            # keep referencing a shared tip list and drift when later tip
            # refreshes mutate it mid-pass (e.g. N-passthrough entries,
            # reference mergeVectors :4496-4859).  The native store holds
            # value copies, so returning to it requires alias-tag
            # propagation through the C++ kernels; until that lands the
            # error-model phases stay on the Python kernels.
            return
        rt.convert_backend("native", keep_tip_tuples=True)

    def init_error_tables(self, activate: bool):
        """Install initial error-rate tables per flags (reference
        :11102-11137); activation (usingErrorRate) is controlled
        separately."""
        cfg = self.cfg
        model = self.model
        if cfg.errorRateSiteSpecificFile:
            with open(cfg.errorRateSiteSpecificFile) as f:
                rates = [float(x) for x in f.readline().split(", ")]
            if len(rates) != self.refd.lRef:
                raise ValueError("site error-rate file length mismatch")
            model.set_error_rates(sum(rates) / self.refd.lRef, rates,
                                  activate=activate)
        elif cfg.errorRateFixed:
            model.set_error_rates(cfg.errorRateFixed, activate=activate)
        elif cfg.estimateErrorRate:
            model.set_error_rates(self.dc.errorRateGlobalInitial,
                                  activate=activate)
        elif cfg.estimateSiteSpecificErrorRate:
            rate = self.dc.errorRateGlobalInitial
            model.set_error_rates(rate, [rate] * self.refd.lRef,
                                  activate=activate)

    def sorted_distances(self, samples_in_tree=frozenset()):
        """Placement order: fewest diffs / least missing data first
        (reference distancesFromRefPunishNs :6451-6499)."""
        out = []
        for name in self.data:
            if name in samples_in_tree:
                continue
            key, n_diffs, comparisons = sample_distance_from_ref(
                self.data[name], self.refd.lRef)
            out.append((key, name))
        out.sort(reverse=True, key=lambda t: t[0])
        return out

    # ------------------------------------------------------------------
    def build_initial_tree(self):
        """Serial stepwise addition (reference :11686-11760); extends an
        input tree when one was loaded."""
        cfg = self.cfg
        dc = self.dc
        dtt = self.time_ctx is not None
        if hasattr(self, "rt"):
            # online mode: place only samples absent from the input tree
            if dtt:
                from .models.timetree import sort_samples_by_date
                print("Sorting samples based on dates", flush=True)
                distances = sort_samples_by_date(
                    self.dates, self.data, samples=list(self.data.keys()),
                    samples_in_initial_tree=self.samples_in_tree)
            else:
                distances = self.sorted_distances(
                    samples_in_tree=self.samples_in_tree)
            tree = self.tree
            t1 = self.root
            num_samples = len(self.names_in_tree)
        else:
            if dtt:
                from .models.timetree import sort_samples_by_date
                print("Sorting samples based on dates", flush=True)
                distances = sort_samples_by_date(self.dates, self.data,
                                                 samples=list(
                                                     self.data.keys()))
            else:
                distances = self.sorted_distances()
            first_key, first_sample = distances.pop()
            self.names_in_tree.append(first_sample)
            tree = PhyloTree(use_hnz=bool(cfg.HnZ), use_time=dtt)
            tree.add_node()
            tree.name[-1] = 0
            self.tree = tree
            self.rt = TreeRuntime(tree, self.refd, self.model, dc, cfg,
                                  tracer=self.tracer)
            self.rt.time = self.time_ctx
            t1 = 0
            if self.rt.kern.name == "native" \
                    and native_engine_supported(self):
                self.root = self._build_initial_tree_engine(
                    distances, first_sample)
                return
            if cfg.placementBudget:
                print("WARNING: --placementBudget requires the native "
                      "placement engine; this configuration falls back "
                      "to the exact reference search.", flush=True)
            tree.probVect[0] = self.rt.terminal_vector(
                self.data[first_sample])
            if dtt:
                tree.probVectTime[0] = self.dates.get(first_sample)
                tree.dateData[0] = self.dates.get(first_sample)
            self.data[first_sample] = None
            num_samples = 1
        if cfg.doNotPlaceNewSamples:
            distances = []
        missing_date_warned = False
        last_update_num_samples_time = num_samples
        while distances:
            _, sample = distances.pop()
            self.names_in_tree.append(sample)
            new_partials = self.rt.terminal_vector(self.data[sample])
            new_partials_time = None
            if dtt:
                if sample in self.dates:
                    new_partials_time = self.dates[sample]
                else:
                    if not missing_date_warned:
                        print("WARNING Some samples have no date data "
                              f"(e.g. {sample}), they will be considered "
                              "as having no date information.")
                        missing_date_warned = True
            self.data[sample] = None
            if (num_samples < cfg.minNumSamplesForRateVar
                    or not self.model.use_rate_variation) \
                    and num_samples % cfg.updateSubstMatrixEveryThisSamples \
                    == 0:
                if cfg.model != "JC":
                    self.model.update_from_pseudo_counts()
            if num_samples % 50000 == 0:
                print(f"Sample num {num_samples}", flush=True)
            if (self.model.use_rate_variation
                    and num_samples > cfg.minNumSamplesForRateVar
                    and num_samples > 2 * getattr(self, "_last_em", 1)):
                self._last_em = num_samples
                self.rt.recalculate_all(t1)
                self.run_em_step(rates_update="using")
                self.rt.recalculate_all(t1)
                optimize_branch_lengths(self.rt, t1)
                self.rt.recalculate_all(t1)
            if (dtt and num_samples > cfg.minNumSamplesForMutRate
                    and num_samples > 2 * last_update_num_samples_time):
                from .models import timetree as tt
                last_update_num_samples_time = num_samples
                tt.recalculate_all_time(self.time_ctx, tree, t1)
                _c, _w, new_rate = tt.em_mut_rate(self.time_ctx, tree, t1)
                self.time_ctx.set_mut_rate(new_rate)
                tt.recalculate_all_time(self.time_ctx, tree, t1)
                print(" EM to update mutRate during initial placement "
                      f"terminated, new mutRate {new_rate}")
            start = time.time()
            best_node, best_score, best_blens, best_vect = \
                find_best_parent_for_new_sample(
                    self.rt, t1, new_partials, num_samples, self.stats,
                    diffs_time=new_partials_time)
            self.timings["finding"] += time.time() - start
            if best_blens is not None:
                start = time.time()
                new_root = place_sample_on_tree(
                    self.rt, best_node, best_vect, num_samples, best_score,
                    best_blens[0], best_blens[1], best_blens[2],
                    self.model.pseudo_counts, self.stats,
                    new_partials_time=new_partials_time)
                if new_root is not None:
                    t1 = new_root
                self.timings["placing"] += time.time() - start
            num_samples += 1
            if num_samples % cfg.saveInitialTreeEvery == 0:
                self.write_tree(f"_initialTree_{num_samples}samples.tree", t1)
        self.root = t1
        print("Sample placement completed", flush=True)
        print(f"Placed samples that became minor sequences: "
              f"{self.stats.num_minors_found}")

    def _prep_pool(self):
        """Single-thread executor for pipelined batch preparation."""
        pool = getattr(self, "_prep_pool_obj", None)
        if pool is None:
            from concurrent.futures import ThreadPoolExecutor
            pool = self._prep_pool_obj = ThreadPoolExecutor(1)
        return pool

    def _build_initial_tree_engine(self, distances, first_sample) -> int:
        """Fast path: the whole stepwise-addition loop runs in the C++
        placement engine (see maple_tpu_torch/native/engine.py); the Python side
        only builds terminal vectors and refreshes the substitution model
        on the reference's cadence (:11686-11760)."""
        from .native.engine import NativePlacementEngine
        cfg = self.cfg
        eng = NativePlacementEngine(self.rt, self.data[first_sample])
        self.engine = eng  # kept for phase profiling (engine.profile())
        self.data[first_sample] = None
        num_samples = 1
        # Search-parallel / apply-serial batches (engine_place_batch):
        # only with the budgeted search (--placementBudget, already a
        # tolerance-contract path) — the exact DFS stays serial for byte
        # parity — and without the error model (shared-ambiguity alias
        # tags are registered in placement order).  Batches never cross a
        # model-refresh, checkpoint, or progress-print boundary, so those
        # fire on exactly the serial cadence.
        batch_cores = cfg.numCores if (
            cfg.placementBudget > 0 and cfg.numCores > 1
            and not self.model.using_error_rate) else 0
        start = time.time()

        def checkpoint():
            # restartable-state checkpoint (reference :11754-11760)
            snap, snap_root = eng.snapshot_tree()
            s = create_newick(
                snap, snap_root, binary=not cfg.nonBinaryTree,
                names_in_tree=self.names_in_tree,
                support_for_identical=cfg.supportForIdenticalSequences)
            with open(cfg.output
                      + f"_initialTree_{num_samples}samples.tree",
                      "w") as f:
                f.write(s)

        while distances or getattr(self, "_prep_fut", None):
            if num_samples % cfg.updateSubstMatrixEveryThisSamples == 0 \
                    and cfg.model != "JC":
                eng.flush_pseudo_counts(self.model.pseudo_counts)
                self.model.update_from_pseudo_counts()
                eng.sync_model()
            if num_samples % 50000 == 0:
                print(f"Sample num {num_samples}", flush=True)
            if batch_cores:
                def batch_cap(num):
                    k = len(distances)
                    if cfg.model != "JC":
                        upd2 = cfg.updateSubstMatrixEveryThisSamples
                        k = min(k, upd2 - num % upd2)
                    if os.environ.get("MAPLE_BATCH_MAX"):  # debug
                        k = min(k, int(os.environ["MAPLE_BATCH_MAX"]))
                    return min(k,
                               cfg.saveInitialTreeEvery
                               - num % cfg.saveInitialTreeEvery,
                               50000 - num % 50000)

                def prep(k):
                    batch = []
                    for _ in range(k):
                        _, sample = distances.pop()
                        self.names_in_tree.append(sample)
                        batch.append(self.data[sample])
                        self.data[sample] = None
                    return eng.terminal_vids_batch(batch)

                # 1-deep pipelining: build the NEXT batch's terminal
                # vectors while the engine places the current one (the
                # ctypes call releases the GIL; store slot allocation is
                # mutex-guarded).  Pops happen on the prep thread only
                # while the main thread is inside place_batch_vids, so
                # the serial cadence (refresh/checkpoint boundaries,
                # computed ahead from the deterministic batch sizes) is
                # unchanged.
                vids = self._prep_fut.result() \
                    if getattr(self, "_prep_fut", None) else prep(
                        batch_cap(num_samples))
                self._prep_fut = None
                k = len(vids)
                nxt = batch_cap(num_samples + k)
                if nxt:
                    # terminal vectors are model-independent on this
                    # path (error-model runs use the serial loop), so
                    # prepping across a refresh boundary is safe
                    self._prep_fut = self._prep_pool().submit(prep, nxt)
                eng.place_batch_vids(vids, num_samples, batch_cores)
                num_samples += k
            else:
                _, sample = distances.pop()
                self.names_in_tree.append(sample)
                eng.place(self.data[sample], num_samples)
                self.data[sample] = None
                num_samples += 1
            if num_samples % cfg.saveInitialTreeEvery == 0:
                checkpoint()
        eng.flush_pseudo_counts(self.model.pseudo_counts)
        root = eng.export_to_tree(self.stats)
        self.timings["finding"] += time.time() - start
        print("Sample placement completed", flush=True)
        print(f"Placed samples that became minor sequences: "
              f"{self.stats.num_minors_found}")
        return root

    def _build_initial_tree_engine_device(self, distances, first_sample,
                                          mesh=None,
                                          warmup=None) -> int:
        """Production device path: serial engine warmup, then the proxy
        screen on ``self.device`` (over ``mesh``, on its device, with the
        pool sharded by candidate) feeding the engine's seeded batched
        placement (maple_tpu_torch/parallel/proxy_placer.py module
        docstring).  Model refreshes, checkpoints, and progress prints keep
        the serial cadence (reference :11686-11760)."""
        from .native.engine import NativePlacementEngine
        from .parallel.proxy_placer import EngineProxyPlacer
        cfg = self.cfg
        tracer = self.tracer
        eng = NativePlacementEngine(self.rt, self.data[first_sample])
        self.engine = eng  # kept for phase profiling (engine.profile())
        self.data[first_sample] = None
        num_samples = 1
        start = time.time()
        upd = cfg.updateSubstMatrixEveryThisSamples
        warmup = max(2, warmup if warmup is not None
                     else cfg.device_warmup)
        # placer construction (device pool allocation) overlaps the
        # serial warmup placements: __init__ reads only cfg/env and
        # queues device allocations — it never touches the tree
        from concurrent.futures import ThreadPoolExecutor
        _init_pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="place.init")
        placer_fut = _init_pool.submit(
            EngineProxyPlacer, self, eng, num_cores=cfg.numCores,
            batch_size=cfg.device_proxy_batch,
            topm=cfg.device_seed_topm,
            seed_budget=cfg.device_seed_budget,
            device=self.device if mesh is None else mesh.device,
            fast_screen=cfg.fast, mesh=mesh)
        with tracer.span("place.serial"):
            while distances and num_samples < warmup:
                if num_samples % upd == 0 and cfg.model != "JC":
                    eng.flush_pseudo_counts(self.model.pseudo_counts)
                    self.model.update_from_pseudo_counts()
                    eng.sync_model()
                _, sample = distances.pop()
                self.names_in_tree.append(sample)
                eng.place(self.data[sample], num_samples)
                self.data[sample] = None
                num_samples += 1

        def checkpoint(num):
            # restartable-state checkpoint (reference :11754-11760)
            snap, snap_root = eng.snapshot_tree()
            s = create_newick(
                snap, snap_root, binary=not cfg.nonBinaryTree,
                names_in_tree=self.names_in_tree,
                support_for_identical=cfg.supportForIdenticalSequences)
            with open(cfg.output + f"_initialTree_{num}samples.tree",
                      "w") as f:
                f.write(s)

        with tracer.span("place.wait.init"):
            placer = placer_fut.result()
        _init_pool.shutdown(wait=False)
        self.proxy_placer = placer  # kept for phase attribution
        placer.place_all(distances, num_samples, checkpoint)
        eng.flush_pseudo_counts(self.model.pseudo_counts)
        with tracer.span("place.export_tree"):
            root = eng.export_to_tree(self.stats)
        self.timings["finding"] += time.time() - start \
            - placer.time_place
        self.timings["placing"] += placer.time_place
        print("Device-batched sample placement completed", flush=True)
        print(f"Placed samples that became minor sequences: "
              f"{self.stats.num_minors_found}")
        return root

    # ------------------------------------------------------------------
    @method_span("place")
    def build_initial_tree_device(self, warmup: int = 256,
                                  batch_size: int = 64, mesh=None):
        """Device placement on ``self.device``: the proxy screen feeding
        the C++ engine where the run allows it (native kernels, no active
        error model), else host-serial warmup and then device-batched
        scoring with the exact host fine phase: the pipelined placer
        (maple_tpu_torch.parallel.pipelined_placer), or with
        MAPLE_DEVICE_LEGACY the legacy batch placer
        (maple_tpu_torch.parallel.batch_placement).  ``mesh`` is a (dp, cand)
        mesh of ranks (maple_tpu_torch.parallel.mesh): the proxy branch
        shards its anchor-feature pool over ``cand``; otherwise the legacy
        placer scores over it, queries data-parallel, the anchor pool
        candidate-parallel."""
        cfg = self.cfg
        dc = self.dc
        distances = self.sorted_distances()
        first_key, first_sample = distances.pop()
        self.names_in_tree.append(first_sample)
        tree = PhyloTree(use_hnz=bool(cfg.HnZ))
        tree.add_node()
        tree.name[-1] = 0
        self.tree = tree
        self.rt = TreeRuntime(tree, self.refd, self.model, dc, cfg,
                              tracer=self.tracer)
        t1 = 0
        legacy = bool(os.environ.get("MAPLE_DEVICE_LEGACY"))
        if self.rt.kern.name == "native" \
                and native_engine_supported(self) \
                and not self.model.using_error_rate \
                and not legacy \
                and not os.environ.get("MAPLE_DEVICE_RT"):
            # proxy screen + C++ engine seeded placement — the
            # production device path (proxy_placer module docstring).
            # Error-model runs keep the rt-based pipelined placer below
            # (alias-tag registration is placement-order-dependent, so
            # the engine refuses batched applies there).  The caller's
            # ``warmup`` is honored; ``batch_size`` is the rt-based
            # placers' knob and does not apply — the proxy screen
            # batches by cfg.device_proxy_batch.  With a mesh the anchor-
            # feature pool shards over the candidate axis (replicated
            # tree, sharded screen).
            self.root = self._build_initial_tree_engine_device(
                distances, first_sample, mesh=mesh, warmup=warmup)
            return
        # a mesh takes the legacy placer: the pipelined one is single-device
        legacy = legacy or mesh is not None
        from .parallel.batch_placement import BatchedPlacer
        from .parallel.pipelined_placer import PipelinedPlacer
        tree.probVect[0] = self.rt.terminal_vector(self.data[first_sample])
        self.data[first_sample] = None
        num_samples = 1
        start_all = time.time()
        upd = cfg.updateSubstMatrixEveryThisSamples
        # host-serial warmup on the exact serial model-refresh cadence
        # (reference :11708-11711)
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

        if not legacy:
            # fused-step pipelined placer
            def stream():
                nonlocal num_samples
                while distances:
                    _, sample = distances.pop()
                    self.names_in_tree.append(sample)
                    v = self.rt.terminal_vector(self.data[sample])
                    self.data[sample] = None
                    yield (num_samples, v)
                    num_samples += 1

            placer = PipelinedPlacer(
                self.rt, self.stats, self.device, batch_size=batch_size,
                expected_samples=len(distances) + num_samples)
            self.pplacer = placer
            t1 = placer.place_all(
                t1, stream(),
                refresh_every=(upd if cfg.model != "JC" else 0),
                n_placed=num_samples)
        else:
            # the model-refresh cadence caps non-JC batches at
            # updateSubstMatrixEveryThisSamples queries: a mesh scores in
            # chunks of that size, rounded up to a multiple of 8
            qc = batch_size
            if cfg.model != "JC":
                qc = min(batch_size, upd)
                qc += (-qc) % 8
            placer = BatchedPlacer(
                self.rt, self.stats,
                self.device if mesh is None else mesh.device,
                batch_size=batch_size, query_chunk=qc, mesh=mesh,
                use_pallas=cfg.device_pallas,
                expected_samples=len(distances) + num_samples)
            self.legacy_placer = placer
            while distances:
                # batches never cross a model-refresh boundary, so the
                # model every sample sees is the serial path's
                k = batch_size
                if cfg.model != "JC":
                    if num_samples % upd == 0:
                        self.model.update_from_pseudo_counts()
                    k = min(k, upd - num_samples % upd)
                batch = []
                while distances and len(batch) < k:
                    _, sample = distances.pop()
                    self.names_in_tree.append(sample)
                    batch.append((num_samples, self.rt.terminal_vector(
                        self.data[sample])))
                    self.data[sample] = None
                    num_samples += 1
                t1 = placer.place_batch(t1, batch)
                if num_samples % 1024 < batch_size:
                    el = time.time() - start_all
                    print(f"placed {num_samples} samples, "
                          f"{num_samples/el:.1f} seq/s (scoring "
                          f"{placer.time_scoring:.1f}s fine "
                          f"{placer.time_fine:.1f}s apply "
                          f"{placer.time_apply:.1f}s)", flush=True)
        self.root = t1
        self.timings["finding"] += placer.time_scoring + placer.time_fine
        self.timings["placing"] += placer.time_apply
        print("Device-batched sample placement completed", flush=True)

    # ------------------------------------------------------------------
    def run_em_step(self, track_mutations=False, rates_update="first"):
        """One EM pass; installs the new matrix/site-rates/error-rates into
        the model.

        ``rates_update`` selects the reference call site's error-rate
        update semantics — they differ per site, observably so for
        --errorRateFixed / --errorRateSiteSpecificFile:
        * "first" (reference :11783-11801, :11957-11976): the global rate
          is replaced only under --estimateErrorRate; the error tables are
          refreshed whenever the error model is active.
        * "using" (:11845-11850 and the online initial EM :11041-11048 and
          the error-EM loops): the EM estimates replace the global rate
          and tables for ANY active error model — even a --errorRateFixed
          rate is overwritten here (reference behavior).
        * "rounds" (:12401-12408): the global-rate SCALAR is replaced
          unconditionally but the cumulative error tables are rebuilt only
          when error rates are being estimated — a half-update the
          reference performs each SPR round.
        """
        mat, site_rates, err_rate, err_rates = \
            expectation_maximization_rates(self.rt, self.root
                                           if hasattr(self, "root") else 0,
                                           track_mutations=track_mutations)
        model = self.model
        cfg = self.cfg
        model.mut_matrix = mat
        if site_rates is not None:
            model.site_rates = site_rates
        model.refresh_cumulative_rate()
        estimating = cfg.estimateErrorRate or cfg.estimateSiteSpecificErrorRate
        if model.using_error_rate:
            if rates_update == "using":
                if err_rate is not None:
                    model.set_error_rates(err_rate, err_rates)
                else:
                    model.set_error_rates(model.error_rate, err_rates)
            elif rates_update == "rounds":
                # the reference rebinds the global-rate scalar AND the
                # per-site array to the EM estimates (:12401 unpacks into
                # errorRateGlobal/errorRates) but rebuilds the cumulative
                # tables only when estimating (:12403-12408)
                if err_rate is not None:
                    model.error_rate = err_rate
                if err_rates is not None:
                    model.error_rates = err_rates
                model.version += 1
                if estimating:
                    model.set_error_rates(model.error_rate, err_rates)
            else:  # "first"
                if cfg.estimateErrorRate and err_rate is not None:
                    model.set_error_rates(err_rate, err_rates)
                else:
                    model.set_error_rates(model.error_rate, err_rates)
        return mat

    @method_span("post_placement")
    def post_placement(self):
        """EM + branch-length optimization after the initial tree
        (reference :11768-11918)."""
        cfg = self.cfg
        rt = self.rt
        t1 = self.root
        if not cfg.useFixedThresholdLogLKoptimizationTopology \
                and self.stats.num_child_lks > 0:
            ave = self.stats.sum_child_lks / self.stats.num_child_lks
            self.dc.thresholdLogLKoptimizationTopology = max(
                self.dc.thresholdLogLKoptimizationTopology, -0.2 * ave)
        rt.recalculate_all(t1, count_nodes=True)
        if self.error_model_requested():
            # activate the error model and iterate EM (reference
            # :11779-11811)
            lk = rt.calculate_tree_likelihood(t1)
            print(f"Tree LK before error rates EM: {lk}")
            if not self.model.using_error_rate:
                # activation: cached vectors still carry pre-activation
                # tuple layouts that the kernels reinterpret positionally
                # (stale-tuple semantics) — that window runs on the
                # Python kernels; online mode may have activated already
                # during setup_input_tree, in which case vectors are
                # steady-state and no conversion is needed
                if rt.kern.name == "native":
                    rt.convert_backend("python")
                    from .core.genomelist import reshare_tip_ambiguities
                    reshare_tip_ambiguities(self.tree)
                self.model.using_error_rate = True
                self.model.version += 1
            self.run_em_step()
            rt.recalculate_all(t1)
            # the stale window is over: every internal vector now has
            # steady-state error-model entry layouts, so the run can
            # return to the native kernels (tips keep their tuple form to
            # preserve the reference's shared-ambiguity aliasing :3959)
            self._restore_native_backend()
            lk = rt.calculate_tree_likelihood(t1)
            print(f"Tree LK after first errors EM: {lk}")
            if not cfg.doNotOptimiseBLengths:
                optimize_branch_lengths(rt, t1)
                rt.recalculate_all(t1)
                lk = rt.calculate_tree_likelihood(t1)
                print(f"Tree LK after branch length optimization: {lk}")
        self.data.clear()
        if (not cfg.inputTree) or cfg.largeUpdate or cfg.rateVariation \
                or self.model.using_error_rate:
            ses = None
            if self._native_session_eligible():
                from .native.engine import open_native_session
                ses = open_native_session(rt, t1)
            try:
                rt.recalculate_all(t1)
                if cfg.model != "JC" or cfg.rateVariation \
                        or cfg.estimateErrorRate \
                        or cfg.estimateSiteSpecificErrorRate:
                    lk = rt.calculate_tree_likelihood(t1)
                    print(f"Tree LK before EM: {lk}")
                    self.run_em_step(rates_update="using")
                    rt.recalculate_all(t1)
                    lk = rt.calculate_tree_likelihood(t1)
                    print(f"Tree LK after EM: {lk}")
                    if not cfg.doNotOptimiseBLengths:
                        self._set_all_dirty(t1)
                        optimize_branch_lengths(rt, t1)
                        rt.recalculate_all(t1)
                        lk = rt.calculate_tree_likelihood(t1)
                        print(f"Tree LK after branch length optimization: "
                              f"{lk}")
                    if cfg.estimateErrorRate \
                            or cfg.estimateSiteSpecificErrorRate:
                        old_lk = float("-inf")
                        steps = 0
                        while lk - old_lk > 1.0 and steps < 20:
                            if not cfg.doNotOptimiseBLengths:
                                self._set_all_dirty(t1)
                                optimize_branch_lengths(rt, t1)
                                rt.recalculate_all(t1)
                            self.run_em_step(rates_update="using")
                            rt.recalculate_all(t1)
                            old_lk = lk
                            lk = rt.calculate_tree_likelihood(t1)
                            print(f"New LK step {steps}: {lk}")
                            steps += 1
                if not cfg.doNotOptimiseBLengths:
                    lk = rt.calculate_tree_likelihood(t1)
                    print(f"Now proper branch length optimization, "
                          f"LK before: {lk}")
                    self._set_all_dirty(t1)
                    improvement = optimize_branch_lengths(rt, t1)
                    sub_round = 0
                    while sub_round < 20:
                        if not improvement:
                            break
                        sub_round += 1
                        improvement = optimize_branch_lengths(rt, t1)
                    lk = rt.calculate_tree_likelihood(t1)
                    print(f"Final branch length optimization, LK: {lk}")
            finally:
                if ses is not None:
                    ses.close()
        if cfg.HnZ:
            from .runtime.tree import calculate_ndesc0
            calculate_ndesc0(self.tree, t1, self.dc.effectivelyNon0BLen)
        if self.time_ctx is not None:
            self.run_time_em("post-initial-tree")

    # ------------------------------------------------------------------
    def _native_session_eligible(self) -> bool:
        from .native.engine import native_session_eligible
        return native_session_eligible(self.rt)

    def _set_all_dirty(self, root: int):
        """set_all_dirty routed through a live engine session (the python
        tree mirror is stale while one is open)."""
        ses = self.rt.native_session
        if ses is not None:
            ses.set_all_dirty()
        else:
            set_all_dirty(self.tree, root)

    @method_span("write")
    def write_tree(self, suffix: str, root: Optional[int] = None,
                   annotations: Optional[AnnotationOptions] = None):
        if self.rt.native_session is not None:
            # refresh the topology mirror; names/minors/supports are not
            # touched by native phases and vectors stay engine-resident
            self.rt.native_session.sync_topology()
        root = self.root if root is None else root
        s = create_newick(
            self.tree, root, binary=not self.cfg.nonBinaryTree,
            names_in_tree=self.names_in_tree, annotations=annotations,
            support_for_identical=self.cfg.supportForIdenticalSequences)
        with open(self.cfg.output + suffix, "w") as f:
            f.write(s)
        return s

    def write_subs(self, suffix="_subs.txt"):
        cfg = self.cfg
        with open(cfg.output + suffix, "w") as f:
            for i in range(4):
                for j in range(4):
                    f.write(str(self.model.mut_matrix[i][j]) + "\t")
                f.write("\n")
            if cfg.rateVariation:
                f.write("\n\nSite rates:\n")
                for i in range(self.refd.lRef):
                    f.write(f"{i + 1}\t{self.model.site_rates[i]}\n")
            if cfg.estimateSiteSpecificErrorRate \
                    and self.model.error_rates is not None:
                f.write("\n\nSite error rates:\n")
                for i in range(self.refd.lRef):
                    f.write(f"{i + 1}\t{self.model.error_rates[i]}\n")
            elif cfg.estimateErrorRate:
                # also reached when --estimateErrors is combined with
                # --estimateErrorRate: global-rate EM leaves the per-site
                # table unset; the reference crashes here (:12500,
                # unguarded errorRates[i]) — deliberate repair
                f.write(f"\n\nError rate: {self.model.error_rate}\n")

    def write_lk(self, suffix="_LK.txt", include_time=True):
        total = self.rt.calculate_tree_likelihood(self.root)
        if self.time_ctx is not None and include_time:
            from .models.timetree import (calculate_tree_likelihood_time,
                                          recalculate_all_time)
            # topology phases score genetically and leave time vectors
            # stale; refresh before reporting (see models/timetree.py)
            recalculate_all_time(self.time_ctx, self.tree, self.root)
            time_lk = calculate_tree_likelihood_time(
                self.time_ctx, self.tree, self.root)
            print(f"Time LK: {time_lk}")
            total += time_lk
        with open(self.cfg.output + suffix, "w") as f:
            f.write(str(total) + "\n")
        return total

    def run_time_em(self, label: str):
        """Iterated mutation-rate EM to convergence (reference :11664-11683,
        :11919-11940)."""
        from .models import timetree as tt
        T = self.time_ctx
        tree = self.tree
        t1 = self.root
        tt.recalculate_all_time(T, tree, t1)
        old_lk = tt.calculate_tree_likelihood_time(T, tree, t1)
        print(f"pre-EM mutation rate {T.mut_rate} time LK before "
              f"{label}: {old_lk}")
        _c, _w, rate = tt.em_mut_rate(T, tree, t1)
        T.set_mut_rate(rate)
        tt.recalculate_all_time(T, tree, t1)
        new_lk = tt.calculate_tree_likelihood_time(T, tree, t1)
        print(f"EM {label} terminated, using mutation rate {rate} "
              f"time LK: {new_lk}")
        num_steps = 0
        while new_lk - old_lk > 0.1 and num_steps < 20:
            _c, _w, rate = tt.em_mut_rate(T, tree, t1)
            T.set_mut_rate(rate)
            tt.recalculate_all_time(T, tree, t1)
            old_lk = new_lk
            new_lk = tt.calculate_tree_likelihood_time(T, tree, t1)
            num_steps += 1
        print(f"New time LK step {num_steps} mutRate {T.mut_rate}: "
              f"{new_lk}")

    # ------------------------------------------------------------------
    def setup_input_tree(self):
        """Online mode: load the input tree, build all genome lists from the
        alignment, update the model from observed pseudo-counts, and run the
        initial EM (reference :3648-3655, :6430-6448, :11039-11079)."""
        cfg = self.cfg
        from .io.newick import read_newick
        trees, names_in_tree, names_dict = read_newick(
            cfg.inputTree, dirtiness=cfg.largeUpdate, create_dict=True,
            only_terminal_node_name=cfg.forgetInputTreeInternalNodeNames,
            default_blen=cfg.defaultBLen,
            normalize_input_blen=cfg.normalizeInputBLen,
            keep_iqtree_supports=cfg.keepInputIQtreeSupports,
            use_hnz=bool(cfg.HnZ),
            use_time=self.time_ctx is not None)
        tree, root = trees[0]
        print("Read input newick tree")
        make_tree_binary(tree, root)
        self.tree = tree
        self.root = root
        self.names_in_tree = names_in_tree
        self.samples_in_tree = set(names_dict)
        self.rt = TreeRuntime(tree, self.refd, self.model, self.dc, cfg,
                              tracer=self.tracer)
        # online time mode: the runtime needs the time context BEFORE the
        # first_setup recompute so tip dateData and time vectors are built
        # from the input tree (reference reCalculateAllGenomeListsTime
        # :1380-1531 is fired by its setup path the same way)
        self.rt.time = self.time_ctx
        if cfg.HnZ:
            from .runtime.tree import calculate_ndesc0
            calculate_ndesc0(tree, root, self.dc.effectivelyNon0BLen)
        num_samples = len(names_in_tree)
        if not cfg.inputRates:
            self.rt.recalculate_all(
                root, count_pseudo_counts=True,
                pseudo_mut_counts=self.model.pseudo_counts,
                data=self.data, names=names_in_tree, first_setup=True)
            if cfg.model != "JC":
                self.model.update_from_pseudo_counts()
            self.rt.recalculate_all(root)
        else:
            self.rt.recalculate_all(root, data=self.data,
                                    names=names_in_tree, first_setup=True)
        print("Genome lists for initial tree calculated.")
        # Error-model activation happens AFTER the genome lists are built
        # (reference :10997-10999): tips are constructed error-model-off
        # (with shared-ambiguity aliasing), and the initial EM below reads
        # those pre-activation vectors under error-model semantics — the
        # "stale window", run on the Python kernels.
        if self.error_model_requested() and (
                num_samples > cfg.minNumSamplesForErrorModel
                or not cfg.largeUpdate):
            if self.rt.kern.name == "native":
                self.rt.convert_backend("python")
                from .core.genomelist import reshare_tip_ambiguities
                reshare_tip_ambiguities(self.tree)
            self.model.using_error_rate = True
            self.model.version += 1
        # initial EM on the input tree (reference :11039-11079)
        if num_samples > 1 and (
                cfg.model != "JC"
                or (num_samples >= cfg.minNumSamplesForRateVar
                    and self.model.use_rate_variation)
                or (num_samples >= cfg.minNumSamplesForErrorModel
                    and self.model.using_error_rate)):
            self.run_em_step(rates_update="using")
            self.rt.recalculate_all(root)
            # stale window over: internal vectors now carry steady-state
            # error-model layouts
            self._restore_native_backend()
            lk = self.rt.calculate_tree_likelihood(root)
            print(f"LK after first EM: {lk}")
            if self.model.using_error_rate and (
                    cfg.estimateErrorRate
                    or cfg.estimateSiteSpecificErrorRate):
                old_lk = float("-inf")
                steps = 0
                while lk - old_lk > 1.0 and steps < 20:
                    improvement = 0
                    if not cfg.doNotOptimiseBLengths:
                        set_all_dirty(self.tree, root)
                        improvement = optimize_branch_lengths(self.rt, root)
                    self.rt.recalculate_all(root)
                    lk_branch = self.rt.calculate_tree_likelihood(root)
                    print(f"Updated {improvement} branch lengths leading "
                          f"to LK {lk_branch}")
                    self.run_em_step(rates_update="using")
                    self.rt.recalculate_all(root)
                    old_lk = lk
                    lk = self.rt.calculate_tree_likelihood(root)
                    print(f"New LK step {steps}: {lk}")
                    steps += 1

    # ------------------------------------------------------------------
    def run(self):
        """Full pipeline: de-novo or online inference.  What it runs
        records into ``self.tracer`` (as span ``run``), which is closed
        and kept in ``runtime.phases.recent()`` when it returns."""
        try:
            with self.tracer.span("run"):
                whole = self._stages()
            if whole:
                print(f"Phase breakdown (exclusive seconds by span; "
                      f"counters): {self.tracer.breakdown()}", flush=True)
        finally:
            self.tracer.close()

    def _stages(self) -> bool:
        """The stages of ``run``; False where a mode that is not inference
        returned early."""
        cfg = self.cfg
        if cfg.assignmentFile or cfg.assignmentFileCSV:
            from .analysis.lineages import run_lineage_assignment_mode
            run_lineage_assignment_mode(cfg)
            return False
        if cfg.inputRFtrees:
            from .analysis.rf import run_rf_mode
            out = run_rf_mode(cfg)
            print(f"RF distances written to {out}")
            return False
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
            from .analysis.placements import find_sample_placements_mode
            find_sample_placements_mode(self)
            return False
        if cfg.lineageRefs:
            if not cfg.inputTree:
                raise ValueError("--lineageRefs requires --inputTree")
            from .analysis.placements import (
                assign_lineages_by_reference_placement)
            from .io.maple_format import read_maple_alignment
            ref2, lineage_data = read_maple_alignment(cfg.lineageRefs)
            if ref2 != self.refd.ref:
                raise ValueError("lineage reference genome differs from "
                                 "the alignment reference")
            assign_lineages_by_reference_placement(self, lineage_data)
            return False
        if getattr(cfg, "device_placement", False) and not cfg.inputTree:
            self.build_initial_tree_device(
                warmup=cfg.device_warmup, batch_size=cfg.device_batch_size)
        else:
            self.build_initial_tree()
        self.post_placement()

        if not cfg.doNotReroot:
            from .search.rootsearch import find_best_root
            print("Looking for possible better root", flush=True)
            new_t1 = find_best_root(self.rt, self.root,
                                    abayes_on=cfg.SPRTA)
            if new_t1 != self.root:
                self.root = new_t1
                self._after_reroot()

        if cfg.writeTreesToFileEveryTheseSteps > 0 \
                or cfg.writeLKsToFileEveryTheseSteps > 0:
            self.rt.trace = TraceState(cfg, self.names_in_tree)
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
        return True

    def _after_reroot(self):
        cfg = self.cfg
        rt = self.rt
        t1 = self.root
        print("Better root found")
        ses = None
        if self._native_session_eligible():
            from .native.engine import open_native_session
            ses = open_native_session(rt, t1)
        try:
            if cfg.model != "JC" or cfg.rateVariation \
                    or cfg.estimateErrorRate \
                    or cfg.estimateSiteSpecificErrorRate:
                self.run_em_step()
                rt.recalculate_all(t1)
            if not cfg.doNotOptimiseBLengths:
                optimize_branch_lengths(rt, t1)
                rt.recalculate_all(t1)
            from .search.rootsearch import find_best_root
            print("Looking a second time for possible better root",
                  flush=True)
            new_t1 = find_best_root(rt, t1, abayes_on=cfg.SPRTA)
            if new_t1 != t1:
                self.root = new_t1
                rt.recalculate_all(self.root)
        finally:
            if ses is not None:
                ses.close()

    @method_span("write")
    def write_outputs(self, suffix_add="", from_rounds=None):
        """Final outputs for one round (reference :12481-12555 and the
        nRounds==0 path :12556-12630).  ``from_rounds`` mirrors a quirk of
        the reference's two writers: only the rounds-loop one adds the
        time likelihood into _LK.txt (:12512-12515); the nRounds==0 path
        (:12584) writes the genetic likelihood alone."""
        cfg = self.cfg
        if from_rounds is None:
            from_rounds = bool(suffix_add)
        self.write_subs(suffix_add + "_subs.txt")
        total = self.write_lk(suffix_add + "_LK.txt",
                              include_time=from_rounds)
        print(f"totalLK: {total}", flush=True)
        if cfg.estimateErrors:
            from .analysis.errors import calculate_error_probabilities
            fname = cfg.output + suffix_add + "_estimatedErrors.txt"
            with open(fname, "w") as fh:
                calculate_error_probabilities(
                    self.rt, self.root, fh, cfg.minErrorProb,
                    self.names_in_tree)
            print(f"Errors estimated, written to file {fname}")
        annotations = None
        if cfg.SPRTA or cfg.estimateMAT:
            if cfg.estimateMAT:
                expectation_maximization_rates(self.rt, self.root,
                                               track_mutations=True)
            annotations = AnnotationOptions(
                aBayesPlus=cfg.SPRTA, estimateMAT=cfg.estimateMAT,
                networkOutput=cfg.networkOutput,
                supportFor0Branches=cfg.supportFor0Branches,
                usingErrorRate=self.model.using_error_rate,
                keepInputIQtreeSupports=cfg.keepInputIQtreeSupports,
                minMutProb=cfg.minMutProb,
                effectivelyNon0BLen=self.dc.effectivelyNon0BLen,
                root_state_fn=lambda tree, node: self.rt.kern.export(
                    self.rt.root_vector(
                        tree.probVect[node], False,
                        (len(tree.children[node]) == 0
                         and len(tree.minorSequences[node]) == 0), node)))
            s = create_newick(
                self.tree, self.root, binary=not cfg.nonBinaryTree,
                names_in_tree=self.names_in_tree, annotations=annotations,
                support_for_identical=cfg.supportForIdenticalSequences)
            write_nexus(cfg.output + suffix_add + "_nexusTree.tree", s,
                        self.names_in_tree)
            from .io.tsv import write_tsv_file
            write_tsv_file(self, cfg.output + suffix_add + "_metaData.tsv")
        self.write_tree(suffix_add + "_tree.tree")


def run_inference(cfg: MapleConfig, device: torch.device) -> Run:
    run = Run(cfg, device)
    run.run()
    return run
