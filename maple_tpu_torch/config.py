"""Run configuration for maple-tpu.

Mirrors the flag surface of the reference CLI (MAPLEv0.7.5.4.py:26-128) as a
dataclass instead of module globals, plus the genome-length-derived thresholds
(reference: MAPLEv0.7.5.4.py:3606-3693).
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, field
from math import log


@dataclass
class MapleConfig:
    """All user-facing options.

    Field names follow the reference flags (camelCase preserved where it aids
    cross-checking parity with the reference CLI, reference lines :26-128).
    """

    # important options
    input: str = "MAPLE_input.txt"
    reference: str = ""
    model: str = "GTR"  # JC | GTR | UNREST
    output: str = "MAPLE_output"
    inputTree: str = ""
    inputRates: str = ""
    largeUpdate: bool = False
    inputRFtrees: str = ""
    overwrite: bool = False
    fast: bool = False
    rateVariation: bool = False
    estimateMAT: bool = False
    doNotImproveTopology: bool = False
    saveInitialTreeEvery: int = 50000
    doNotPlaceNewSamples: bool = False
    doNotReroot: bool = False
    noLocalRef: bool = False
    # parallelization
    numCores: int = 1
    # thresholds
    minNumNon4: int = 1
    maxNumDescendantsForMATClade: int = 50
    noFastTopologyInitialSearch: bool = False
    thresholdProb: float = 1e-8
    thresholdLogLK: float = 18.0
    thresholdLogLKtopology: float = 14.0
    allowedFails: int = 5
    allowedFailsTopology: int = 4
    numTopologyImprovements: int = 1
    thresholdTopologyPlacement: float = -0.1
    updateSubstMatrixEveryThisSamples: int = 25
    nonStrictStopRules: bool = False
    strictTopologyStopRules: bool = False
    thresholdDiffForUpdate: float = 1e-5
    thresholdFoldChangeUpdate: float = 1.01
    thresholdLogLKconsecutivePlacement: float = 1.0
    thresholdLogLKTopologySubRoundImprovement: float = 3.0
    minBLenSensitivity: float = 0.001
    thresholdLogLKoptimization: float = 1.0
    thresholdLogLKoptimizationTopology: float = 1.0
    maxReplacements: int = 10
    useFixedThresholdLogLKoptimizationTopology: bool = False
    minNumSamplesForRateVar: int = 510000
    minNumSamplesForErrorModel: int = 510000
    deeperSearchForLongBranches: bool = False
    # lineage assignment
    assignmentFileCSV: str = ""
    assignmentFile: str = ""
    inputNexusTree: str = ""
    reRoot: str = ""
    lineageRefs: str = ""
    lineageRefsThresh: float = 0.2
    lineageRefsSupportThresh: float = 0.95
    allowMultiLineagesPerNode: bool = False
    findSamplePlacements: bool = False
    threshMutation: float = 0.01
    # rarer options
    defaultBLen: float = 0.000033
    normalizeInputBLen: float = 1.0
    multipleInputRFTrees: bool = False
    debugging: bool = False
    onlyNambiguities: bool = False
    nonBinaryTree: bool = False
    writeTreesToFileEveryTheseSteps: int = 0
    writeLKsToFileEveryTheseSteps: int = 0
    noSubroundTrees: bool = False
    doNotOptimiseBLengths: bool = False
    forgetInputTreeInternalNodeNames: bool = False
    # error model
    estimateErrorRate: bool = False
    estimateSiteSpecificErrorRate: bool = False
    errorRateInitial: float = 0.0
    errorRateFixed: float = 0.0
    errorRateSiteSpecificFile: str | None = None
    estimateErrors: bool = False
    minErrorProb: float = 0.01
    # SPRTA
    SPRTA: bool = False
    networkOutput: bool = False
    minBranchSupport: float = 0.01
    supportFor0Branches: bool = False
    minMutProb: float = 0.01
    keepInputIQtreeSupports: bool = False
    # HnZ
    HnZ: int = 0
    # time tree
    datesFile: str | None = None
    intervalLength: int = 7
    strainName: str = "strain"
    dateName: str = "date"
    minSamplingYear: int | None = None
    maxSamplingYear: int | None = None
    mutRate: float = 0.09
    minMutRate: float = 0.03
    timeProbThreshold: float = 0.0001
    minNumSamplesForMutRate: int = 1000

    # --- device knobs (no reference analogue) ---
    device_batch_min: int = 16       # min candidate batch before offloading to device
    entry_budget: int = 256          # padded entries per packed genome list
    use_device_kernels: bool = True  # allow batched device scoring
    device_placement: bool = False   # device-batched initial placement
    device_pallas: bool = False      # legacy placer: score with the pair kernel (ops/append_pairs)
    device_topology: bool = False    # device-screened SPR proposals (parallel/batch_spr)
    device_warmup: int = 256         # samples placed serially before batching
    device_batch_size: int = 64      # samples per device-scored batch
    # Proxy-screen knobs (-1 = auto).  Two contracts resolve differently:
    # the default (exact) contract — decision parity with the serial
    # engine path — keeps deep seed
    # lists and an f32 pool with exact top-k; the --fast contract
    # matches the production host preset's quality bar instead
    # (budgeted search, LK-tolerance), so the screen runs bf16 over a
    # narrower feature space, with shallower seed lists and bigger
    # batches.
    device_proxy_batch: int = -1     # samples per proxy-screen batch
    device_seed_topm: int = -1       # screen candidates handed to the engine
    device_seed_budget: int = -1     # seeded-crawl non-improvement budget
    kernel_backend: str = "native"   # "native" (C++ kernels) or "python"
    native_error_model: bool = True  # native kernels after error-model activation (alias-tagged)
    # Best-first placement search: during stepwise addition, expand the
    # highest-scoring frontier node first and stop after this many
    # consecutive non-improving candidate scores (0 = reference-exact
    # DFS).  Bounds the per-sample search at O(depth + budget) instead of
    # O(tree size) — the scale lever for >=50k-sample runs.  Placements
    # can differ from the reference's near-tied choices; final-LK
    # closeness is pinned by tests/test_beam_placement.py.  Requires the
    # native engine.
    placementBudget: int = 0
    # SPR-crawl budget: during topology improvement, each pruned node's
    # re-attachment crawl stops after this many consecutive non-improving
    # candidate scores (0 = reference-exact stop rules only).  The crawl
    # radiates outward from the prune point, so the budget confines it to
    # the local neighborhood where SPR moves land — the scale lever for
    # the topology phase, complementing placementBudget.  Requires the
    # native SPR pass; quality pinned by tests/test_beam_placement.py.
    topologyBudget: int = 0
    # Root-search budget: findBestRoot's crawl runs best-first (on path
    # score) and stops after this many consecutive non-improving scored
    # re-rooting candidates (0 = reference-exact DFS stop rules).  On
    # flat pandemic-scale trees the exact crawl visits essentially every
    # internal node (measured ~98% at 20k samples) — the root-search twin
    # of placementBudget/topologyBudget.  Requires the native engine;
    # quality pinned by tests/test_beam_placement.py.
    # -1 = auto: resolves to 1000 under --fast at >=50k samples (where the
    # budgeted crawl was measured quality-neutral: 100k LK within 0.03 and
    # RF 111-vs-112 of the exact crawl, at 1/5 the root-phase wall) and to
    # 0 (exact) everywhere else.  Set 0 to force the exact crawl, >0 to
    # force a budget.
    rootSearchBudget: int = -1
    # Time-aware SPR scoring (--datesFile runs only): carry sampling-time
    # likelihood terms through the SPR crawl and candidate re-optimization
    # so topology decisions weigh time as well as genetic likelihood —
    # the reference's intended-but-unreachable design (appendProbNodeTime
    # consumed at :7031/:7254/:7507; its own time placement crashes
    # first).  Off by default: genetic-only SPR + full time recompute,
    # the documented deviation in models/timetree.py.
    timeAwareTopology: bool = False

    # fast-initial-search parameters (reference :220-224): fixed, not flags
    strictTopologyStopRulesInitial: bool = True
    allowedFailsTopologyInitial: int = 2
    thresholdLogLKtopologyInitial: float = 6.0
    thresholdTopologyPlacementInitial: float = -0.1

    def __post_init__(self):
        if self.fast:
            # reference :211-217 --fast preset overrides
            self.thresholdLogLK = 14.0
            self.allowedFails = 4
            self.allowedFailsTopology = 3
            self.thresholdLogLKtopology = 7.0
            self.thresholdTopologyPlacement = -1.0
            self.minBLenSensitivity = 0.001
        if self.device_proxy_batch < 0:
            # 2048 under the fast contract: fewer per-batch screen
            # overheads (result waits, uploads, drain/export); the
            # one-batch pipeline staleness window grows with the batch, a
            # re-validation-only cost (apply re-searches collisions
            # serially)
            self.device_proxy_batch = 2048 if self.fast else 256
        if self.fast and self.device_placement \
                and self.placementBudget == 0:
            # the apply phase's serial re-search fallback (stale-anchor
            # collisions) otherwise runs the reference-exact from-root
            # DFS; under the fast contract it gets the production
            # preset's budget crawl
            self.placementBudget = 200
        if self.device_seed_topm < 0:
            self.device_seed_topm = 32 if self.fast else 128
        if self.device_seed_budget < 0:
            self.device_seed_budget = 16 if self.fast else 128
        if self.estimateErrors and not (self.estimateSiteSpecificErrorRate
                                        or self.errorRateSiteSpecificFile):
            self.estimateSiteSpecificErrorRate = True

    @property
    def aBayesPlus(self) -> bool:
        return self.SPRTA

    @property
    def fastTopologyInitialSearch(self) -> bool:
        return not self.noFastTopologyInitialSearch

    @property
    def supportForIdenticalSequences(self) -> bool:
        return self.supportFor0Branches


@dataclass
class DerivedConfig:
    """Genome-length-scaled thresholds (reference :3606-3693).

    Built once per run from (MapleConfig, lRef); every kernel/search component
    reads these rather than re-deriving.
    """

    lRef: int
    thresholdProb: float
    thresholdProb2: float
    thresholdProb4: float
    thresholdLogLK: float
    thresholdLogLKtopology: float
    thresholdLogLKtopologyInitial: float
    thresholdLogLKoptimization: float
    thresholdLogLKoptimizationTopology: float
    effectivelyNon0BLen: float
    oneMutBLen: float
    minBLenSensitivity: float
    minimumCarryOver: float
    BLenThresholdDeeperSearch: float
    globalTotRate: float
    thresholdDiffForUpdate: float
    thresholdFoldChangeUpdate: float
    thresholdLogLKconsecutivePlacement: float
    errorRateGlobalInitial: float
    lineageRefsThresh: float

    @classmethod
    def build(cls, cfg: MapleConfig, lRef: int) -> "DerivedConfig":
        logLRef = log(lRef)
        return cls(
            lRef=lRef,
            thresholdProb=cfg.thresholdProb,
            thresholdProb2=cfg.thresholdProb ** 2,
            thresholdProb4=cfg.thresholdProb ** 4,
            thresholdLogLK=cfg.thresholdLogLK * logLRef,
            thresholdLogLKtopology=cfg.thresholdLogLKtopology * logLRef,
            thresholdLogLKtopologyInitial=(
                cfg.thresholdLogLKtopologyInitial * logLRef),
            thresholdLogLKoptimization=cfg.thresholdLogLKoptimization * logLRef,
            thresholdLogLKoptimizationTopology=(
                cfg.thresholdLogLKoptimizationTopology * logLRef),
            effectivelyNon0BLen=1.0 / (10 * lRef),
            oneMutBLen=1.0 / lRef,
            minBLenSensitivity=cfg.minBLenSensitivity / lRef,
            minimumCarryOver=sys.float_info.min * 1e50,
            BLenThresholdDeeperSearch=(logLRef + 5) / float(lRef),
            globalTotRate=-float(lRef),
            thresholdDiffForUpdate=cfg.thresholdDiffForUpdate,
            thresholdFoldChangeUpdate=cfg.thresholdFoldChangeUpdate,
            thresholdLogLKconsecutivePlacement=(
                cfg.thresholdLogLKconsecutivePlacement),
            errorRateGlobalInitial=(cfg.errorRateInitial
                                    if cfg.errorRateInitial else 1.0 / lRef),
            lineageRefsThresh=cfg.lineageRefsThresh / lRef,
        )
