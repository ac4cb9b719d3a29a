"""Reference-genome tables and substitution-model state.

Host-side (numpy) twins of the reference's module-level tables
(MAPLEv0.7.5.4.py:3606-3693, :4012-4060, :6350-6390); device-resident copies
are created by :mod:`maple_tpu_torch.ops` when batched kernels run.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from math import log
from typing import List, Optional

import numpy as np

ALLELES = {"a": 0, "c": 1, "g": 2, "t": 3}
ALLELES_LIST = ["A", "C", "G", "T"]
# Ambiguity codes as *unnormalized* indicator vectors (reference :3678).
AMBIGUITIES = {
    "y": [0.0, 1.0, 0.0, 1.0],
    "r": [1.0, 0.0, 1.0, 0.0],
    "w": [1.0, 0.0, 0.0, 1.0],
    "s": [0.0, 1.0, 1.0, 0.0],
    "k": [0.0, 0.0, 1.0, 1.0],
    "m": [1.0, 1.0, 0.0, 0.0],
    "d": [1.0, 0.0, 1.0, 1.0],
    "v": [1.0, 1.0, 1.0, 0.0],
    "h": [1.0, 1.0, 0.0, 1.0],
    "b": [0.0, 1.0, 1.0, 1.0],
}

# pristine copies: the per-code lists above are intentionally shared across
# tips (reference :3959) and mutated in place by error-model refreshes;
# each Run restores them so successive runs in one process stay independent
_AMBIGUITIES_PRISTINE = {k: tuple(v) for k, v in AMBIGUITIES.items()}


def reset_ambiguities():
    for k, v in _AMBIGUITIES_PRISTINE.items():
        AMBIGUITIES[k][:] = v



@dataclass
class RefData:
    """Immutable per-genome tables derived from the reference sequence."""

    ref: str                       # lowercase reference genome
    lRef: int
    ref_indices: List[int]         # nucleotide index per position (amb -> 0)
    cumulative_bases: List[List[int]]   # (lRef+1) x 4 cumulative base counts
    root_freqs: List[float]
    root_freqs_log: List[float]

    @classmethod
    def build(cls, ref: str, model: str = "GTR") -> "RefData":
        ref = ref.lower()
        lRef = len(ref)
        ref_indices = [ALLELES.get(c, 0) for c in ref]
        cumulative = [[0, 0, 0, 0]]
        for i, c in enumerate(ref):
            row = list(cumulative[i])
            if c in ALLELES:
                row[ALLELES[c]] += 1
            cumulative.append(row)
        if model == "JC":
            root_freqs = [0.25, 0.25, 0.25, 0.25]
        else:
            root_freqs = [cumulative[-1][i] / float(lRef) for i in range(4)]
        return cls(
            ref=ref,
            lRef=lRef,
            ref_indices=ref_indices,
            cumulative_bases=cumulative,
            root_freqs=root_freqs,
            root_freqs_log=[log(f) for f in root_freqs],
        )


# Starting pseudocounts biased toward SARS-CoV-2-like transition patterns
# (reference :4056).
INITIAL_PSEUDO_COUNTS = [
    [0.0, 1.0, 5.0, 2.0],
    [2.0, 0.0, 1.0, 40.0],
    [5.0, 2.0, 0.0, 20.0],
    [2.0, 3.0, 1.0, 0.0],
]

JC_MATRIX = [
    [-1.0, 1.0 / 3, 1.0 / 3, 1.0 / 3],
    [1.0 / 3, -1.0, 1.0 / 3, 1.0 / 3],
    [1.0 / 3, 1.0 / 3, -1.0, 1.0 / 3],
    [1.0 / 3, 1.0 / 3, 1.0 / 3, -1.0],
]


def normalized_rate_matrix(pseudo_counts, root_freqs, model: str):
    """Build a normalized 4x4 rate matrix from substitution pseudo-counts.

    UNREST: rate[i][j] = counts[i][j]/pi_i; GTR symmetrizes counts first.
    Normalized so the stationary total rate is 1 (reference :4012-4040).
    """
    mat = [[0.0] * 4 for _ in range(4)]
    for i in range(4):
        tot = 0.0
        for j in range(4):
            if j == i:
                continue
            if model == "UNREST":
                mat[i][j] = pseudo_counts[i][j] / root_freqs[i]
            elif model == "GTR":
                mat[i][j] = (pseudo_counts[i][j] + pseudo_counts[j][i]) / root_freqs[i]
            else:
                raise ValueError(f"model {model!r} has no pseudo-count estimator")
            tot += mat[i][j]
        mat[i][i] = -tot
    tot_rate = -sum(root_freqs[i] * mat[i][i] for i in range(4))
    for i in range(4):
        for j in range(4):
            mat[i][j] /= tot_rate
    return mat


@dataclass
class Model:
    """Mutable substitution-model state shared by all kernels.

    Bundles what the reference passes around as ``mutMatrixGlobal`` /
    ``mutMatrices`` / ``cumulativeRate`` / error-rate arrays
    (reference :4012-4060, :6350-6390).
    """

    refd: RefData
    model_name: str = "GTR"
    mut_matrix: List[List[float]] = None            # 4x4 normalized rates
    pseudo_counts: List[List[float]] = None
    # rate variation
    use_rate_variation: bool = False
    site_rates: Optional[List[float]] = None
    mut_matrices: Optional[List[List[List[float]]]] = None  # per-site 4x4
    cumulative_rate: List[float] = None             # prefix sums of -diag rate
    # error model
    using_error_rate: bool = False
    error_rate_site_specific: bool = False
    error_rate: float = 0.0
    error_rates: Optional[List[float]] = None
    cumulative_error_rate: Optional[List[float]] = None
    tot_error: Optional[float] = None
    root_freqs_log_error_cumulative: Optional[List[float]] = None

    # monotonically bumped when any rate/error table changes; device caches
    # in maple_tpu_torch.ops key on this.
    version: int = 0

    @classmethod
    def initial(cls, refd: RefData, model_name: str = "GTR") -> "Model":
        m = cls(refd=refd, model_name=model_name)
        m.pseudo_counts = [row[:] for row in INITIAL_PSEUDO_COUNTS]
        if model_name == "JC":
            m.mut_matrix = [row[:] for row in JC_MATRIX]
        else:
            m.mut_matrix = normalized_rate_matrix(
                m.pseudo_counts, refd.root_freqs, model_name)
        m.refresh_cumulative_rate()
        return m

    def refresh_cumulative_rate(self):
        """Rebuild cumulative_rate (and per-site matrices if rate variation).

        Vectorized with ``np.add.accumulate``, whose left-to-right
        sequential semantics produce bit-identical floats to the scalar
        loop (np.cumsum/np.sum pairwise summation would not); ``.tolist()``
        keeps the table as Python floats so downstream builtin ``sum()``
        stays Neumaier-compensated.  Called every 25 placed samples
        (reference updateSubMatrix cadence), so the O(lRef) Python loop it
        replaces was ~3% of placement wall at 10k samples."""
        refi = getattr(self.refd, "_ref_idx_np", None)
        if refi is None:
            refi = np.asarray(self.refd.ref_indices, dtype=np.intp)
            self.refd._ref_idx_np = refi
        diag = np.asarray([self.mut_matrix[i][i] for i in range(4)],
                          dtype=np.float64)
        vals = diag[refi]
        if self.site_rates is not None:
            vals = vals * np.asarray(self.site_rates, dtype=np.float64)
            self.mut_matrices = [
                [[self.mut_matrix[j][k] * r for k in range(4)] for j in range(4)]
                for r in self.site_rates
            ]
            self.use_rate_variation = True
        cum = np.empty(self.refd.lRef + 1, dtype=np.float64)
        cum[0] = 0.0
        np.add.accumulate(vals, out=cum[1:])
        self.cumulative_rate = cum.tolist()
        # numpy twin for the native store sync (store_set_model copies
        # from a C buffer): avoids re-converting the 30k-element Python
        # list every model refresh — measured 1.6 s of a 50k placement
        self.cumulative_rate_np = cum
        self.version += 1

    def update_from_pseudo_counts(self) -> bool:
        """Re-estimate mut_matrix from pseudo-counts; True if it changed
        enough (>0.001 summed |delta| off-diagonal) to need table refresh
        (reference updateSubMatrix :4012-4049)."""
        if self.model_name == "JC":
            return False
        new = normalized_rate_matrix(
            self.pseudo_counts, self.refd.root_freqs, self.model_name)
        change = sum(
            abs(new[i][j] - self.mut_matrix[i][j])
            for i in range(4) for j in range(4) if i != j)
        if change > 0.001:
            self.mut_matrix = new
            self.refresh_cumulative_rate()
            return True
        return False

    def set_error_rates(self, error_rate: float,
                        error_rates: Optional[List[float]] = None,
                        activate: bool = True):
        """Install (site-specific) error rates and derived cumulative tables
        (reference updateErrorRates :6373-6390).  With activate=False the
        tables are prepared but kernels keep ignoring the error model (the
        reference's usingErrorRate stays False until post-placement for
        de-novo runs, :11779)."""
        refd = self.refd
        if activate:
            self.using_error_rate = True
        self.error_rate = error_rate
        self.error_rates = error_rates
        self.error_rate_site_specific = error_rates is not None
        rfle = [0.0] * (refd.lRef + 1)
        if error_rates is not None:
            cum = [0.0] * (refd.lRef + 1)
            for i in range(refd.lRef):
                cum[i + 1] = cum[i] + error_rates[i]
                rfle[i + 1] = rfle[i] + log(
                    refd.root_freqs[refd.ref_indices[i]]
                    * (1.0 - 1.33333 * error_rates[i]) + 0.333333 * error_rates[i])
            self.cumulative_error_rate = cum
            self.tot_error = -cum[-1]
        else:
            for i in range(refd.lRef):
                rfle[i + 1] = rfle[i] + log(
                    refd.root_freqs[refd.ref_indices[i]]
                    * (1.0 - 1.33333 * error_rate) + 0.333333 * error_rate)
            self.tot_error = -error_rate * refd.lRef
        self.root_freqs_log_error_cumulative = rfle
        self.version += 1
