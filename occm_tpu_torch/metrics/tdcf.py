"""Tandem detection cost function (t-DCF) for spoofing countermeasures
(the port's own copy of `occm_tpu.metrics.tdcf`).

Beyond-reference capability: the reference repo evaluates with EER only
(evaluate_metrics.py:34-40), but ASVspoof2019/2021 — the datasets the
reference targets (SURVEY.md §0) — rank systems by **normalized minimum
t-DCF**, so a reference user migrating here gets the challenge's primary
metric natively. Implements both published revisions of the cost function
(Kinnunen et al., "t-DCF: a Detection Cost Function for the Tandem
Assessment of Spoofing Countermeasures and Automatic Speaker
Verification", 2018/2020):

- ``v1`` — the original ASVspoof2019 evaluation-plan form,
    t-DCF(s) = C1·Pmiss_cm(s) + C2·Pfa_cm(s),  normalized by min(C1, C2)
- ``v2`` — the revised constant-offset form used for ASVspoof2021 and the
  re-stated 2019 results,
    t-DCF(s) = C0 + C1·Pmiss_cm(s) + C2·Pfa_cm(s),
  normalized by C0 + min(C1, C2)

The ASV operating point enters only through three error rates
(``AsvErrorRates``); they can be supplied directly (the challenge
organisers publish them) or derived from raw ASV trial scores with
``asv_error_rates`` (threshold fixed at the target/non-target EER point,
as the official evaluation does). Pure NumPy on host — score
post-processing, not accelerator work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from occm_tpu_torch.metrics.eer import compute_det_curve, compute_eer


@dataclass(frozen=True)
class TDCFCostModel:
    """Priors and costs. Defaults are the official ASVspoof2019-LA values:
    a 5% spoof prior with the remaining 95% split 99:1 target:non-target,
    misses cheap, false accepts expensive."""

    p_target: float = 0.9405
    p_nontarget: float = 0.0095
    p_spoof: float = 0.05
    c_miss: float = 1.0        # cost of rejecting a target speaker
    c_fa: float = 10.0         # cost of accepting a non-target speaker
    c_fa_spoof: float = 10.0   # cost of accepting a spoof (v2; v1 ties it
    #                            to the CM false-accept cost, same default)

    def validate(self) -> None:
        total = self.p_target + self.p_nontarget + self.p_spoof
        if not np.isclose(total, 1.0, atol=1e-9):
            raise ValueError(f"priors must sum to 1, got {total}")
        if min(self.p_target, self.p_nontarget, self.p_spoof) < 0:
            raise ValueError("priors must be non-negative")
        if min(self.c_miss, self.c_fa, self.c_fa_spoof) <= 0:
            raise ValueError("costs must be positive")


@dataclass(frozen=True)
class AsvErrorRates:
    """ASV error rates at its fixed operating point (its tar/non EER
    threshold): P(reject target), P(accept non-target), P(reject spoof)."""

    p_miss_asv: float
    p_fa_asv: float
    p_miss_spoof_asv: float


def asv_error_rates(
    target_scores: np.ndarray,
    nontarget_scores: np.ndarray,
    spoof_scores: np.ndarray,
) -> AsvErrorRates:
    """Derive the ASV operating-point error rates from raw ASV scores.

    The threshold is the target/non-target EER threshold (the official
    t-DCF tooling's choice); spoof trials are then measured against it.
    Scores are similarity scores: accept when score >= threshold.
    """
    target_scores = np.asarray(target_scores, dtype=np.float64).ravel()
    nontarget_scores = np.asarray(nontarget_scores, dtype=np.float64).ravel()
    spoof_scores = np.asarray(spoof_scores, dtype=np.float64).ravel()
    _, threshold = compute_eer(target_scores, nontarget_scores)
    return AsvErrorRates(
        p_miss_asv=float(np.mean(target_scores < threshold)),
        p_fa_asv=float(np.mean(nontarget_scores >= threshold)),
        p_miss_spoof_asv=float(np.mean(spoof_scores < threshold)),
    )


def _tdcf_coefficients(
    cost: TDCFCostModel, asv: AsvErrorRates, version: str
) -> Tuple[float, float, float]:
    """Return (C0, C1, C2) for tDCF(s) = C0 + C1·Pmiss_cm + C2·Pfa_cm."""
    if version == "v1":
        c0 = 0.0
        c1 = (
            cost.p_target * (cost.c_miss - cost.c_miss * asv.p_miss_asv)
            - cost.p_nontarget * cost.c_fa * asv.p_fa_asv
        )
        c2 = cost.c_fa_spoof * cost.p_spoof * (1.0 - asv.p_miss_spoof_asv)
    elif version == "v2":
        c0 = (
            cost.p_target * cost.c_miss * asv.p_miss_asv
            + cost.p_nontarget * cost.c_fa * asv.p_fa_asv
        )
        c1 = cost.p_target * cost.c_miss - c0
        c2 = cost.p_spoof * cost.c_fa_spoof * (1.0 - asv.p_miss_spoof_asv)
    else:
        raise ValueError(f"unknown t-DCF version {version!r} (v1|v2)")
    if c1 < 0 or c2 < 0:
        raise ValueError(
            "negative t-DCF coefficient — the ASV operating point is worse "
            f"than chance for this cost model (C1={c1:.6g}, C2={c2:.6g})"
        )
    return c0, c1, c2


def compute_tdcf_curve(
    bonafide_cm_scores: np.ndarray,
    spoof_cm_scores: np.ndarray,
    asv: AsvErrorRates,
    cost: TDCFCostModel = TDCFCostModel(),
    version: str = "v2",
) -> Tuple[np.ndarray, np.ndarray]:
    """Normalized t-DCF over every CM threshold.

    CM scores are bonafide-likeness (accept-as-bonafide when score >=
    threshold — the calculate_eer.py convention, reference:
    calculate_eer.py:25). Returns (tdcf_norm, thresholds); thresholds come
    from the same stable-mergesort DET sweep as the EER
    (occm_tpu_torch/metrics/eer.py), so both metrics read off one curve.
    """
    cost.validate()
    c0, c1, c2 = _tdcf_coefficients(cost, asv, version)
    # DET over CM scores with bonafide as target: frr = Pmiss_cm (bonafide
    # rejected), far = Pfa_cm (spoof accepted).
    p_miss_cm, p_fa_cm, thresholds = compute_det_curve(
        np.asarray(bonafide_cm_scores, dtype=np.float64).ravel(),
        np.asarray(spoof_cm_scores, dtype=np.float64).ravel(),
    )
    tdcf = c0 + c1 * p_miss_cm + c2 * p_fa_cm
    denom = c0 + min(c1, c2)
    if denom <= 0:
        raise ValueError(
            "degenerate cost model: C0 + min(C1, C2) <= 0 — a do-nothing "
            "countermeasure has zero cost, nothing to normalize against"
        )
    return tdcf / denom, thresholds


def compute_min_tdcf(
    bonafide_cm_scores: np.ndarray,
    spoof_cm_scores: np.ndarray,
    asv: AsvErrorRates,
    cost: TDCFCostModel = TDCFCostModel(),
    version: str = "v2",
) -> Tuple[float, float]:
    """Normalized minimum t-DCF and the CM threshold achieving it.

    1.0 is the do-nothing floor (a CM that accepts or rejects everything);
    0.0 (v1) / C0-normalized (v2) is a perfect CM at this ASV operating
    point.
    """
    tdcf_norm, thresholds = compute_tdcf_curve(
        bonafide_cm_scores, spoof_cm_scores, asv, cost, version
    )
    idx = int(np.argmin(tdcf_norm))
    return float(tdcf_norm[idx]), float(thresholds[idx])


def read_asv_scores(path: str) -> AsvErrorRates:
    """Load ASV trial scores from a text file of `key score` rows, where
    key is target|nontarget|spoof (the official ASVspoof ASV score files
    carry these keys; extra leading columns are ignored — the last column
    is the score, the second-to-last the key)."""
    tar, non, spoof = [], [], []
    buckets = {"target": tar, "nontarget": non, "spoof": spoof}
    with open(path, "r", encoding="utf-8") as fh:
        for line_no, line in enumerate(fh, 1):
            parts = line.split()
            if not parts:
                continue
            if len(parts) < 2 or parts[-2] not in buckets:
                raise ValueError(
                    f"{path}:{line_no}: expected `... key score` with key "
                    f"in target|nontarget|spoof, got {line.rstrip()!r}"
                )
            buckets[parts[-2]].append(float(parts[-1]))
    if not tar or not non:
        raise ValueError(
            f"{path}: need at least one target and one nontarget ASV trial"
        )
    return asv_error_rates(
        np.asarray(tar), np.asarray(non),
        np.asarray(spoof) if spoof else np.asarray([-np.inf]),
    )
