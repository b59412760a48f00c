"""EER / DET-curve metrics, bit-compatible with the reference (the port's
own copy of `occm_tpu.metrics.eer`).

Parity target: reference evaluate_metrics.py:3-40. The DET curve is built by a
stable mergesort over the pooled scores, FRR/FAR come from cumulative sums, and
the EER is read off at the threshold minimising |FRR - FAR| (the mean of the
two rates at that index). `calculate_confusion_matrix` mirrors
evaluate_metrics.py:23-32.

Pure NumPy on host — this is score post-processing, not accelerator work.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def compute_det_curve(
    target_scores: np.ndarray, nontarget_scores: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Detection error trade-off curve.

    Returns (frr, far, thresholds), each of length n_target + n_nontarget + 1.
    The leading point is (frr=0, far=1) at a threshold just below the minimum
    score, matching reference evaluate_metrics.py:17-19.
    """
    target_scores = np.asarray(target_scores, dtype=np.float64).ravel()
    nontarget_scores = np.asarray(nontarget_scores, dtype=np.float64).ravel()

    n_scores = target_scores.size + nontarget_scores.size
    all_scores = np.concatenate((target_scores, nontarget_scores))
    labels = np.concatenate(
        (np.ones(target_scores.size), np.zeros(nontarget_scores.size))
    )

    # Stable sort so ties keep target-before-nontarget order, as the reference's
    # kind='mergesort' does — this affects the curve at tied scores.
    indices = np.argsort(all_scores, kind="mergesort")
    labels = labels[indices]

    tar_trial_sums = np.cumsum(labels)
    nontarget_trial_sums = nontarget_scores.size - (
        np.arange(1, n_scores + 1) - tar_trial_sums
    )

    frr = np.concatenate(
        (np.atleast_1d(0), tar_trial_sums / target_scores.size)
    )
    far = np.concatenate(
        (np.atleast_1d(1), nontarget_trial_sums / nontarget_scores.size)
    )
    thresholds = np.concatenate(
        (np.atleast_1d(all_scores[indices[0]] - 0.001), all_scores[indices])
    )
    return frr, far, thresholds


def compute_eer(
    target_scores: np.ndarray, nontarget_scores: np.ndarray
) -> Tuple[float, float]:
    """Equal error rate and its threshold (reference evaluate_metrics.py:34-40).

    NOTE on argument conventions: the reference calls this two opposite ways —
    `compute_eer(spoof, bonafide)` in evaluate.py:145 and
    `compute_eer(bonafide, spoof)` in calculate_eer.py:25. Both entry points are
    preserved in occm_tpu_torch.evaluate; this function itself is
    convention-neutral.
    """
    frr, far, thresholds = compute_det_curve(target_scores, nontarget_scores)
    abs_diffs = np.abs(frr - far)
    min_index = int(np.argmin(abs_diffs))
    eer = float(np.mean((frr[min_index], far[min_index])))
    return eer, float(thresholds[min_index])


def calculate_confusion_matrix(
    target_scores: np.ndarray, nontarget_scores: np.ndarray, threshold: float
) -> Tuple[int, int, int, int]:
    """Confusion counts (tp, tn, fp, fn) at a fixed threshold
    (reference evaluate_metrics.py:23-32)."""
    target_scores = np.asarray(target_scores)
    nontarget_scores = np.asarray(nontarget_scores)
    tp = int(np.sum(target_scores > threshold))
    tn = int(np.sum(nontarget_scores <= threshold))
    fn = int(np.sum(target_scores <= threshold))
    fp = int(np.sum(nontarget_scores > threshold))
    return tp, tn, fp, fn
