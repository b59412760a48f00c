"""Score-file evaluation (the port's own copy of
`occm_tpu.evaluate.eval_scores`) — both reference conventions preserved.

- evaluate_scores / calculate_eer_from_labels (reference: evaluate.py):
  comma-format score file + bare protocol + trial metadata; EER computed as
  compute_eer(spoof_scores, bonafide_scores) (reference: evaluate.py:145 —
  spoof is the "target" class because 1c scores are distances, larger =
  more spoof-like).
- calculate_eer_merged (reference: calculate_eer.py): space-format
  `utt score` file merged against a 5-column protocol; EER computed as
  compute_eer(bonafide_scores, spoof_scores) (reference: calculate_eer.py:25
  — opposite convention, scores are bonafide-likeness).

The confusion matrix is computed with numpy (`confusion_matrix`): the same
array as `sklearn.metrics.confusion_matrix(labels, predictions)`, rows the
true labels and columns the predictions, both in sorted label order.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from occm_tpu_torch.io.protocols import (
    metadata_labels_for_protocol,
    parse_eval_protocol,
    parse_train_protocol,
)
from occm_tpu_torch.io.scorefiles import read_comma_scores, read_utt_scores
from occm_tpu_torch.metrics import compute_eer


def _split_by_label(scores: Sequence[float], labels: Sequence[str]
                    ) -> Tuple[np.ndarray, np.ndarray]:
    spoof, bona = [], []
    for s, lab in zip(scores, labels):
        if lab == "spoof":
            spoof.append(s)
        else:
            bona.append(s)
    return np.asarray(spoof), np.asarray(bona)


def confusion_matrix(y_true: Sequence[str], y_pred: Sequence[str]
                     ) -> np.ndarray:
    """Counts [i, j] of samples with true label i predicted as j, over the
    sorted union of both label lists (sklearn.metrics.confusion_matrix with
    its default `labels=None`), int64. Lists of different lengths raise, as
    in sklearn (a score file and a protocol that do not match)."""
    if len(y_true) != len(y_pred):
        raise ValueError(f"{len(y_true)} labels but {len(y_pred)} "
                         "predictions")
    labels = sorted(set(y_true) | set(y_pred))
    index = {lab: i for i, lab in enumerate(labels)}
    cm = np.zeros((len(labels), len(labels)), np.int64)
    for t, p in zip(y_true, y_pred):
        cm[index[t], index[p]] += 1
    return cm


def calculate_eer_from_labels(scores: Sequence[float],
                              labels: Sequence[str]) -> Tuple[float, float]:
    """reference: evaluate.py:127-146 (spoof as target)."""
    spoof, bona = _split_by_label(scores, labels)
    return compute_eer(spoof, bona)


def evaluate_scores(score_file: str, protocol_file: str, metadata_file: str,
                    threshold: float = 0.1) -> Dict:
    """Full evaluate.py pipeline (reference: evaluate.py:148-198):
    confusion matrix at a fixed threshold + EER. Returns a result dict;
    printing is the CLI's job."""
    proto = parse_eval_protocol(protocol_file)
    scores = read_comma_scores(score_file)
    labels = metadata_labels_for_protocol(metadata_file, protocol_file)

    predictions = [
        "spoof" if s > threshold else "bonafide" for s in scores
    ]
    bona_count = labels.count("bonafide")
    spoof_count = labels.count("spoof")

    cm = confusion_matrix(labels, predictions)
    eer, eer_threshold = calculate_eer_from_labels(scores, labels)
    return {
        "num_files": len(proto),
        "bona_fide": bona_count,
        "spoof": spoof_count,
        "confusion_matrix": cm,
        "eer": eer,
        "eer_threshold": eer_threshold,
    }


def _merged_bona_spoof(eval_protocol_file: str, score_file: str
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Join `utt score` rows to the 5-column protocol on utt and split by
    label (the calculate_eer.py:15-23 pandas-merge semantics: unmatched
    utterances drop out)."""
    files, labels = parse_train_protocol(eval_protocol_file)
    label_of = dict(zip(files, labels))
    utts, scores = read_utt_scores(score_file)

    spoof, bona = [], []
    for utt, score in zip(utts, scores):
        lab = label_of.get(utt)
        if lab == "spoof":
            spoof.append(score)
        elif lab == "bonafide":
            bona.append(score)
    return np.asarray(bona), np.asarray(spoof)


def calculate_eer_merged(eval_protocol_file: str, score_file: str
                         ) -> Tuple[float, float]:
    """calculate_eer.py pipeline (reference: calculate_eer.py:6-26):
    join `utt score` rows to the 5-column protocol on utt, then
    compute_eer(bonafide, spoof)."""
    bona, spoof = _merged_bona_spoof(eval_protocol_file, score_file)
    return compute_eer(bona, spoof)


def calculate_tdcf_merged(eval_protocol_file: str, score_file: str,
                          asv_score_file: str, version: str = "v2"
                          ) -> Tuple[float, float]:
    """Normalized minimum t-DCF over the same merged scores as
    calculate_eer_merged. Beyond-reference: the reference stops at EER, but
    ASVspoof ranks by min t-DCF (occm_tpu_torch/metrics/tdcf.py). The ASV
    operating point comes from an official-format `... key score` ASV score
    file. Returns (min_tdcf_norm, cm_threshold)."""
    from occm_tpu_torch.metrics import compute_min_tdcf, read_asv_scores

    bona, spoof = _merged_bona_spoof(eval_protocol_file, score_file)
    asv = read_asv_scores(asv_score_file)
    return compute_min_tdcf(bona, spoof, asv, version=version)
