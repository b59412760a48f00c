"""Score-file readers/writers (the port's own copy of
`occm_tpu.io.scorefiles`) — two formats, preserved bit-for-bit.

Format A ("comma"): one-class scoring writes `"{score}, {pred} \n"` including
the trailing space (reference: oc_classifier.py:239-241,263-265); two-class
scoring writes a single float per line (reference: oc_classifier.py:291,312).
The reader takes everything before the first comma (reference:
evaluate.py:85-101), so both sub-variants parse with the same function.

Format B ("space"): `"utt score"` two space-separated columns, consumed by
pandas in the reference (reference: calculate_eer.py:18-19).
"""

from __future__ import annotations

from typing import List, Tuple


def write_score_line_1c(f, distance: float, threshold: float) -> None:
    """One-class score line: distance plus thresholded prediction.

    Byte-compatible with reference oc_classifier.py:238-241 (note the space
    before the newline).
    """
    if float(distance) > threshold:
        f.write(f"{float(distance)}, 1 \n")
    else:
        f.write(f"{float(distance)}, 0 \n")


def write_score_line_2c(f, value: float) -> None:
    """Two-class score line: bare bonafide logit
    (reference: oc_classifier.py:291,312)."""
    f.write(f"{float(value)}\n")


def read_comma_scores(path: str) -> List[float]:
    """Read format-A scores: float before the first comma on each line
    (reference: evaluate.py:85-101). Lines without a comma parse as a bare
    float, so 2c files read with the same function."""
    scores: List[float] = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            scores.append(float(line.split(",")[0]))
    return scores


def write_utt_score_line(f, utt: str, score: float) -> None:
    """Format-B line: `utt score` (reference: calculate_eer.py:18-19 reads
    this shape)."""
    f.write(f"{utt} {float(score)}\n")


def read_utt_scores(path: str) -> Tuple[List[str], List[float]]:
    """Read format-B `utt score` files."""
    utts: List[str] = []
    scores: List[float] = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            u, s = line.split()
            utts.append(u)
            scores.append(float(s))
    return utts, scores
