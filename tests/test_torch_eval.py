"""The port's evaluation (`occm_tpu_torch.metrics`, `.evaluate`,
`.cli.evaluate`, `.cli.calculate_eer`) against the JAX package's on the
same seeded score files, tied scores included.

Both run the same numpy arithmetic on the same parsed floats, so results
must be equal with no tolerance; the printed text of the two CLIs must be
the same. The port's numpy confusion matrix is held against sklearn's.
"""

import numpy as np
import pytest
from sklearn.metrics import confusion_matrix as sk_confusion_matrix

from occm_tpu import metrics as jmetrics
from occm_tpu.cli import calculate_eer as jcalculate_eer
from occm_tpu.cli import evaluate as jevaluate_cli
from occm_tpu.evaluate import calculate_eer_merged as j_calculate_eer_merged
from occm_tpu.evaluate import evaluate_scores as j_evaluate_scores
from occm_tpu_torch import metrics
from occm_tpu_torch.cli import calculate_eer, evaluate
from occm_tpu_torch.evaluate import calculate_eer_merged, evaluate_scores
from occm_tpu_torch.evaluate.eval_scores import confusion_matrix
from occm_tpu_torch.io import scorefiles


def _scores(rng, n, ties):
    """n scores rounded to 2 decimals, with `ties` of them copied from
    others, so the DET curve meets tied target and non-target scores."""
    s = np.round(rng.normal(size=n), 2)
    idx = rng.choice(n, size=(ties, 2), replace=False)
    s[idx[:, 0]] = s[idx[:, 1]]
    return s


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eer_and_min_tdcf_equal_jax(seed):
    rng = np.random.default_rng(seed)
    bona = _scores(rng, 40, 6) + 0.5
    spoof = _scores(rng, 60, 8)
    spoof[:5] = bona[:5]  # ties across the two classes
    for a, b in ((bona, spoof), (spoof, bona)):
        assert metrics.compute_eer(a, b) == jmetrics.compute_eer(a, b)
        for want, got in zip(jmetrics.compute_det_curve(a, b),
                             metrics.compute_det_curve(a, b)):
            np.testing.assert_array_equal(got, want)
    asv = jmetrics.AsvErrorRates(0.04, 0.06, 0.35)
    port_asv = metrics.AsvErrorRates(0.04, 0.06, 0.35)
    for version in ("v1", "v2"):
        assert metrics.compute_min_tdcf(bona, spoof, port_asv,
                                        version=version) == \
            jmetrics.compute_min_tdcf(bona, spoof, asv, version=version)


@pytest.fixture
def score_tree(tmp_path):
    """A bare eval list, trial metadata with labels (two eval rows missing,
    so they keep an empty label), a 5-column eval protocol, a comma-format
    1c score file and a space-format `utt score` file, with tied scores."""
    rng = np.random.default_rng(5)
    n = 30
    utts = [f"LA_E_{i:05d}" for i in range(n)]
    labels = ["spoof" if rng.random() < 0.6 else "bonafide" for _ in utts]
    dist = _scores(rng, n, 5) + 1.0
    (tmp_path / "protocol.txt").write_text("\n".join(utts) + "\n")
    meta = [f"LA_{i:04d} {u} mp3m4a asvspoof A09 {lab} notrim eval x - -"
            for i, (u, lab) in enumerate(zip(utts, labels)) if i not in (3, 7)]
    (tmp_path / "metadata.txt").write_text("\n".join(meta) + "\n")
    with open(tmp_path / "scores_1c.txt", "w") as f:
        for d in dist:
            scorefiles.write_score_line_1c(f, float(d), 1.0)
    proto5 = [f"LA_{i:04d} {u} - - {lab}"
              for i, (u, lab) in enumerate(zip(utts, labels))]
    (tmp_path / "eval5.txt").write_text("\n".join(proto5) + "\n")
    with open(tmp_path / "utt_scores.txt", "w") as f:
        for u, d in zip(utts[:-2], dist):  # two unmatched utterances drop
            scorefiles.write_utt_score_line(f, u, -float(d))
        scorefiles.write_utt_score_line(f, "LA_E_99999", 0.5)
    return tmp_path


def test_evaluate_scores_equals_jax(score_tree):
    args = [str(score_tree / n) for n in
            ("scores_1c.txt", "protocol.txt", "metadata.txt")]
    for threshold in (0.1, 1.0, 1.5):
        got = evaluate_scores(*args, threshold=threshold)
        want = j_evaluate_scores(*args, threshold=threshold)
        assert got.keys() == want.keys()
        for k in want:
            if k == "confusion_matrix":
                np.testing.assert_array_equal(got[k], want[k])
                assert got[k].dtype == want[k].dtype
            else:
                assert got[k] == want[k], k


def test_calculate_eer_merged_equals_jax(score_tree):
    args = (str(score_tree / "eval5.txt"), str(score_tree / "utt_scores.txt"))
    assert calculate_eer_merged(*args) == j_calculate_eer_merged(*args)


@pytest.mark.parametrize("seed", [0, 1])
def test_numpy_confusion_matrix_equals_sklearn(seed):
    rng = np.random.default_rng(seed)
    names = ["bonafide", "spoof", ""]
    y_true = list(rng.choice(names, size=50))
    y_pred = list(rng.choice(names[:2], size=50))
    for a, b in ((y_true, y_pred), (y_pred, y_pred), (y_true, y_true)):
        want = sk_confusion_matrix(a, b)
        got = confusion_matrix(a, b)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    with pytest.raises(ValueError):
        sk_confusion_matrix(y_true, y_pred[:-1])
    with pytest.raises(ValueError, match="50 labels but 49"):
        confusion_matrix(y_true, y_pred[:-1])


def test_clis_print_the_same_text(score_tree, capsys):
    argv = ["--score_file", str(score_tree / "scores_1c.txt"),
            "--protocol_file", str(score_tree / "protocol.txt"),
            "--metadata_file", str(score_tree / "metadata.txt"),
            "--threshold", "1.2"]
    jevaluate_cli.main(argv)
    want = capsys.readouterr().out
    evaluate.main(argv)
    assert capsys.readouterr().out == want
    assert "EER = " in want

    asv = score_tree / "asv.txt"
    rng = np.random.default_rng(6)
    asv.write_text("".join(
        f"LA_{i:04d} {key} {rng.normal(mu):.4f}\n"
        for i, (key, mu) in enumerate(
            [("target", 2.0)] * 20 + [("nontarget", -2.0)] * 20
            + [("spoof", 0.0)] * 20)))
    argv = ["--eval_protocol_file", str(score_tree / "eval5.txt"),
            "--score_file", str(score_tree / "utt_scores.txt"),
            "--asv_score_file", str(asv)]
    jcalculate_eer.main(argv)
    want = capsys.readouterr().out
    calculate_eer.main(argv)
    assert capsys.readouterr().out == want
    assert "min t-DCF (v2)" in want
