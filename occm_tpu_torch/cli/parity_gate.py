"""One-command real-asset parity gate (port of `occm_tpu.cli.parity_gate`;
BASELINE.md north star: EER within 0.1 % absolute of the PyTorch reference
on ASVspoof2019-LA).

    python -m occm_tpu_torch.cli.parity_gate --xlsr /path/xlsr2_300m.pt \\
        --la /path/LA [--ref_eer 0.0032] [--epochs 100] [--fast_numerics]

The flags are the JAX gate's, plus --device (the trainer's and scorers'
torch device; "cuda" by default). Stages, each printing a
``GATE <stage> PASS/FAIL`` line, then one JSON summary line (exit code 1
if any stage fails):

  convert — fairseq / HF checkpoint (torch pickle or .safetensors, format
            auto-detected) through `models.convert_xlsr` into the JAX
            package's parameter tree, saved as the orbax directory
            <workdir>/xlsr_params (as the JAX gate saves it), which the
            trainer's --pretrained_xlsr reads; the port's XLSREncoder
            grafts it strictly
  verify  — the port's fp32 encoder on --device (TF32 off) against the
            independent torch-functional oracle `models.torch_oracle` on
            the CPU, on random audio (max|diff| <= --verify_tol)
  train   — `oc_training` on the LA train partition from the converted
            frontend (reference: oc_training.py:320-401)
  eer     — `oc_classifier` mode 1c2 on the dev partition, then the EER
            over the dev labels; with --ref_eer given,
            |EER - ref| <= --gate (0.001 = the 0.1 %-absolute gate)
  int8    — rescore with --quant_int8 (and --fast_numerics when the gate
            has it); |EER_int8 - EER| <= --int8_gate (the W8A8 path's
            accuracy check on trained weights; skipped with --skip_int8).
            XLS-R's int8 path needs --fast_numerics (`XLSRConfig`
            refuses it under exact numerics, as the JAX package cannot
            run it), so on a full-width checkpoint without it this stage
            fails and says why.

The LA directory is expected in the standard ASVspoof2019 layout
(ASVspoof2019_LA_{train,dev}/flac + ASVspoof2019_LA_cm_protocols/); every
path can be overridden individually. tests/test_torch_parity_gate.py runs
the command end to end on a synthetic stand-in (a tiny fairseq-format .pt
and a fixture tree).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Convert + verify + train + score + EER-gate an XLSR "
        "checkpoint against ASVspoof2019-LA in one command (PyTorch/CUDA)")
    p.add_argument("--xlsr", required=True,
                   help="fairseq xlsr2_300m.pt or HF wav2vec2-xls-r-300m "
                        "checkpoint (.pt/.bin/.safetensors, auto-detected)")
    p.add_argument("--la", default=None,
                   help="ASVspoof2019 LA root (standard layout); every "
                        "derived path has an individual override")
    p.add_argument("--train_dir", default=None)
    p.add_argument("--dev_dir", default=None)
    p.add_argument("--train_protocol", default=None)
    p.add_argument("--dev_protocol", default=None)
    p.add_argument("--vocoded_dir", default=None,
                   help="vocoded spoof wav dir for the PF meta-batch "
                        "sampler (reference: oc_training.py:174)")
    p.add_argument("--workdir", default="parity_gate_out")
    p.add_argument("--epochs", type=int, default=100,
                   help="reference shipped config trains 100 "
                        "(oc_training.py:342)")
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--cut", type=int, default=64600)
    p.add_argument("--groups_per_step", type=int, default=1)
    p.add_argument("--compactness_weight", type=float, default=0.0)
    p.add_argument("--descriptiveness_weight", type=float, default=1.0)
    p.add_argument("--ref_eer", type=float, default=None,
                   help="the reference run's EER on the same dev set; "
                        "enables the |EER - ref| gate")
    p.add_argument("--gate", type=float, default=0.001,
                   help="max |EER - ref_eer|, absolute (0.001 = 0.1%%)")
    p.add_argument("--int8_gate", type=float, default=0.002,
                   help="max |EER_int8 - EER| for the W8A8 serving path")
    p.add_argument("--skip_int8", action="store_true")
    p.add_argument("--skip_train", action="store_true",
                   help="reuse <workdir>'s existing trained checkpoint")
    p.add_argument("--verify_seconds", type=float, default=1.0)
    p.add_argument("--verify_tol", type=float, default=1e-3)
    p.add_argument("--xlsr_tiny", action="store_true",
                   help="tiny XLSR config (CI / synthetic stand-ins)")
    p.add_argument("--fast_numerics", action="store_true",
                   help="bench-validated bf16 training/scoring knobs")
    p.add_argument("--steps_per_dispatch", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--bucket_step", type=int, default=16000)
    p.add_argument("--device", type=str, default="cuda",
                   help='torch device: "cuda" (default) or "cpu"')
    return p


def _derive_paths(args) -> dict:
    la = args.la
    std = {
        "train_dir": ("ASVspoof2019_LA_train", "flac"),
        "dev_dir": ("ASVspoof2019_LA_dev", "flac"),
        "train_protocol": ("ASVspoof2019_LA_cm_protocols",
                           "ASVspoof2019.LA.cm.train.trn.txt"),
        "dev_protocol": ("ASVspoof2019_LA_cm_protocols",
                         "ASVspoof2019.LA.cm.dev.trl.txt"),
    }
    out = {}
    for key, parts in std.items():
        given = getattr(args, key)
        if given is not None:
            out[key] = given
        elif la is not None:
            out[key] = os.path.join(la, *parts)
        else:
            raise SystemExit(f"ERROR: pass --la or --{key}")
    for key, path in out.items():
        if not os.path.exists(path):
            raise SystemExit(
                f"ERROR: {key} {path!r} does not exist (standard "
                "ASVspoof2019-LA layout assumed; override --" + key + ")"
            )
    return out


def _parse_cm_labels(protocol_path: str):
    """(utts, labels) from a cm protocol: utt = 2nd token, label = last
    (handles both the 5-column 2019 and 6-column 2021 formats;
    reference: evaluate.py:50-68 label map)."""
    utts, labels = [], []
    with open(protocol_path) as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) < 2:
                continue
            utts.append(parts[1])
            labels.append(parts[-1])
    return utts, labels


class _NoTF32:
    """TF32 off for CUDA matmuls and cuDNN convolutions inside the block
    (cuDNN runs fp32 convolutions in TF32 by default), restored after."""

    def __enter__(self):
        import torch

        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        import torch

        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    paths = _derive_paths(args)
    os.makedirs(args.workdir, exist_ok=True)
    results, failed = {}, []

    def stage(name: str, ok: bool, detail: str):
        results[name] = {"ok": bool(ok), "detail": detail}
        print(f"GATE {name} {'PASS' if ok else 'FAIL'}: {detail}",
              flush=True)
        if not ok:
            failed.append(name)

    import dataclasses

    import numpy as np
    import torch

    from occm_tpu_torch.config import XLSRConfig
    from occm_tpu_torch.models import XLSREncoder
    from occm_tpu_torch.models.convert_xlsr import (
        convert_fairseq_state_dict, detect_format, encoder_state_dict,
        graft_pretrained_xlsr, hf_to_fairseq_names, read_checkpoint)
    from occm_tpu_torch.train.orbax import save_tree
    from occm_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = XLSRConfig.tiny() if args.xlsr_tiny else XLSRConfig()
    fp32_cfg = dataclasses.replace(cfg, dtype="float32", remat=False)

    # ---- convert -----------------------------------------------------
    xlsr_params = os.path.abspath(os.path.join(args.workdir, "xlsr_params"))
    try:
        raw = read_checkpoint(args.xlsr)
        fmt = detect_format(raw)
        if fmt == "hf":
            raw = hf_to_fairseq_names(raw, fp32_cfg)
        save_tree(convert_fairseq_state_dict(raw, fp32_cfg), xlsr_params)
        sd = encoder_state_dict(raw, fp32_cfg)
        del raw
        encoder = XLSREncoder(fp32_cfg)
        graft_pretrained_xlsr(encoder, xlsr_params)
        n = sum(p.numel() for p in encoder.parameters())
        stage("convert", True,
              f"{fmt} checkpoint -> {xlsr_params} ({n:,} params)")
    except Exception as e:  # noqa: BLE001 — every failure is a gate FAIL
        stage("convert", False, f"{type(e).__name__}: {e}")
        print(json.dumps({"stages": results, "ok": False}))
        return 1

    # ---- verify vs the independent torch oracle ----------------------
    try:
        from occm_tpu_torch.models.torch_oracle import torch_wav2vec2_oracle

        rng = np.random.default_rng(0)
        wave = (rng.normal(size=(1, int(16000 * args.verify_seconds)))
                * 0.1).astype(np.float32)
        oracle = torch_wav2vec2_oracle(sd, wave, fp32_cfg)
        with _NoTF32(), torch.no_grad():
            ours = encoder.to(device).eval()(
                torch.from_numpy(wave).to(device)).cpu().numpy()
        diff = float(np.max(np.abs(ours - oracle)))
        stage("verify", diff <= args.verify_tol,
              f"max|encoder diff| = {diff:.3e} (tol {args.verify_tol:g})")
    except Exception as e:  # noqa: BLE001
        stage("verify", False, f"{type(e).__name__}: {e}")
    del sd, encoder
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- train --------------------------------------------------------
    ckpt = os.path.join(args.workdir, f"aasist_vocoded_{args.epochs - 1}.pt")
    if not (args.skip_train and os.path.isfile(ckpt)):
        from occm_tpu_torch.cli import oc_training

        train_argv = [
            "--train_protocol_file", paths["train_protocol"],
            "--train_dataset_dir", paths["train_dir"],
            "--model", "aasist",
            "--num_epochs", str(args.epochs),
            "--lr", str(args.lr),
            "--cut", str(args.cut),
            "--groups_per_step", str(args.groups_per_step),
            "--compactness_weight", str(args.compactness_weight),
            "--descriptiveness_weight", str(args.descriptiveness_weight),
            "--checkpoint_dir", args.workdir,
            "--pretrained_xlsr", xlsr_params,
            "--steps_per_dispatch", str(args.steps_per_dispatch),
            "--device", args.device,
        ]
        if args.vocoded_dir:
            train_argv += ["--vocoded_dir", args.vocoded_dir]
        if args.xlsr_tiny:
            train_argv.append("--xlsr_tiny")
        if args.fast_numerics:
            train_argv.append("--fast_numerics")
        try:
            oc_training.main(train_argv)
            ok = os.path.isfile(ckpt)
            stage("train", ok, f"checkpoint {ckpt}"
                  if ok else f"no checkpoint at {ckpt}")
        except Exception as e:  # noqa: BLE001
            stage("train", False, f"{type(e).__name__}: {e}")
    else:
        stage("train", True, f"reused existing {ckpt} (--skip_train)")
    if not os.path.isfile(ckpt):
        print(json.dumps({"stages": results, "ok": False}))
        return 1

    # ---- score + eer (fp32/fast, then int8) ---------------------------
    # the dev cm protocol carries labels; oc_classifier's eval parser
    # takes token 0 per line, so write the bare utt list alongside
    utts, labels = _parse_cm_labels(paths["dev_protocol"])
    dev_utts = os.path.join(args.workdir, "dev_utts.txt")
    with open(dev_utts, "w") as f:
        f.write("\n".join(utts) + "\n")

    from occm_tpu_torch.cli import oc_classifier
    from occm_tpu_torch.evaluate import calculate_eer_from_labels
    from occm_tpu_torch.io.scorefiles import read_comma_scores

    def score_and_eer(tag: str, extra_flags):
        score_file = os.path.join(args.workdir, f"scores_{tag}.txt")
        argv = [
            "--pretrained-sslaasist", ckpt,
            "--protocol_file", paths["train_protocol"],
            "--dataset_dir", paths["train_dir"],
            "--eval_protocol_file", dev_utts,
            "--eval_dataset_dir", paths["dev_dir"],
            "--mode", "1c2",
            "--score_file", score_file,
            "--batch_size", str(args.batch_size),
            "--bucket_step", str(args.bucket_step),
            "--device", args.device,
        ] + list(extra_flags)
        if args.xlsr_tiny:
            argv.append("--xlsr_tiny")
        oc_classifier.main(argv)
        scores = read_comma_scores(score_file)
        eer, _ = calculate_eer_from_labels(scores, labels)
        return float(eer)

    flags = ["--fast_numerics"] if args.fast_numerics else []
    # measured values sit at the summary's top level, beside "stages"
    # (stage entries are {ok, detail} records)
    values = {}
    try:
        eer = score_and_eer("fp32", flags)
        if args.ref_eer is not None:
            delta = abs(eer - args.ref_eer)
            stage("eer", delta <= args.gate,
                  f"EER {eer:.4f} vs reference {args.ref_eer:.4f} "
                  f"(|delta| {delta:.4f} <= {args.gate:g}?)")
        else:
            stage("eer", True, f"EER {eer:.4f} (no --ref_eer given: "
                               "recorded, not gated)")
        values["eer_value"] = eer
    except Exception as e:  # noqa: BLE001
        stage("eer", False, f"{type(e).__name__}: {e}")
        eer = None

    if not args.skip_int8 and eer is not None:
        try:
            eer_i8 = score_and_eer("int8", flags + ["--quant_int8"])
            delta = abs(eer_i8 - eer)
            stage("int8", delta <= args.int8_gate,
                  f"int8 EER {eer_i8:.4f} vs fp EER {eer:.4f} "
                  f"(|delta| {delta:.4f} <= {args.int8_gate:g}?)")
            values["eer_int8_value"] = eer_i8
        except Exception as e:  # noqa: BLE001
            stage("int8", False, f"{type(e).__name__}: {e}")

    ok = not failed
    print(json.dumps({"stages": results, "ok": ok, **values}))
    return 0 if ok else 1


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
