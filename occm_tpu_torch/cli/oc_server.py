"""One-class scoring HTTP server CLI (port of `occm_tpu.cli.oc_server`).

Serves the XLSR + AASIST one-class model over HTTP (POST /score with
WAV/FLAC/raw-PCM bytes -> {"score", "prediction", "label"}) on one GPU. The
flags are the JAX server's, plus --device; --pretrained-sslaasist takes a
torch state dict in the reference's naming (for example the file
`occm-export-model` writes) in place of an orbax directory. The reference
embedding and threshold come from reference_embedding.npy / threshold.npy.

Usage:
    python -m occm_tpu_torch.cli.oc_server \
        --pretrained-sslaasist aasist_vocoded_99.pt --artifacts_dir . \
        --port 8080
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="One-class scoring HTTP server (PyTorch/CUDA)"
    )
    parser.add_argument("--pretrained-sslaasist", type=str,
                        default="aasist_vocoded_1.pt",
                        help="torch state dict of the full AModel in the "
                             "reference's naming (occm-export-model)")
    parser.add_argument("--artifacts_dir", type=str, default=".",
                        help="dir holding reference_embedding.npy + "
                             "threshold.npy (from oc_classifier)")
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--buckets", type=int, nargs="+",
                        default=[16000, 48000, 64600, 96000],
                        help="utterance-length buckets (samples) to warm "
                             "up at startup")
    parser.add_argument("--max_wait_ms", type=float, default=5.0,
                        help="dynamic-batching wait bound")
    parser.add_argument("--data_parallel", type=int, default=0, metavar="N",
                        help="not ported yet: serving runs on one GPU")
    parser.add_argument("--xlsr_tiny", action="store_true")
    parser.add_argument(
        "--fast_numerics", action="store_true", default=False,
        help="bf16 norms + tanh GELU scoring (validate EER impact first)")
    parser.add_argument("--quant_int8", action="store_true", default=False,
                        help="not ported yet")
    parser.add_argument(
        "--attention_impl", type=str, default="auto",
        help='attention per bucket: "auto" (default) resolves per bucket '
             "length (occm_tpu_torch.classify.impl_select: xla short, the "
             "flash kernel long); or pin xla | flash for every bucket.")
    parser.add_argument("--allow_random_init", action="store_true",
                        help="serve seeded random weights (testing only)")
    parser.add_argument("--no_warmup", action="store_true",
                        help="skip the per-bucket warmup batch at startup")
    parser.add_argument("--device", type=str, default="cuda",
                        help='torch device: "cuda" (default) or "cpu"')
    parser.add_argument("--verbose", action="store_true")
    return parser


def xlsr_config(tiny: bool = False, fast_numerics: bool = False):
    """The encoder config the server runs."""
    import dataclasses

    from occm_tpu_torch.config import XLSRConfig

    cfg = XLSRConfig.tiny() if tiny else XLSRConfig()
    if fast_numerics:
        cfg = dataclasses.replace(
            cfg, norm_dtype="bfloat16", gelu_approximate=True,
            conv_gelu_approximate=True, bf16_param_mirror=True,
        )
    return cfg


def build_model(xlsr_cfg, checkpoint: str, allow_random_init: bool,
                device):
    """AModel on `device` in eval mode, from a reference-named state dict,
    or from seeded random weights (seed 0) when allowed and the checkpoint
    cannot be read."""
    import os

    from occm_tpu_torch.config import AASISTConfig
    from occm_tpu_torch.models import AModel, load_reference_state_dict
    from occm_tpu_torch.utils.init_template import random_init_

    if not allow_random_init and not os.path.isfile(checkpoint):
        raise SystemExit(
            f"ERROR: checkpoint {checkpoint!r} does not exist. Pass "
            "--allow_random_init to serve random weights (testing only)."
        )
    model = AModel(AASISTConfig(), xlsr_cfg=xlsr_cfg)
    try:
        model.load_state_dict(load_reference_state_dict(checkpoint),
                              strict=True)
        print("Pretrained weights loaded")
    except (OSError, RuntimeError, KeyError) as e:
        if not allow_random_init:
            raise SystemExit(
                f"ERROR: could not load pretrained weights from "
                f"{checkpoint!r}: {e}"
            )
        print(f"WARNING: serving random init ({e}; --allow_random_init)")
        random_init_(model, seed=0)
    return model.to(device).eval()


def main(argv=None, started_event=None):
    """started_event: optional threading.Event set once serving (tests)."""
    args = build_parser().parse_args(argv)

    import os

    import numpy as np

    from occm_tpu_torch.classify import make_embed_fn_factory
    from occm_tpu_torch.serve import BatchingQueue, ScoringService
    from occm_tpu_torch.serve_http import ScoringHTTPServer
    from occm_tpu_torch.utils.device import resolve_device

    if args.quant_int8 or args.data_parallel:
        raise NotImplementedError(
            "--quant_int8 and --data_parallel are not yet ported to "
            "occm_tpu_torch")
    device = resolve_device(args.device)

    ref_path = os.path.join(args.artifacts_dir, "reference_embedding.npy")
    thr_path = os.path.join(args.artifacts_dir, "threshold.npy")
    for p in (ref_path, thr_path):
        if not os.path.exists(p):
            raise SystemExit(
                f"ERROR: missing artifact {p!r} — run oc_classifier "
                "against the train protocol first to build the reference "
                "embedding + threshold."
            )
    reference = np.load(ref_path)
    threshold = float(np.load(thr_path))

    cfg = xlsr_config(args.xlsr_tiny, args.fast_numerics)
    model = build_model(cfg, args.pretrained_sslaasist,
                        args.allow_random_init, device)

    # per-bucket attention impl (classify.impl_select): one set of weights,
    # each bucket's score fn runs the impl that its length selects
    service = ScoringService(
        score_fn_factory=make_embed_fn_factory(model, args.attention_impl,
                                               cfg.norm_dtype),
        reference_embedding=reference, threshold=threshold,
        buckets=tuple(args.buckets), batch=args.batch_size, device=device,
    )
    if not args.no_warmup:
        print(f"warming up {len(args.buckets)} buckets...")
        service.warmup()

    with BatchingQueue(service, max_wait_ms=args.max_wait_ms) as batcher:
        server = ScoringHTTPServer(
            batcher, host=args.host, port=args.port, verbose=args.verbose
        )
        server.start()
        print(f"Serving on {args.host}:{server.port} "
              f"(threshold={threshold:.4f}, batch={args.batch_size}, "
              f"device={device})")
        try:
            if started_event is not None:
                started_event.server = server  # expose for tests
                started_event.service = service
                started_event.set()
                started_event.stop.wait()  # tests drive shutdown
            else:  # pragma: no cover - interactive serving
                import signal

                signal.sigwait({signal.SIGINT, signal.SIGTERM})
        finally:
            server.shutdown()


if __name__ == "__main__":
    main()
