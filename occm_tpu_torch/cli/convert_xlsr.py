"""`occm-convert-xlsr` of the port: a fairseq or HuggingFace wav2vec2 /
XLS-R checkpoint (.pt, .bin, .safetensors) -> an orbax directory of the
JAX package's XLSREncoder parameters (`models.convert_xlsr`).

    python -m occm_tpu_torch.cli.convert_xlsr xlsr2_300m.pt out_dir \
        [--format auto|fairseq|hf] [--tiny]
"""

from occm_tpu_torch.models.convert_xlsr import main

if __name__ == "__main__":
    main()
