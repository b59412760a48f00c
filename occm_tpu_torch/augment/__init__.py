from occm_tpu_torch.augment.rawboost import (
    batch_rawboost,
    draw_rawboost,
    fir_filter_centered,
    firwin_bandstop,
    gen_notch_coeffs,
    isd_additive_noise,
    lnl_convolutive_noise,
    norm_wav,
    notch_from_draws,
    process_rawboost,
    ssi_additive_noise,
)

__all__ = [
    "norm_wav",
    "firwin_bandstop",
    "notch_from_draws",
    "gen_notch_coeffs",
    "fir_filter_centered",
    "lnl_convolutive_noise",
    "isd_additive_noise",
    "ssi_additive_noise",
    "process_rawboost",
    "batch_rawboost",
    "draw_rawboost",
]
