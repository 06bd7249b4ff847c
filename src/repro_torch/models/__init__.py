"""Model zoo: every assigned architecture family as one composable LM stack.

Counterpart of `repro.models`: `init_params(cfg, generator)` -> an `LM`
module whose parameter names follow the reference's tree, `forward` and
`loss_fn`, for the dense, vlm, moe, ssm (RWKV-6, `models.rwkv`), hybrid
(Mamba-2 SSD with a shared attention block, `models.ssm`) and audio
(encoder-decoder) families. MoE blocks dispatch their experts through the
paper's secure shuffle (`models.moe`), differentiably. `param_axes` has no
counterpart on one card.
"""

from repro_torch.models.lm import (
    LM,
    encode_audio,
    forward,
    init_params,
    layer_kind,
    loss_fn,
    main_kind,
    output_head,
)

__all__ = ["LM", "encode_audio", "forward", "init_params", "layer_kind", "loss_fn", "main_kind",
           "output_head"]
