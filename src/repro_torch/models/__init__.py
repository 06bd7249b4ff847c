"""Model zoo: the dense, vlm and moe families as one composable LM stack.

Counterpart of `repro.models`: `init_params(cfg, generator)` -> an `LM`
module whose parameter names follow the reference's tree, `forward` and
`loss_fn`. MoE blocks dispatch their experts through the paper's secure
shuffle (`models.moe`), differentiably. The ssm, hybrid and audio families
are ROADMAP item 10; `param_axes` has no counterpart on one card.
"""

from repro_torch.models.lm import LM, forward, init_params, loss_fn, main_kind

__all__ = ["LM", "forward", "init_params", "loss_fn", "main_kind"]
