"""Model zoo: the dense, vlm and moe families as one composable LM stack.

Counterpart of `repro.models` for serving: `init_params(cfg, generator)`
-> an `LM` module whose parameter names follow the reference's tree, and
`forward`. MoE blocks dispatch their experts through the paper's secure
shuffle (`models.moe`). The ssm, hybrid and audio families, `param_axes`
and `loss_fn` are ROADMAP item 10.
"""

from repro_torch.models.lm import LM, forward, init_params, main_kind

__all__ = ["LM", "forward", "init_params", "main_kind"]
