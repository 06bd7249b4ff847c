"""What the language-model cells share: the port's model built from the
configuration's file, its weights drawn on the card from the seed, the
encrypted expert exchange, prompts, and the reference's forward pass over
the same weights and tokens.

The configuration's file names its reference module under
`reference_module` (`bench/reference/<name>.py`; `granite_moe` where the
key is absent). The module gives, from the model's sizes alone:
  weight_specs(m, shards)   name -> (shape, kind, fan_in): the weights the
                            benchmark draws
  forward(W, m, tokens, *, logit_positions, shards, prompt_len, quant,
          cache_sink, stats)
                            the plain forward pass; `cache_sink(layer,
                            tensors)` sees each layer's cache entries under
                            the names of the port's cache
  prefill_flops, prefill_attention_flops, decode_step_flops,
  exchange_legs, leg_wire_bytes
                            the counts the cell's metrics are held to

Weights are made by the benchmark, by parameter name, a few large draws:
each stacked parameter of all layers (or of a range of layers) at once, in
the served dtype. Matrices are N(0, 1 / fan_in), fan_in the dimension a
product contracts; the embedding (tied to the output) N(0, 0.02^2); norm
scales 1 + N(0, 0.1^2). The port's model takes views of these stacks
(`load_state_dict(assign=True)`); the reference gets the same stacks, made
again from the seed once the program's are freed.

A spec name says which layers it covers by the segment after `layers.`, so
that models whose layers differ (a dense first layer before MoE layers)
still draw stacks:

  spec name               covers                  port names
  layers.<name>           every layer, a stack    layers.<i>.<name> = w[i],
                          of n_layers             i in 0..n_layers-1
  layers.<i>.<name>       layer i alone           the same name
  layers.<a>:<b>.<name>   layers a <= i < b, a    layers.<i>.<name> = w[i - a]
                          stack of b - a
  any other name          no layer                the same name

Every port name is written once (`port_state_dict`).
"""

from __future__ import annotations

import importlib

import torch

from bench import common, wire


def reference_module(config: dict):
    """The configuration's reference module (`reference_module`, by default
    `granite_moe`), from `bench/reference/`."""
    return importlib.import_module(
        f"bench.reference.{config.get('reference_module', 'granite_moe')}")


def make_weights(ref, m: dict, seed: int, device, shards: int) -> dict:
    """The weights of `ref.weight_specs`, drawn from the seed."""
    dt = torch.bfloat16 if m["dtype"] == "bfloat16" else torch.float32
    g = torch.Generator(device=device).manual_seed(common.derive_seed(seed, "weights"))
    out = {}
    for name, (shape, kind, fan_in) in ref.weight_specs(m, shards).items():
        if kind == "scale":
            w = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
            out[name] = w.mul_(0.1).add_(1.0)
            continue
        w = torch.randn(shape, generator=g, device=device, dtype=dt)
        out[name] = w.mul_(0.02 if kind == "embed" else fan_in ** -0.5)
    return out


def port_state_dict(weights: dict, m: dict) -> dict:
    """The port's state dict from the benchmark's weights:
      layers.<name>          -> layers.<i>.<name> = w[i], i in 0..n_layers-1
      layers.<i>.<name>      -> itself (layer i's own tensor)
      layers.<a>:<b>.<name>  -> layers.<i>.<name> = w[i - a], a <= i < b
      any other name         -> itself
    The views share the stacks' storage. Raises `ValueError`, naming the
    spec, where a stack's leading size is not the number of layers it
    covers, a layer or range lies outside 0..n_layers or is empty, or two
    specs write one port name."""
    sd, origin = {}, {}
    for name, w in weights.items():
        for key, view in _views(name, w, m["n_layers"]):
            if key in sd:
                raise ValueError(f"weight spec {name!r} writes {key!r}, as {origin[key]!r} does")
            sd[key], origin[key] = view, name
    return sd


def _views(name: str, w: torch.Tensor, n: int) -> list:
    """(port name, tensor) pairs of one spec of a model of n layers."""
    if not name.startswith("layers."):
        return [(name, w)]
    head, _, rest = name[len("layers."):].partition(".")
    if head.isdecimal() or ":" in head:
        a, colon, b = head.partition(":")
        if not rest or not a.isdecimal() or colon and not b.isdecimal():
            raise ValueError(f"weight spec {name!r}: want layers.<i>.<name> or "
                             f"layers.<a>:<b>.<name>")
        if not colon:  # layer a's own tensor
            if int(a) >= n:
                raise ValueError(f"weight spec {name!r}: no layer {a} of {n}")
            return [(name, w)]
        a, b = int(a), int(b)
    else:  # a stack over every layer
        a, b, rest = 0, n, name[len("layers."):]
    if not 0 <= a < b <= n:
        raise ValueError(f"weight spec {name!r}: layers {a}:{b} empty or outside 0..{n}")
    if w.dim() == 0 or w.shape[0] != b - a:
        raise ValueError(f"weight spec {name!r}: a stack of {b - a} layers, "
                         f"leading size {tuple(w.shape)[:1]}")
    return [(f"layers.{i}.{rest}", w[i - a]) for i in range(a, b)]


def arch_config(m: dict):
    from repro_torch.configs.base import ArchConfig

    return ArchConfig(**m)


def prompts(m: dict, seed: int, tag: str, batch: int, length: int, device) -> torch.Tensor:
    """(batch, length) int32 token ids, uniform over the vocabulary."""
    g = torch.Generator(device=device).manual_seed(common.derive_seed(seed, f"prompts:{tag}"))
    return torch.randint(0, m["vocab_size"], (batch, length), generator=g, device=device,
                         dtype=torch.int32)


class LMBase:
    """Builds the port's model on the mesh, with the benchmark's weights."""

    def __init__(self, cs, *, seed: int, device: str, rec):
        self.cs, self.seed, self.device, self.rec = cs, int(seed), torch.device(device), rec
        self.m = cs["config"]["model"]
        self.ref = reference_module(cs["config"])
        self.dep = cs["config"]["deployment"]
        self.traffic = cs["traffic"]
        self.shards = self.dep["shards"]
        self.attempted = self.failed = 0

    def build(self, mesh):
        from repro_torch.models.lm import LM

        self.cfg = arch_config(self.m)
        self.mesh = mesh
        self.secure = wire.session(self.seed, "exchange") if self.dep["secure_moe"] else None
        weights = self.weights()
        model = LM(self.cfg, n_model=self.shards, device="meta")
        model.load_state_dict(port_state_dict(weights, self.m), strict=True, assign=True)
        self.model = model

    def free_model(self):
        self.model = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def weights(self) -> dict:
        return make_weights(self.ref, self.m, self.seed, self.device, self.shards)

    def reference(self, tokens, positions, *, quant=None, cache_sink=None, weights=None,
                  stats=None):
        """The reference's logits (B, len(positions), vocab) over `tokens`."""
        weights = weights or self.weights()
        return self.ref.forward(weights, self.m, tokens, logit_positions=positions,
                                shards=self.shards, prompt_len=self.traffic["prompt_tokens"],
                                quant=quant, cache_sink=cache_sink, stats=stats)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want| / |want|, Frobenius norms, in float64."""
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
