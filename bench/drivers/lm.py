"""What the language-model cells share: the port's model built from the
configuration's file, its weights drawn on the card from the seed, the
encrypted expert exchange, prompts, and the reference's forward pass over
the same weights and tokens.

Weights are made by the benchmark, by parameter name, a few large draws:
each per-layer parameter of all layers at once (`layers.<name>`, stacked on
a leading layer axis), in the served dtype. Matrices are N(0, 1 / fan_in),
fan_in the dimension a product contracts; the embedding (tied to the
output) N(0, 0.02^2); norm scales 1 + N(0, 0.1^2). The port's model takes
views of these stacks (`load_state_dict(assign=True)`); the reference gets
the same stacks, made again from the seed once the program's are freed.
"""

from __future__ import annotations

import torch

from bench import common, wire, yardstick
from bench.reference import granite_moe as ref_lm


def weight_specs(m: dict, shards: int) -> dict:
    """name -> (shape, kind, fan_in): kind "matrix", "embed" or "scale"."""
    d, dh, l = m["d_model"], yardstick.head_dim(m), m["n_layers"]
    h, hkv, f = m["n_heads"], m["n_kv_heads"], m.get("moe_d_ff") or m["d_ff"]
    e = -(-m["n_experts"] // shards) * shards
    return {
        "embed.table": ((yardstick.padded_vocab(m), d), "embed", None),
        "layers.ln1.scale": ((l, d), "scale", None),
        "layers.attn.wq": ((l, d, h * dh), "matrix", d),
        "layers.attn.wk": ((l, d, hkv * dh), "matrix", d),
        "layers.attn.wv": ((l, d, hkv * dh), "matrix", d),
        "layers.attn.wo": ((l, h * dh, d), "matrix", h * dh),
        "layers.ln2.scale": ((l, d), "scale", None),
        "layers.moe.router": ((l, d, e), "matrix", d),
        "layers.moe.wi": ((l, e, d, f), "matrix", d),
        "layers.moe.wg": ((l, e, d, f), "matrix", d),
        "layers.moe.wo": ((l, e, f, d), "matrix", f),
        "final_norm.scale": ((d,), "scale", None),
    }


def make_weights(m: dict, seed: int, device, shards: int) -> dict:
    dt = torch.bfloat16 if m["dtype"] == "bfloat16" else torch.float32
    g = torch.Generator(device=device).manual_seed(common.derive_seed(seed, "weights"))
    out = {}
    for name, (shape, kind, fan_in) in weight_specs(m, shards).items():
        if kind == "scale":
            w = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
            out[name] = w.mul_(0.1).add_(1.0)
            continue
        w = torch.randn(shape, generator=g, device=device, dtype=dt)
        out[name] = w.mul_(0.02 if kind == "embed" else fan_in ** -0.5)
    return out


def port_state_dict(weights: dict, n_layers: int) -> dict:
    sd = {}
    for name, w in weights.items():
        if name.startswith("layers."):
            rest = name[len("layers."):]
            for i in range(n_layers):
                sd[f"layers.{i}.{rest}"] = w[i]
        else:
            sd[name] = w
    return sd


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
        self.dep = cs["config"]["deployment"]
        self.traffic = cs["traffic"]
        self.shards = self.dep["shards"]
        self.attempted = self.failed = 0

    def build(self, mesh):
        from repro_torch.models.lm import LM

        self.cfg = arch_config(self.m)
        self.mesh = mesh
        self.secure = wire.session(self.seed, "exchange") if self.dep["secure_moe"] else None
        weights = make_weights(self.m, self.seed, self.device, self.shards)
        model = LM(self.cfg, n_model=self.shards, device="meta")
        model.load_state_dict(port_state_dict(weights, self.m["n_layers"]), strict=True,
                              assign=True)
        self.model = model

    def free_model(self):
        self.model = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def reference(self, tokens, positions, *, quant=None, kv_sink=None, weights=None,
                  stats=None):
        """The reference's logits (B, len(positions), vocab) over `tokens`."""
        weights = weights or make_weights(self.m, self.seed, self.device, self.shards)
        return ref_lm.forward(weights, self.m, tokens, logit_positions=positions,
                              shards=self.shards, prompt_len=self.traffic["prompt_tokens"],
                              quant=quant, kv_sink=kv_sink, stats=stats)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want| / |want|, Frobenius norms, in float64."""
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
