"""How the language-model harness names the port's weights
(`bench/drivers/lm.py::port_state_dict`): stacks over every layer or a
range of layers split into per-layer views, a layer's own tensor passed
through, and each malformed spec refused by name."""

from __future__ import annotations

import json
import re

import pytest
import torch

from bench import common, tiny
from bench.drivers import lm
from bench.reference import granite_moe

N_LAYERS = 4


def _t(*shape):
    return torch.randn(shape)


# (case, weights, port name -> (spec, index into it or None), or the spec a
# ValueError names)
CASES = [
    ("stack", {"layers.x": _t(4, 3)}, {f"layers.{i}.x": ("layers.x", i) for i in range(4)}),
    ("per_layer", {"layers.2.y": _t(5)}, {"layers.2.y": ("layers.2.y", None)}),
    ("range", {"layers.1:4.x": _t(3, 2)},
     {f"layers.{i}.x": ("layers.1:4.x", i - 1) for i in range(1, 4)}),
    ("other", {"embed.table": _t(6, 2)}, {"embed.table": ("embed.table", None)}),
    ("dense_first_then_range", {"layers.attn.w": _t(4, 2, 2), "layers.0.mlp.wi": _t(2, 3),
                                "layers.1:4.moe.wi": _t(3, 2, 2, 3)},
     {**{f"layers.{i}.attn.w": ("layers.attn.w", i) for i in range(4)},
      "layers.0.mlp.wi": ("layers.0.mlp.wi", None),
      **{f"layers.{i}.moe.wi": ("layers.1:4.moe.wi", i - 1) for i in range(1, 4)}}),
    ("stack_too_short", {"layers.x": _t(3, 2)}, "layers.x"),
    ("stack_too_long", {"layers.x": _t(5, 2)}, "layers.x"),
    ("stack_of_a_scalar", {"layers.x": torch.tensor(1.0)}, "layers.x"),
    ("range_stack_size", {"layers.1:4.x": _t(2, 2)}, "layers.1:4.x"),
    ("range_outside", {"layers.2:5.x": _t(3, 2)}, "layers.2:5.x"),
    ("range_empty", {"layers.2:2.x": _t(0, 2)}, "layers.2:2.x"),
    ("range_reversed", {"layers.3:1.x": _t(2, 2)}, "layers.3:1.x"),
    ("range_open", {"layers.1:.x": _t(3, 2)}, "layers.1:.x"),
    ("range_without_name", {"layers.1:4": _t(3, 2)}, "layers.1:4"),
    ("layer_outside", {"layers.4.y": _t(2)}, "layers.4.y"),
    ("layer_and_stack", {"layers.x": _t(4, 2), "layers.0.x": _t(2)}, "layers.0.x"),
    ("ranges_overlap", {"layers.0:2.x": _t(2, 2), "layers.1:4.x": _t(3, 2)}, "layers.1:4.x"),
]


@pytest.mark.parametrize("case,weights,want", CASES, ids=[c[0] for c in CASES])
def test_bench_port_state_dict_naming_rule(case, weights, want):
    m = {"n_layers": N_LAYERS}
    if isinstance(want, str):
        with pytest.raises(ValueError, match=re.escape(repr(want))):
            lm.port_state_dict(weights, m)
        return
    sd = lm.port_state_dict(weights, m)
    assert sorted(sd) == sorted(want)
    for key, (spec, i) in want.items():
        w = weights[spec] if i is None else weights[spec][i]
        assert sd[key].shape == w.shape and sd[key].stride() == w.stride()
        assert sd[key].data_ptr() == w.data_ptr()  # a view of the drawn stack, not a copy


def _old_port_state_dict(weights, m):
    """The rule before per-layer and range names: every `layers.` name a
    stack over all layers."""
    sd = {}
    for name, w in weights.items():
        if name.startswith("layers."):
            rest = name[len("layers."):]
            for i in range(m["n_layers"]):
                sd[f"layers.{i}.{rest}"] = w[i]
        else:
            sd[name] = w
    return sd


def test_bench_granite_state_dict_unchanged_by_the_naming_rule():
    """granite's specs give the same keys, in the same order, and the same
    views of the same storage as under the old rule."""
    config = json.loads((common.BENCH / "configs" / "granite-moe-3b-a800m.json").read_text())
    m = {**config["model"], **tiny.TINY_MODEL, "n_layers": 3}
    weights = lm.make_weights(granite_moe, m, 2**31 + 7, "cpu", 4)
    got, want = lm.port_state_dict(weights, m), _old_port_state_dict(weights, m)
    assert list(got) == list(want)
    for key in want:
        a, b = got[key], want[key]
        assert (a.shape, a.stride(), a.storage_offset(), a.dtype) == \
            (b.shape, b.stride(), b.storage_offset(), b.dtype)
        assert a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
