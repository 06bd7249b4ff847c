"""The port's abstract dry-run (repro_torch.launch.dryrun) on the CPU.

For a reduced config of each family (dense, vlm, moe with and without
shared experts, moe with latent attention and a dense first layer, ssm,
hybrid, audio) and each kind of cell (a training step,
a prefill, a decode step) at a small shape, the abstract run on the `meta`
device counts what the same entry run for real on the CPU counts: the same
FLOPs (`FlopCounterMode`, exactly), the same kernel calls, collectives and
wire bytes (the MoE's exchange encrypted, so the ChaCha20 operator's fake
runs), and the same resident bytes, which equal the real tensors' sizes
summed here. The bytes the operations move agree within 1% (a meta tensor
and a CPU tensor take a few framework operations differently: a scalar
lifted to a tensor, `one_hot`'s range check). At the published configs,
`fits_one_card` agrees with the bf16 weight sizes of ROADMAP item 12:
deepseek-67b (133 GB) and mistral-large-123b (244 GB) never fit; a cell
that fits has weights that fit. A training step counted one microbatch at a
time (`one_microbatch=True`: the first microbatch run, its counts added
again for each later one) counts exactly what the whole step counts.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import ALL_ARCH_IDS, ShapeConfig, get_config
from repro_torch.launch import dryrun
from repro_torch.tools.roofline import param_counts

FAMILIES = ["glm4-9b", "chameleon-34b", "granite-moe-3b-a800m", "qwen2-moe-a2.7b",
            "rwkv6-1.6b", "zamba2-1.2b", "whisper-base", "moonlight-16b-a3b"]
KINDS = {"train": ShapeConfig("train_small", "train", 16, 2),
         "prefill": ShapeConfig("prefill_small", "prefill", 16, 2),
         "decode": ShapeConfig("decode_small", "decode", 16, 2)}


def _reduced(arch: str) -> dict:
    red = get_config(arch).reduced()
    over = {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if f.name not in ("name", "source")}
    if red.family == "moe":
        over["secure_moe"] = True
    return over


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", FAMILIES)
def test_abstract_counts_equal_a_real_cpu_run(arch, kind):
    over, shape = _reduced(arch), KINDS[kind]
    meta = dryrun.run_cell(arch, kind, over, shape=shape, device="meta")
    real = dryrun.run_cell(arch, kind, over, shape=shape, device="cpu")
    assert meta["device"] == "meta" and real["device"] == "cpu"
    assert meta["flops"] == real["flops"] > 0
    assert meta["kernel_calls"] == real["kernel_calls"]
    assert meta["collectives"] == real["collectives"]
    assert meta["memory"] == real["memory"]
    assert meta["bytes_accessed"] == pytest.approx(real["bytes_accessed"], rel=1e-2)
    assert meta["roofline"]["compute_s"] == real["roofline"]["compute_s"]
    if get_config(arch).family == "moe" and kind != "decode":
        # the encrypted exchange ran, abstractly too: 2 legs x 2 crypts a
        # layer forward, as many for the cotangents in training
        per_layer = 8 if kind == "train" else 4
        micro = dryrun.pick_accum(get_config(arch), shape) if kind == "train" else 1
        n_moe = over["n_layers"] - over["first_dense_layers"]  # the MoE layers
        want = {"chacha20_xor_packed": n_moe * per_layer * micro}
        if kind == "prefill":  # and the prefill's attention, once a layer, dispatch and
            want["attention_prefill"] = over["n_layers"]  # combine once a MoE layer
            want["moe_dispatch"] = want["moe_combine"] = n_moe
        assert meta["kernel_calls"] == want
        assert meta["collectives"]["wire_bytes"] > 0


@pytest.mark.parametrize("kind", list(KINDS))
def test_resident_bytes_are_the_real_tensors_sizes(kind):
    """The memory figures of a real CPU entry equal its tensors' sizes
    summed by hand: parameters, optimizer state, cache and inputs."""
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"), **_reduced("qwen2-moe-a2.7b"))
    _, resident = dryrun.entry(cfg, KINDS[kind], torch.device("cpu"))
    mem = dryrun._memory(resident)

    def size(ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    params = size(resident["params"])
    assert mem["params_bytes"] == params > 0
    if kind == "train":
        opt = resident["opt_state"]
        assert all(p.dtype == torch.float32 for p in resident["params"])
        assert mem["opt_state_bytes"] == 2 * params + opt["count"].element_size()
        assert mem["inputs_bytes"] == size(resident["inputs"].values())
        assert "cache_bytes" not in mem
    else:
        assert mem["cache_bytes"] == size(resident["cache"].values())
        assert mem["inputs_bytes"] == size(resident["inputs"])
    assert mem["peak_per_device"] == sum(v for k, v in mem.items() if k.endswith("_bytes"))


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_fits_one_card_agrees_with_the_bf16_weight_sizes(shape):
    got = {arch: dryrun.cell_memory(arch, shape) for arch in ALL_ARCH_IDS}
    no_fit = {"deepseek-67b", "mistral-large-123b"}
    for arch, mem in got.items():
        bf16_gb = 2 * param_counts(get_config(arch))[0] / 1e9
        assert mem["weights_fit_one_card"] == (arch not in no_fit), (arch, bf16_gb)
        assert mem["weights_fit_one_card"] == (bf16_gb <= 80), arch
        if mem["fits_one_card"]:
            assert mem["weights_fit_one_card"]
        if arch in no_fit:
            assert not mem["fits_one_card"]
    # the serving weights are the bf16 counts (norms in float32; qwen2's 60
    # experts padded to 64 over 8 shards add theirs)
    glm = got["glm4-9b"]["params_bytes"]
    assert glm == pytest.approx(2 * param_counts(get_config("glm4-9b"))[0], rel=1e-3)


@pytest.mark.parametrize("arch,over", [("rwkv6-1.6b", {"wkv_impl": "scan"}),
                                       ("granite-moe-3b-a800m", {})])
def test_one_microbatch_counts_equal_the_whole_step(arch, over):
    over, shape = {**_reduced(arch), **over}, ShapeConfig("train_small", "train", 16, 4)
    whole = dryrun.run_cell(arch, "train", over, shape=shape, accum=4)
    once = dryrun.run_cell(arch, "train", over, shape=shape, accum=4, one_microbatch=True)
    assert whole["accum"] == once["accum"] == 4
    for k in ("flops", "bytes_accessed", "device_ops", "kernel_calls", "collectives", "memory",
              "roofline"):
        assert once[k] == whole[k], k
    assert once["t_compile_s"] < whole["t_compile_s"]
