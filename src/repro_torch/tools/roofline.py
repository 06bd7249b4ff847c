"""Analytic model FLOPs (6·N·D / 2·N·D), the card's roofline terms, and the
report of the port's dry-run.

Counterpart of `repro/tools/roofline.py`. `param_counts` and `model_flops`
are the reference's formulas, unchanged: plain Python over a config, with
a copy of the SSM's dims.
`roofline_terms` divides a cell's counts by the peaks of one NVIDIA H100
SXM (NVIDIA's data sheet, dense, at its 700 W power limit): 989 TFLOP/s in
bf16 on the tensor cores and 3.35 TB/s of HBM3. The reference's TPU peaks
(`repro/tools/hlo.py`) are not carried over. One card has no link: the
virtual mesh's exchange is a transpose in device memory, so a cell's
collective term is its wire read and written once at the HBM rate.
`generate_report` digests `reports/dryrun_torch.json`
(`repro_torch.launch.dryrun`) into the reference's row fields.
"""

from __future__ import annotations

import json

from repro_torch.configs import ALL_ARCH_IDS, PORT_ARCH_IDS, SHAPES, get_config, get_shape

PEAK_FLOPS = 989e12  # H100 SXM, bf16 dense tensor cores, 700 W
HBM_BW = 3.35e12  # H100 SXM HBM3, B/s
CARD_BYTES = 80e9  # H100 SXM device memory
MESHES = ("one_card",)
# `models/ssm.py`'s per-head channels and dims, copied so these formulas stay
# plain Python over a config (tests hold the copy to the module's)
HEAD_P = 64


def ssm_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // HEAD_P


def param_counts(cfg) -> tuple[int, int]:
    """(total, active-per-token) parameter counts, embeddings included once:
    the reference's formulas, and for the port's own configs
    (`configs.PORT_ARCH_IDS`) the model's own parameters (`_built_counts`)."""
    if cfg.name in PORT_ARCH_IDS:
        return _built_counts(cfg)
    d, ff, l = cfg.d_model, cfg.d_ff, cfg.n_layers
    dh = cfg.head_dim
    attn = d * cfg.n_heads * dh + 2 * d * cfg.n_kv_heads * dh + cfg.n_heads * dh * d
    emb = cfg.padded_vocab * d

    if cfg.family == "moe":
        f = cfg.moe_d_ff or ff
        router = d * cfg.n_experts
        expert = 3 * d * f
        shared = (3 * d * cfg.shared_d_ff + d) if cfg.n_shared_experts else 0
        layer_total = attn + router + cfg.n_experts * expert + shared
        layer_active = attn + router + cfg.n_experts_per_tok * expert + shared
        total = emb + l * layer_total
        active = emb + l * layer_active
        return total, active
    if cfg.family == "ssm":  # rwkv6
        layer = 5 * d * d + d * 32 + 32 * d + 2 * d * ff + d * d
        total = emb + l * layer
        return total, total
    if cfg.family == "hybrid":
        d_inner, h = ssm_dims(cfg)
        n = cfg.ssm_state
        mamba = d * (2 * d_inner + 2 * n + h) + d_inner * d + cfg.ssm_conv * d_inner
        shared_attn = attn + 3 * d * ff
        total = emb + l * mamba + shared_attn
        return total, total
    if cfg.family == "audio":
        enc_layer = attn + 3 * d * ff
        dec_layer = 2 * attn + 3 * d * ff
        total = emb + cfg.n_encoder_layers * enc_layer + l * dec_layer
        return total, total
    layer = attn + 3 * d * ff  # dense / vlm
    total = emb + l * layer
    return total, total


def _built_counts(cfg) -> tuple[int, int]:
    """Every parameter of the model built on `meta`; active leaves out the
    routed experts a token does not reach."""
    from repro_torch.models.lm import LM

    params = dict(LM(cfg, n_model=1, device="meta").named_parameters())
    total = sum(p.numel() for p in params.values())
    experts = sum(p.numel() for n, p in params.items() if n.endswith((".moe.wi", ".moe.wg", ".moe.wo")))
    idle = experts * (cfg.n_experts - cfg.n_experts_per_tok) // max(cfg.n_experts, 1)
    return total, total - idle


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N_active·D for training, 2·N_active·D for inference."""
    _, active = param_counts(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    return 2.0 * active * shape.global_batch  # decode: one token per sequence


def roofline_terms(flops: float, bytes_accessed: float, wire_bytes: float) -> dict:
    """Three terms in seconds on one card: the counted operations over the
    bf16 peak, the bytes the cell's operations read and write over the HBM
    rate, and the exchange's wire (read and written once) over the same
    rate; `dominant` names the largest."""
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_accessed / HBM_BW
    t_coll = 2 * wire_bytes / HBM_BW
    dom = max((("compute", t_compute), ("memory", t_memory), ("collective", t_coll)),
              key=lambda kv: kv[1])[0]
    return {"compute_s": t_compute, "memory_s": t_memory, "collective_s": t_coll,
            "dominant": dom, "flops_per_chip": flops, "bytes_per_chip": bytes_accessed,
            "link_bytes_per_chip": wire_bytes}


def one_sentence(dom: str, cfg, shape) -> str:
    if dom == "compute":
        return "at the compute roofline; only kernel-level fusion moves it"
    if dom == "collective":
        return ("shrink/overlap collectives: larger per-chip shards, bf16 wire "
                "payloads, or fewer TP boundaries per layer")
    if shape.kind == "decode":
        return "HBM-bound by design (KV/state streaming) — near the decode roofline"
    return ("reduce HBM round-trips: flash-style attention fusion and less "
            "remat recompute of wide activations")


def generate_report(report_path: str) -> dict:
    """Digest the port's dry-run JSON into the reference's report rows
    (`hlo_flops_global` is the counted FLOPs of the abstract run, and
    `t_compile_s` its seconds: the port compiles nothing)."""
    with open(report_path) as f:
        results = json.load(f)
    rows = []
    for mesh_name in MESHES:
        for arch in ALL_ARCH_IDS:
            cfg = get_config(arch)
            for shape_name in SHAPES:
                key = f"{arch}|{shape_name}|{mesh_name}"
                r = results.get(key)
                if r is None:
                    continue
                shape = get_shape(shape_name)
                if r["status"] == "SKIP":
                    rows.append({"key": key, "status": "SKIP", "reason": r["reason"],
                                 "mesh": mesh_name, "arch": arch, "shape": shape_name})
                    continue
                if r["status"] != "OK":
                    rows.append({"key": key, "status": "FAIL", "mesh": mesh_name,
                                 "arch": arch, "shape": shape_name})
                    continue
                rf = r["roofline"]
                mf = model_flops(cfg, shape)
                hlo_global = rf["flops_per_chip"] * r["n_chips"]
                rows.append({
                    "key": key, "status": "OK", "mesh": mesh_name, "arch": arch,
                    "shape": shape_name, "n_chips": r["n_chips"],
                    "compute_s": rf["compute_s"], "memory_s": rf["memory_s"],
                    "collective_s": rf["collective_s"], "dominant": rf["dominant"],
                    "model_flops": mf, "hlo_flops_global": hlo_global,
                    "useful_ratio": mf / hlo_global if hlo_global else 0.0,
                    "peak_gib": r["memory"].get("peak_per_device", 0) / 2**30,
                    "collectives": r.get("collectives", {}).get("collective_counts", {}),
                    "t_compile_s": r["t_compile_s"],
                    "note": one_sentence(rf["dominant"], cfg, shape),
                })
    return {"rows": rows}
