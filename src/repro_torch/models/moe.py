"""Mixture-of-Experts with the paper's secure MapReduce shuffle as dispatch.

Counterpart of `repro/models/moe.py`. The paper's pipeline is expert
parallelism:
    map      = router (token -> top-k expert keys)
    shuffle  = all_to_all keyed by expert id
    reduce   = expert FFN + gate-weighted combine
On a `VirtualMesh` of R shards standing for the reference's "model" axis,
the experts are sharded E/R (shard r holds experts [r·E/R, (r+1)·E/R)) and,
in prefill, the sequence too: `_moe_shuffle_body` packs each shard's tokens
with `core.shuffle.bucket_pack` and exchanges them with `keyed_all_to_all`,
ChaCha20-encrypted when `secure` is set (both legs; the return leg's
counters start at counter0 + 2**20, as the reference's). Decode steps whose
sequence does not split over R take `_moe_decode_body`: every shard holds
the same tokens and runs its own experts, and a `psum` adds the partial
outputs. Without a mesh, `_moe_local` packs and runs every expert in place.

The router (`_route`): "softmax" takes the top k of the softmax, gates
renormalised; "sigmoid_bias" (the port's own, DeepSeek-V3's noaux_tc with
one group) takes the top k of sigmoid(x W_r) + `router_bias` in float32,
and gates the chosen experts by their unbiased scores, renormalised, times
`cfg.routed_scaling`. Shared experts (the span `moe.shared`) add to every
token, through a sigmoid gate unless `cfg.shared_expert_gate` is False.

Token dropping: per-expert capacity = ceil(k·n/E_pad · capacity_factor),
rounded up to a multiple of 4 (at least 4); dropped tokens pass through, and
the drop count comes back as aux.

The combine adds each token's k gate-weighted expert outputs in index
order, starting from zero, with no atomics: the result does not depend on
the device's scheduling, so a secure run equals a plain one bit for bit.

A prefill with no gradient moves the routed rows by the routing's slot map
(`_dispatch_rows`, `_combine_rows`): on the card two hand-written kernels
(`kernels/moe`) write the send buffer from the token rows and read the
received buffer in place, with no k-fold copy and no element-wise gather;
elsewhere their plain versions. Both give the bits of the gradient path,
which keeps the k-fold broadcast for its backward.
The backward has no atomics either: the exchange's is the same exchange of
the cotangents (encrypted too, `core.shuffle._exchange_backward`), each
token's k entries are a broadcast (`_entry_values`), and the gathers by
slot read distinct slots but for the dropped entries' spare one, whose
cotangent is discarded.
"""

from __future__ import annotations

import torch

from repro_torch.core.shuffle import SecureShuffleConfig, bucket_pack, keyed_all_to_all
from repro_torch.kernels import kernel_calls, uses_kernel
from repro_torch.kernels.moe.kernel import moe_combine_cuda, moe_dispatch_cuda
from repro_torch.kernels.moe.ref import moe_combine_ref, moe_dispatch_ref, to_prompt_order
from repro_torch.models.layers import Params, act_fn, compute_dtype
from repro_torch.tools.opcount import spans

# what `moe_remat="save_shuffle"` keeps for the backward: the reference's
# checkpoint names "moe_recv" and "moe_back", the outputs of both legs
EXCHANGE_OPS = (torch.ops.repro_torch.keyed_exchange.default,)


def padded_experts(cfg, n_model: int = 1) -> int:
    e = cfg.n_experts
    return -(-e // n_model) * n_model


class SharedExpert(Params):
    def __init__(self, cfg, d: int, fs: int, device):
        super().__init__()
        self.weight("wi", (d, fs), cfg, device)
        self.weight("wg", (d, fs), cfg, device)
        self.weight("wo", (fs, d), cfg, device, fan_in=fs)
        if cfg.shared_expert_gate:
            self.weight("gate", (d, 1), cfg, device)


class MoE(Params):
    """Router, the (E_pad, ...) expert stacks and the optional shared expert;
    E_pad = `padded_experts(cfg, n_model)`. The expert stacks' leading-dim
    fan-in is the reference's `ninit` default (shape[0]). A "sigmoid_bias"
    router adds `router_bias` (E_pad,), zeros at init, in the compute dtype;
    it moves the choice of experts only, so it takes no gradient."""

    def __init__(self, cfg, device, n_model: int = 1):
        super().__init__()
        d, f, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, padded_experts(cfg, n_model)
        self.weight("router", (d, e), cfg, device)
        if cfg.router == "sigmoid_bias":
            self.param("router_bias", (e,), compute_dtype(cfg), device, ("fill", 0.0))
        self.weight("wi", (e, d, f), cfg, device)
        self.weight("wg", (e, d, f), cfg, device)
        self.weight("wo", (e, f, d), cfg, device, fan_in=f)
        if cfg.n_shared_experts:
            self.shared = SharedExpert(cfg, d, cfg.shared_d_ff or cfg.n_shared_experts * f,
                                       device)


def moe_init(cfg, n_model: int = 1, device=None) -> MoE:
    return MoE(cfg, device, n_model)


def _route(cfg, router_w, x2, e_pad, bias=None):
    """x2: (..., n, d) -> gates (..., n, k), experts (..., n, k) int32, aux (...);
    `bias` the "sigmoid_bias" router's (E_pad,) (`_route_layer`).

    The experts are the top k by probability ("softmax") or by biased score
    ("sigmoid_bias"), ties to the lower index, as `lax.top_k` orders them (a
    stable descending sort: bf16 router logits tie often enough to matter).
    """
    k = cfg.n_experts_per_tok
    if cfg.router == "sigmoid_bias":
        scores = torch.sigmoid(x2.float() @ router_w.float())
        choice = scores + bias.float()
        if e_pad > cfg.n_experts:  # padding experts never win
            choice[..., cfg.n_experts:] = -torch.inf
            scores[..., cfg.n_experts:] = 0.0
        eidx = torch.sort(choice, dim=-1, descending=True, stable=True)[1][..., :k]
        gates = torch.gather(scores, -1, eidx)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9) * cfg.routed_scaling
        probs = scores / torch.clamp(scores.sum(-1, keepdim=True), min=1e-9)
    else:
        logits = (x2 @ router_w.to(x2.dtype)).float()
        if e_pad > cfg.n_experts:  # padding experts never win (logits is a new tensor)
            logits[..., cfg.n_experts:] = -1e30
        probs = torch.softmax(logits, dim=-1)
        gates, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, eidx = gates[..., :k], eidx[..., :k]
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # aux: load-balance statistics (Switch-style), per shard
    load = torch.nn.functional.one_hot(eidx[..., 0], e_pad).float().mean(dim=-2)
    importance = probs.mean(dim=-2)
    aux = e_pad * torch.sum(load * importance, dim=-1)
    return gates.to(x2.dtype), eidx.to(torch.int32), aux


def _route_layer(cfg, params, x2, e_pad):
    """`_route` with a MoE layer's router (and its bias, where it has one)."""
    return _route(cfg, params.router, x2, e_pad, getattr(params, "router_bias", None))


def _expert_ffn(cfg, wi, wg, wo, xe):
    """xe: (..., E_loc, C, d) -> (..., E_loc, C, d), batched over local experts."""
    dt = xe.dtype
    h = torch.matmul(xe, wi.to(dt))
    g = torch.matmul(xe, wg.to(dt))
    return torch.matmul(act_fn(cfg)(g) * h, wo.to(dt))


def _shared_expert(cfg, sp, x2):
    """The shared experts' output for every token (the span `moe.shared`)."""
    with spans.span("moe.shared"):
        dt = x2.dtype
        h = x2 @ sp.wi.to(dt)
        g = x2 @ sp.wg.to(dt)
        y = (act_fn(cfg)(g) * h) @ sp.wo.to(dt)
        if not cfg.shared_expert_gate:
            return y
        gate = torch.sigmoid((x2 @ sp.gate.to(dt)).float()).to(dt)
        return y * gate


def _capacity(cfg, n_tokens: int, e_pad: int) -> int:
    c = int(n_tokens * cfg.n_experts_per_tok / e_pad * cfg.capacity_factor) + 1
    return max(4, -(-c // 4) * 4)


def _entry_keys(n: int, k: int, device):
    """The key of each of the n·k entries: its index."""
    return torch.arange(n * k, dtype=torch.int32, device=device)


def _entry_values(x2, k: int):
    """(..., n, d) -> (..., n·k, d): each token's row k times, entry order.

    The reference's `x2[entry_token]`, the same values; written as a
    broadcast, its backward sums each token's k cotangents by a reduction,
    not by a scatter with float atomics in no fixed order."""
    n, d = x2.shape[-2:]
    return x2.unsqueeze(-2).expand(x2.shape[:-2] + (n, k, d)).reshape(
        x2.shape[:-2] + (n * k, d))


def _combine(flat, pos, gates, n: int):
    """Gate-weighted sum of each token's k expert outputs.

    flat (S, slots + 1, d), the last row zeros (dropped entries point there);
    pos (S, n·k) flat slots; gates (S, n, k). The k contributions of a token
    are contiguous and are added in index order from zero, as the
    reference's `segment_sum` over entry tokens adds them, with no atomics.
    """
    s, _, d = flat.shape
    k = gates.shape[-1]
    rows = torch.arange(s, device=flat.device)[:, None]
    contrib = (flat[rows, pos.long()] * gates.reshape(s, -1, 1)).reshape(s, n, k, d)
    y = torch.zeros((s, n, d), dtype=flat.dtype, device=flat.device)
    for j in range(k):
        y = y + contrib[:, :, j]
    return y


def _with_zero_row(y):
    """(S, slots, d) -> (S, slots + 1, d), the spare slot zeros."""
    return torch.cat([y, torch.zeros_like(y[:, :1])], dim=1)


def _dispatch_rows(x2, slots, k: int):
    """The (R, S, d) send buffer by the slot map: slot s of shard r holds
    x2[r, slots[r, s] // k], zeros for an empty slot (-1). The kernel for a
    CUDA tensor, the plain version for any other; noted in
    `kernel_calls["moe_dispatch"]`."""
    kernel_calls.note("moe_dispatch")
    if uses_kernel("auto", x2):
        return moe_dispatch_cuda(x2, slots, k)
    return moe_dispatch_ref(x2, slots, k)


def _combine_rows(got, pos, gates, batch: int | None = None):
    """`_combine(_with_zero_row(got), pos, gates, n)` without the copy, the
    bits the same: got (R, S, d) read in place; (R, n, d), or (B, T, d) with
    `batch`. The kernel for a CUDA tensor, the plain version for any other;
    noted in `kernel_calls["moe_combine"]`."""
    kernel_calls.note("moe_combine")
    if uses_kernel("auto", got):
        return moe_combine_cuda(got, pos, gates, batch)
    return moe_combine_ref(got, pos, gates, batch)


def _moe_local(cfg, params, x2, e_pad: int, capacity: int | None = None):
    """Single-domain path: pack -> batched expert FFN -> combine (no comms)."""
    n, d = x2.shape
    gates, eidx, aux = _route_layer(cfg, params, x2, e_pad)
    k = cfg.n_experts_per_tok
    cap = capacity or _capacity(cfg, n, e_pad)
    keys = _entry_keys(n, k, x2.device)
    _, packed, dropped, pos = bucket_pack(keys, eidx.reshape(-1), {"x": _entry_values(x2, k)},
                                          e_pad, cap, return_positions=True)
    y_buf = _expert_ffn(cfg, params.wi, params.wg, params.wo, packed["x"])
    flat = _with_zero_row(y_buf.reshape(1, e_pad * cap, d))
    y = _combine(flat, pos[None], gates[None], n)[0]
    if cfg.n_shared_experts:
        y = y + _shared_expert(cfg, params.shared, x2)
    return y.to(x2.dtype), aux, dropped


def _expert_shards(params, r: int):
    """The expert stacks as (R, E_loc, ...) views: shard r's own experts."""
    e_pad = params.wi.shape[0]
    if e_pad % r:
        raise ValueError(f"{e_pad} experts do not split over {r} shards; build the "
                         f"model with n_model={r}")
    return [w.reshape((r, e_pad // r) + tuple(w.shape[1:]))
            for w in (params.wi, params.wg, params.wo)]


def _moe_decode_body(cfg, params, x, mesh):
    """Replicated-dispatch EP for short sequences (decode): every shard holds
    the same tokens, computes only its own experts; partial sums psum'd."""
    b, t, d = x.shape
    r = mesh.n_shards
    x2 = x.reshape(-1, d)
    n = x2.shape[0]
    wi, wg, wo = _expert_shards(params, r)
    e_pad = params.wi.shape[0]
    e_loc = e_pad // r
    my_first = (mesh.axis_index() * e_loc)[:, None]  # (R, 1)

    gates, eidx, aux = _route_layer(cfg, params, x2, e_pad)
    k = cfg.n_experts_per_tok
    keys = _entry_keys(n, k, x.device)
    expert = eidx.reshape(1, -1)
    mine = (expert >= my_first) & (expert < my_first + e_loc)
    keys = torch.where(mine, keys, -1)
    cap = max(4, n)  # worst case: all local tokens on one local expert
    values = {"x": _entry_values(x2, k).expand(r, n * k, d)}
    _, packed, dropped, pos = bucket_pack(keys, expert - my_first, values, e_loc, cap,
                                          return_positions=True)
    ye = _expert_ffn(cfg, wi, wg, wo, packed["x"])  # (R, E_loc, cap, d)
    flat = _with_zero_row(ye.reshape(r, e_loc * cap, d))
    y = _combine(flat, pos, gates.expand((r,) + tuple(gates.shape)), n)
    y = mesh.psum(y)[0]
    if cfg.n_shared_experts:
        y = y + _shared_expert(cfg, params.shared, x2)
    # aux is the same on every shard (pmean of equal values); dropped is
    # replicated over the shards, hence the reference's psum // n_model
    return y.reshape(b, t, d).to(x.dtype), aux, dropped.sum() // r


def _moe_shuffle_body(cfg, params, x, mesh, secure: SecureShuffleConfig | None):
    """Sequence split over the R shards: x (B, T, d) -> (R, B·T/R, d), each
    shard's tokens b-major as the reference's per-shard `x.reshape(-1, d)`
    (which tokens a full expert drops depends on that order). Spans:
    `moe.route` (the split, routing and packing), `moe.experts` (the
    expert FFN and its transposes); each leg is `shuffle.exchange`.

    With no gradient the rows move by the slot map (`_dispatch_rows`,
    `_combine_rows`; the combine, any shared expert and y's layout are the
    span `moe.combine`); with one, by the k-fold broadcast, whose backward
    sums each token's k cotangents by a reduction. The same bits either way.
    """
    b, t, d = x.shape
    r = mesh.n_shards
    wi, wg, wo = _expert_shards(params, r)
    e_pad = params.wi.shape[0]
    e_loc = e_pad // r
    k = cfg.n_experts_per_tok
    by_slot = not torch.is_grad_enabled()
    with spans.span("moe.route"):
        x2 = x.reshape(b, r, t // r, d).transpose(0, 1).reshape(r, -1, d)
        n = x2.shape[1]
        gates, eidx, aux = _route_layer(cfg, params, x2, e_pad)  # (R, n, k)
        cap = _capacity(cfg, n, e_pad)

        # --- map: emit (expert_key, token_vector); shuffle: hash(key) = key --
        keys = _entry_keys(n, k, x.device)
        if by_slot:  # the keys are the entries: the packed keys are the slot map
            slots, _, dropped, pos = bucket_pack(keys.expand(r, -1), eidx.reshape(r, -1), {},
                                                 e_pad, cap, return_positions=True)
            send = _dispatch_rows(x2, slots.reshape(r, e_pad * cap), k)
        else:
            _, packed, dropped, pos = bucket_pack(keys.expand(r, -1), eidx.reshape(r, -1),
                                                  {"x": _entry_values(x2, k)}, e_pad, cap,
                                                  return_positions=True)
            send = packed["x"]
        send = send.reshape(r, r, e_loc * cap, d)  # dest-shard-major
    recv = keyed_all_to_all({"x": send}, mesh, secure)["x"]  # (R, src, E_loc·cap, d)

    # --- reduce: local experts over tokens from every source ------------------
    with spans.span("moe.experts"):
        xe = recv.reshape(r, r, e_loc, cap, d).transpose(1, 2).reshape(r, e_loc, r * cap, d)
        ye = _expert_ffn(cfg, wi, wg, wo, xe)
        back = ye.reshape(r, e_loc, r, cap, d).transpose(1, 2).reshape(r, r, e_loc * cap, d)

    # --- return shuffle (the reducer->client leg) ------------------------------
    sec_back = None
    if secure is not None:  # a fresh config, as the reference's: default impl and wire
        sec_back = SecureShuffleConfig(key_words=secure.key_words,
                                       nonce_words=secure.nonce_words,
                                       counter0=secure.counter0 + (1 << 20))
    got = keyed_all_to_all({"x": back}, mesh, sec_back)["x"].reshape(r, e_pad * cap, d)

    if by_slot:
        with spans.span("moe.combine"):
            if cfg.n_shared_experts:
                y = _combine_rows(got, pos, gates) + _shared_expert(cfg, params.shared, x2)
                y = to_prompt_order(y, b)
            else:  # written straight in (B, T, d) order
                y = _combine_rows(got, pos, gates, b)
        return y.to(x.dtype), aux.sum() / r, dropped.sum()
    y = _combine(_with_zero_row(got), pos, gates, n)
    if cfg.n_shared_experts:
        y = y + _shared_expert(cfg, params.shared, x2)
    return to_prompt_order(y, b).to(x.dtype), aux.sum() / r, dropped.sum()


def moe_apply(cfg, params, x, *, mesh=None, secure: SecureShuffleConfig | None = None):
    """x: (B, T, d) -> (y, aux, dropped). Shuffle dispatch when
    cfg.moe_dispatch == 'shuffle' and a mesh is given: the sequence splits
    over the shards when R divides T (T >= R), else (decode at R > 1) the
    replicated dispatch. Otherwise the local path."""
    if cfg.moe_dispatch == "shuffle" and mesh is not None:
        r = mesh.n_shards
        if x.shape[1] % r == 0 and x.shape[1] >= r:
            return _moe_shuffle_body(cfg, params, x, mesh, secure)
        return _moe_decode_body(cfg, params, x, mesh)
    b, t, d = x.shape
    y, aux, dropped = _moe_local(cfg, params, x.reshape(-1, d), params.wi.shape[0])
    return y.reshape(b, t, d), aux, dropped
