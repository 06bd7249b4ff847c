"""Secure prefills of a MoE model: `serve.engine.prefill` on the mesh, the
expert exchange encrypted.

Set-up builds the model from the seed's weights and runs one prefill to
warm its shapes. The window runs whole prefills of `batch` fresh prompts
of `prompt_tokens` tokens each, one after another, until `--seconds` have
passed. The mesh keeps a sample of each exchange leg's ciphertext as it
crossed (the first 64 words of every wire row: one small copy a leg).

The check, once the window has closed and the model is freed: the
reference runs the last prefill's prompts, and a second prefill's drawn
from the seed, and judges the program's last-token logits (the relative
error of the logits) and the cache the last prefill left (each layer's
entry of every tensor the reference's `cache_sink` names, against the
reference's: granite's keys "k" and values "v"); the sampled ciphertext of
every leg of the last prefill must decrypt, under the benchmark's own
ChaCha20, to finite activations.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench import common, wire
from bench.drivers import lm

TAP_WORDS = 64  # words of each wire row kept: 4 keystream blocks
PLAIN_BOUND = 1e4  # |activation| a decrypted bf16 sample may not exceed


class Cell(lm.LMBase):
    def setup(self):
        from repro_torch.serve.engine import init_cache, prefill

        self._prefill = prefill
        self.dtype = torch.bfloat16 if self.m["dtype"] == "bfloat16" else torch.float32
        self.batch, self.tokens = self.traffic["batch"], self.traffic["prompt_tokens"]
        # the first TAP_WORDS words of every row of each leg, legs counted from `leg = 0`
        self.taps = torch.zeros((self.ref.exchange_legs(self.m), self.shards, self.shards,
                                 TAP_WORDS), dtype=torch.int32, device=self.device)
        self.leg = 0

        def tap(out):
            if self.leg < self.taps.shape[0]:
                self.taps[self.leg].copy_(out[:, :, :TAP_WORDS])
                self.leg += 1

        self.build(wire.tapped_mesh(self.shards, self.device, tap))
        self.cache = init_cache(self.cfg, self.batch, self.tokens, self.device)
        self._run(lm.prompts(self.m, self.seed, "warm", self.batch, self.tokens, self.device))
        self.logits: list[torch.Tensor] = []
        self.wire_bytes: list[int] = []

    def _run(self, toks):
        self.leg = 0
        out = self._prefill(self.cfg, self.model, toks, self.cache, mesh=self.mesh,
                            secure_moe=self.secure)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return out

    def window(self, seconds: float, scope):
        from repro_torch.core.shuffle import record_wire_bytes

        with scope:
            deadline = scope.t0 + seconds
            while True:
                toks = lm.prompts(self.m, self.seed, str(len(self.logits)), self.batch,
                                  self.tokens, self.device)
                t0 = time.perf_counter()
                with record_wire_bytes() as recs:
                    self.logits.append(self._run(toks))
                t1 = time.perf_counter()
                self.rec.add_span("prefill", t0, t1, i=len(self.logits) - 1)
                self.wire_bytes.append(sum(r["wire_bytes"] for r in recs) * self.shards)
                if t1 >= deadline:
                    break
        self.attempted = len(self.logits)

    def end_to_end(self) -> dict:
        spans = self.rec.of("prefill")
        tokens = len(spans) * self.batch * self.tokens
        return {"prefill_tokens_per_s": tokens / (spans[-1][2] - spans[0][1])}

    def readings(self, scope):
        spans = self.rec.of("prefill")
        return common.Readings(trace=scope, rec=self.rec, cs=self.cs, facts={
            "prefills": len(spans), "batch": self.batch, "tokens": self.tokens,
            "model": self.m, "shards": self.shards, "wire_bytes": self.wire_bytes,
            "span_s": spans[-1][2] - spans[0][1],
            "prefill_flops": self.ref.prefill_flops(self.m, self.batch, self.tokens),
            "attention_flops": self.ref.prefill_attention_flops(self.m, self.batch,
                                                                self.tokens),
            "legs": self.ref.exchange_legs(self.m),
            "leg_bytes": self.ref.leg_wire_bytes(self.m, self.batch, self.tokens,
                                                 self.shards)})

    def release(self):
        self.kept = dict(self.cache)  # every tensor of the cache, by name
        self.cache = None
        self.free_model()

    def check(self) -> dict:
        v = self.m["vocab_size"]
        last = len(self.logits) - 1
        rng = np.random.default_rng(common.derive_seed(self.seed, "check"))
        others = [i for i in range(last)]
        picked = [last] + ([int(rng.choice(others))] if others else [])
        self.checked = picked
        weights = self.weights()
        numbers = {"wire_faults": float(self._wire_faults()), "logits_rel_err": 0.0,
                   "cache_rel_err": 0.0}
        routing: dict = {}
        for i in picked:
            toks = lm.prompts(self.m, self.seed, str(i), self.batch, self.tokens, self.device)
            sink = self._cache_sink(numbers) if i == last else None
            ref = self.reference(toks, [self.tokens - 1], cache_sink=sink, weights=weights,
                                 stats=routing)[:, 0]
            got = self.logits[i][:, :v].float()
            numbers["logits_rel_err"] = max(numbers["logits_rel_err"], lm.rel_err(got, ref))
        # how far capacity_factor's drops take the cell from a dropless model
        self.dropped_share = routing.get("dropped", 0) / max(routing.get("routed", 0), 1)
        return numbers

    def _cache_sink(self, numbers):
        """Each layer's cache tensors of the reference against the program's
        of the same name (a name the program's cache lacks raises)."""
        def sink(layer, tensors):
            for name, want in tensors.items():
                got = self.kept[name][layer]
                numbers["cache_rel_err"] = max(numbers["cache_rel_err"],
                                               lm.rel_err(got[:, :want.shape[1]], want))
        return sink

    def control(self, indices) -> dict:
        """The reference in fp8 put in the program's place, judged alike."""
        numbers = {"logits_rel_err": 0.0, "cache_rel_err": 0.0}
        weights = self.weights()
        for i in indices:
            toks = lm.prompts(self.m, self.seed, str(i), self.batch, self.tokens, self.device)
            kept = {}
            ref = self.reference(toks, [self.tokens - 1], weights=weights,
                                 cache_sink=kept.__setitem__)[:, 0]

            def sink(layer, tensors):
                for name, got in tensors.items():
                    numbers["cache_rel_err"] = max(numbers["cache_rel_err"],
                                                   lm.rel_err(got, kept[layer][name]))

            got = self.reference(toks, [self.tokens - 1], quant="fp8", weights=weights,
                                 cache_sink=sink)[:, 0]
            numbers["logits_rel_err"] = max(numbers["logits_rel_err"], lm.rel_err(got, ref))
        return numbers

    def _wire_faults(self) -> int:
        """Legs of the last prefill whose sampled ciphertext does not decrypt
        to finite activations under the exchange's keystream."""
        if self.secure is None:
            return 0
        s = self.shards
        words = self.ref.leg_wire_bytes(self.m, self.batch, self.tokens, s) // (s * s * 4)
        row_blocks = -(-words // 16)
        faults = 0
        for leg in range(self.taps.shape[0]):
            # the return leg draws from counter0 + 2**20 (models/moe.py's layout)
            ks = wire.keystream(self.secure, s, [0], (leg % 2) << 20, row_blocks,
                                TAP_WORDS // 16, self.device)[0]
            vals = (self.taps[leg].reshape(s * s, -1) ^ ks).view(self.dtype).float()
            if not bool((torch.isfinite(vals) & (vals.abs() <= PLAIN_BOUND)).all()):
                faults += 1
        return faults
