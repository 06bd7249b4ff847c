"""Greedy decoding of a MoE model from long cached contexts:
`serve.engine.decode_step` on the mesh (whose one-token steps take the
replicated expert dispatch: no exchange, no keystream).

Set-up prefills `contexts` batches of `batch` prompts of `prompt_tokens`
tokens (the exchange encrypted), keeps a copy of each cache and the first
token each prompt's logits serve, and warms a decode step. A request
restores one context's cache from its copy (every tensor of the cache
dict), then generates `new_tokens` greedy tokens a sequence, each step's
argmax on the card feeding the next step. Requests follow one another, the
contexts in an order drawn from the seed, until `--seconds` have passed;
the request open then stops at that step.

The check, once the window has closed and the model is freed: for a sample
of the window's requests drawn from the seed (the first, longest, in it),
the reference runs each prompt with the tokens it was served and judges
the program's logits at every served position against the reference's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench import common
from bench.drivers import lm


class Cell(lm.LMBase):
    def setup(self):
        from repro_torch.mesh import VirtualMesh
        from repro_torch.serve.engine import decode_step, init_cache, prefill

        self._step = decode_step
        t = self.traffic
        self.batch, self.tokens, self.new = t["batch"], t["prompt_tokens"], t["new_tokens"]
        self.build(VirtualMesh(self.shards, self.device))
        smax = self.tokens + self.new + 1
        self.saved, self.first = [], []
        for c in range(t["contexts"]):
            cache = init_cache(self.cfg, self.batch, smax, self.device)
            toks = lm.prompts(self.m, self.seed, f"context{c}", self.batch, self.tokens,
                              self.device)
            logits = prefill(self.cfg, self.model, toks, cache, mesh=self.mesh,
                             secure_moe=self.secure)
            self.first.append(self._argmax(logits))
            self.saved.append(cache)
        self.cache = init_cache(self.cfg, self.batch, smax, self.device)
        self._restore(0)
        tok = self.first[0]
        for _ in range(2):
            tok = self._argmax(self._step(self.cfg, self.model, self.cache, tok, mesh=self.mesh))
        self.order = np.random.default_rng(common.derive_seed(self.seed, "order"))
        self.requests: list[dict] = []

    def _argmax(self, logits):
        return logits[:, :self.m["vocab_size"]].argmax(-1, keepdim=True).to(torch.int32)

    def _restore(self, c: int):
        for name, t in self.saved[c].items():
            self.cache[name].copy_(t)

    def window(self, seconds: float, scope):
        steps = 0
        with scope:
            deadline = scope.t0 + seconds
            stop = False
            while not stop:
                c = int(self.order.integers(len(self.saved)))
                with self.rec.span("cache_restore", context=c):
                    self._restore(c)
                req = {"context": c, "tokens": [self.first[c]], "logits": []}
                self.requests.append(req)
                tok = self.first[c]
                for _ in range(self.new):
                    t0 = time.perf_counter()
                    lg = self._step(self.cfg, self.model, self.cache, tok, mesh=self.mesh)
                    tok = self._argmax(lg)
                    t1 = time.perf_counter()
                    self.rec.add_span("decode_step", t0, t1)
                    req["logits"].append(lg)
                    req["tokens"].append(tok)
                    steps += 1
                    if t1 >= deadline:
                        stop = True
                        break
        self.steps = steps
        self.seconds = scope.t1 - scope.t0
        self.attempted = len(self.requests)

    def end_to_end(self) -> dict:
        return {"decode_tokens_per_s": self.batch * self.steps / self.seconds}

    def readings(self, scope):
        contexts = [self.tokens + i + 1 for r in self.requests for i in range(len(r["logits"]))]
        return common.Readings(trace=scope, rec=self.rec, cs=self.cs, facts={
            "steps": self.steps, "batch": self.batch, "model": self.m,
            "contexts": contexts, "window_s": self.seconds,
            "decode_flops": sum(self.ref.decode_step_flops(self.m, self.batch, c)
                                for c in contexts)})

    def release(self):
        self.saved = self.cache = None
        self.free_model()

    def _sample(self) -> list[dict]:
        done = [r for r in self.requests if len(r["logits"]) == self.new] or self.requests[:1]
        rng = np.random.default_rng(common.derive_seed(self.seed, "check"))
        rest = done[1:]
        take = min(len(rest), self.traffic["check_requests"] - 1)
        return done[:1] + [rest[int(i)] for i in rng.choice(len(rest), take, replace=False)]

    def _positions(self, req):
        m = len(req["logits"])
        toks = lm.prompts(self.m, self.seed, f"context{req['context']}", self.batch,
                          self.tokens, self.device)
        fed = torch.cat(req["tokens"][:m], dim=1)  # the tokens the steps were given
        return torch.cat([toks, fed], dim=1), list(range(self.tokens, self.tokens + m))

    def check(self) -> dict:
        v = self.m["vocab_size"]
        weights = self.weights()
        numbers = {"logits_rel_err": 0.0}
        self.checked = self._sample()
        for req in self.checked:
            seq, pos = self._positions(req)
            ref = self.reference(seq, pos, weights=weights)
            got = torch.stack([lg[:, :v].float() for lg in req["logits"]], dim=1)
            numbers["logits_rel_err"] = max(numbers["logits_rel_err"], lm.rel_err(got, ref))
        return numbers

    def control(self, requests) -> dict:
        """The reference in fp8 put in the program's place, at the same
        prompts and served tokens."""
        weights = self.weights()
        numbers = {"logits_rel_err": 0.0}
        for req in requests:
            seq, pos = self._positions(req)
            ref = self.reference(seq, pos, weights=weights)
            got = self.reference(seq, pos, weights=weights, quant="fp8")
            numbers["logits_rel_err"] = max(numbers["logits_rel_err"], lm.rel_err(got, ref))
        return numbers
