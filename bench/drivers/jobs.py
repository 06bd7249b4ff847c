"""Served secure k-means jobs: a closed loop through one SecureJobService.

Set-up draws the cell's datasets on the card from the seed, one of each of
the traffic's `sizes` (the paper's §V recipe: points around k true centres
drawn in [lo, hi]^d, normal spread),
a pool of jobs (a dataset and k initial centres, distinct rows of it drawn
from the seed), and warms the service: for every dataset one job that never
halts, whose chunks 1, 2, 4 and 8 capture every runner a job can use, and
one job as the window runs it. The window keeps `outstanding` jobs
submitted: tenants waiting on their results. Each finished job is replaced
by the next of the pool, in an order drawn from the seed, until the window
closes; the jobs still running then are waited for, and their latency
counts.

The check, once the window has closed: a sample of the window's jobs drawn
from the seed (the one with the most rounds in it) is run again by the
plain Lloyd's k-means from the same data and initial centres, for as many
rounds as the job ran, and the centres, each round's shift and the halting
round are compared; and the ciphertext the timed path left on the wire of
each captured round is decrypted by the benchmark's own ChaCha20 under the
round id of some job's round, and must give that job's plaintext: the keys
of the wire's layout, the counts and the sums of that shard's points. Two
jobs whose round ranges overlap (a keystream used twice) count as wire
faults too.
"""

from __future__ import annotations

import concurrent.futures as cf
import time
from collections import deque

import numpy as np
import torch

from bench import common, wire
from bench.reference import kmeans as ref_kmeans


EAGER_KEPT = 32  # wires run eagerly that the mesh keeps (set-up's, or every round on the CPU)


def bucket(n: int, shards: int) -> int:
    """The service's padded size: its default ladder, doubling from `shards`."""
    b = shards
    while b < n:
        b = max(-(-b * 2 // shards) * shards, b + shards)
    return b


class Cell:
    def __init__(self, cs, *, seed: int, device: str, rec):
        self.cs, self.seed, self.device, self.rec = cs, int(seed), torch.device(device), rec
        self.dep = cs["config"]["deployment"]
        self.traffic = cs["traffic"]
        self.k, self.d, self.shards = self.dep["k"], self.dep["d"], self.dep["shards"]
        self.max_rounds = self.traffic["max_rounds"]
        self.attempted = self.failed = 0
        self.jobs: list[dict] = []
        self.warm_jobs: list[dict] = []

    # -- set-up ---------------------------------------------------------------

    def setup(self):
        from repro_torch.serve.service import SecureJobService

        self.secure = wire.session(self.seed, "session")
        # every wire captured into a CUDA graph (whose buffer each replay
        # refills), and the last EAGER_KEPT run eagerly
        self.captured: list[torch.Tensor] = []
        self.eager: deque = deque(maxlen=EAGER_KEPT)

        def keep(out):
            capturing = out.is_cuda and torch.cuda.is_current_stream_capturing()
            (self.captured.append if capturing else self.eager.append)(out)

        self.mesh = wire.tapped_mesh(self.shards, self.device, keep)
        self.service = SecureJobService(self.mesh, secure=self.secure)
        g = torch.Generator(device=self.device).manual_seed(common.derive_seed(self.seed, "data"))
        lo, hi = self.dep["center_low"], self.dep["center_high"]
        self.data = []
        for n in self.traffic["sizes"]:
            true_c = torch.rand((self.k, self.d), generator=g, device=self.device) * (hi - lo) + lo
            idx = torch.randint(0, self.k, (n,), generator=g, device=self.device)
            noise = torch.randn((n, self.d), generator=g, device=self.device)
            self.data.append((true_c[idx] + noise * self.dep["spread"]).contiguous())
        plan_rng = np.random.default_rng(common.derive_seed(self.seed, "jobs"))
        self.pool = []
        for di, pts in enumerate(self.data):
            for _ in range(self.traffic["inits_per_dataset"]):
                rows = plan_rng.choice(pts.shape[0], self.k, replace=False)
                rows_t = torch.as_tensor(np.sort(rows), device=self.device)
                self.pool.append((di, pts[rows_t].contiguous()))
        self.order_rng = np.random.default_rng(common.derive_seed(self.seed, "order"))
        self._order: list[int] = []
        handles = []
        for di, pts in enumerate(self.data):
            init = self.pool[di * self.traffic["inits_per_dataset"]][1]
            for thr, rounds in ((0.0, self.traffic["warm_rounds"]), (None, self.max_rounds)):
                h = self.service.submit_kmeans(pts, self.k, threshold=thr, max_rounds=rounds,
                                               init_centers=init)
                handles.append((h, di))
        for h, di in handles:
            self.warm_jobs.append({"dataset": di, "handle": h, "result": h.result()})
        self.misses0 = self.service.cache.misses

    def _next_plan(self) -> int:
        if not self._order:
            self._order = list(self.order_rng.permutation(len(self.pool)))
        return int(self._order.pop(0))

    # -- the window -----------------------------------------------------------

    def window(self, seconds: float, scope):
        live: dict = {}

        def submit():
            p = self._next_plan()
            di, init = self.pool[p]
            job = {"plan": p, "dataset": di, "n": int(self.data[di].shape[0]),
                   "t_submit": time.perf_counter()}
            job["handle"] = self.service.submit_kmeans(self.data[di], self.k,
                                                       max_rounds=self.max_rounds,
                                                       init_centers=init)
            live[job["handle"].future] = job
            self.jobs.append(job)

        with scope:
            self.deadline = scope.t0 + seconds
            for _ in range(self.traffic["outstanding"]):
                submit()
            while live:
                done, _ = cf.wait(list(live), return_when=cf.FIRST_COMPLETED)
                for fut in done:
                    job = live.pop(fut)
                    try:
                        job["result"] = fut.result()
                    except Exception as exc:  # a failed job counts against the run
                        job["error"] = repr(exc)
                    job["t_done"] = time.perf_counter()
                    self.rec.add_span("job", job["t_submit"], job["t_done"], n=job["n"])
                    if job["t_done"] < self.deadline:
                        submit()
        self.seconds = seconds
        self.attempted = len(self.jobs)
        self.failed = sum("error" in j for j in self.jobs)
        self.misses = self.service.cache.misses - self.misses0

    def end_to_end(self) -> dict:
        done = [j for j in self.jobs if "result" in j and j["t_done"] <= self.deadline]
        lat = [(j["t_done"] - j["t_submit"]) * 1e3 for j in self.jobs if "t_done" in j]
        return {"kmeans_jobs_per_s": len(done) / self.seconds,
                "kmeans_job_ms_p95": common.quantile(lat, 0.95)}

    def readings(self, scope):
        ok = [j for j in self.jobs if "result" in j]
        return common.Readings(trace=scope, rec=self.rec, cs=self.cs, facts={
            "k": self.k, "d": self.d, "shards": self.shards,
            "queue_s": [j["handle"].queue_s for j in ok],
            "rounds": [(j["n"], int(j["result"]["n_iter"])) for j in ok],
            "runner_misses": self.misses})

    def release(self):
        """Decrypt the wires the window left (`_wire_faults`), then run each
        sampled job again, stopped after each of its rounds in turn
        (max_rounds = 1, 2, ..., n_iter), through the same service: the
        program's centres after every round, which the check follows step
        by step. Then the service closes and its runners are freed."""
        self.wire_faults = self._wire_faults()  # before the runs below refill the wires
        ok = [j for j in self.jobs if "result" in j]
        self.checked, self.steps, self.replay_faults = [], {}, 0
        if ok:
            longest = max(ok, key=lambda j: (int(j["result"]["n_iter"]), j["n"]))
            rng = np.random.default_rng(common.derive_seed(self.seed, "check"))
            plans = sorted({j["plan"] for j in ok} - {longest["plan"]})
            take = min(len(plans), self.traffic["check_jobs"] - 1)
            self.checked = [longest["plan"]] + [int(p) for p in
                                                rng.choice(plans, take, replace=False)]
            by_plan = {j["plan"]: j for j in ok}
            runs = {}
            for p in self.checked:
                di, init = self.pool[p]
                for r in range(1, int(by_plan[p]["result"]["n_iter"]) + 1):
                    runs[p, r] = self.service.submit_kmeans(self.data[di], self.k,
                                                            max_rounds=r, init_centers=init)
            for p in self.checked:
                res = by_plan[p]["result"]
                n = int(res["n_iter"])
                seq = [torch.as_tensor(runs[p, r].result()["centers"]) for r in range(1, n + 1)]
                self.replay_faults += int(not np.array_equal(seq[-1].numpy(), res["centers"]))
                self.steps[p] = (seq, bool(res["halted"]))
        self.service.close()
        self.service.cache.clear()
        self.service = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------------

    def check(self) -> dict:
        numbers = {"wire_faults": float(self.wire_faults), "centers_step_gap": 0.0,
                   "job_faults": float(self.replay_faults)}
        for p in self.checked:
            di, init = self.pool[p]
            seq, halted = self.steps[p]
            gap, halt_ok = step_check(seq, halted, self.data[di], init, self.max_rounds)
            numbers["centers_step_gap"] = max(numbers["centers_step_gap"], gap)
            numbers["job_faults"] += float(not halt_ok)
        return numbers

    def control(self, plans) -> dict:
        """The reference in TF32 put in the program's place, judged alike."""
        worst = 0.0
        for p in plans:
            di, init = self.pool[p]
            pts = self.data[di]
            thr = ref_kmeans.paper_threshold(pts)
            history, _, _, n = ref_kmeans.fit(pts, init, threshold=thr,
                                              max_rounds=self.max_rounds, precision="tf32")
            gap, _ = step_check(history[:n], n < self.max_rounds, pts, init, self.max_rounds)
            worst = max(worst, gap)
        return {"centers_step_gap": worst}

    def _wire_faults(self) -> int:
        """Wires that decrypt under some job's round id to a plaintext that is
        not that job's; buckets of the window's jobs with no wire that
        decrypts under one of their rounds; and jobs whose reserved round
        range [round_base, round_base + max_rounds) overlaps an earlier
        job's. A wire that decrypts under no round is passed over: captures
        share a memory pool, and a later capture may take an earlier one's
        wire for its own scratch."""
        jobs = [(j, False) for j in self.warm_jobs] + [(j, True) for j in self.jobs
                                                       if "result" in j]
        rounds, owner = [], []
        for job, in_window in jobs:
            base = job["handle"].round_base
            for r in range(base, base + int(job["result"]["n_iter"])):
                rounds.append(r)
                owner.append((job, in_window))
        faults, seen = overlapping_ranges([j["handle"] for j, _ in jobs]), set()
        for out in self.captured + list(self.eager):
            words = out.reshape(self.shards * self.shards, -1)
            hit = self._match_round(words, rounds)
            if hit is None:
                continue
            job, in_window = owner[hit]
            if not self._plaintext_ok(words, rounds[hit], self.data[job["dataset"]]):
                faults += 1
            elif in_window:
                seen.add(job["handle"].bucket)
        return faults + len({j["handle"].bucket for j, w in jobs if w} - seen)

    def _keystream(self, rounds, leaf):
        """Keystream words (len(rounds), S*S, words) of one leaf of the wire."""
        _, words, first, blocks = leaf
        return wire.keystream(self.secure, self.shards, rounds, first, blocks, blocks,
                              self.device)[..., :words]

    def _layout(self):
        """[(word start, words, counter offset, blocks)] of leaves k, c, s."""
        s = self.shards
        c = -(-self.k // s)
        out, word, ctr = [], 0, 0
        for words in (c, c, c * self.d):
            blocks = -(-words // 16)
            out.append((word, words, ctr, blocks))
            word += words
            ctr += blocks * s
        return out

    def _expected_keys(self):
        s, c = self.shards, -(-self.k // self.shards)
        i = torch.arange(s, device=self.device).repeat_interleave(s)[:, None]
        keys = i + s * torch.arange(c, device=self.device)[None, :]
        return torch.where(keys < self.k, keys, -1).to(torch.int32)

    def _match_round(self, words, rounds):
        leaf = self._layout()[0]
        w0, nw = leaf[:2]
        want = self._expected_keys()
        for lo in range(0, len(rounds), 256):
            ks = self._keystream(rounds[lo:lo + 256], leaf)
            ok = ((words[None, :, w0:w0 + nw] ^ ks) == want[None]).all(-1).all(-1)
            hits = torch.nonzero(ok).reshape(-1)
            if hits.numel():
                return lo + int(hits[-1])
        return None

    def _plaintext_ok(self, words, round_id, pts) -> bool:
        s, n = self.shards, pts.shape[0]
        plain = []
        for leaf in self._layout():
            w0, nw = leaf[:2]
            plain.append(words[:, w0:w0 + nw] ^ self._keystream([round_id], leaf)[0])
        counts = plain[1].view(torch.float32).reshape(s, s, -1)  # (dest i, src j, slot)
        sums = plain[2].view(torch.float32).reshape(s, s, -1, self.d)
        per = bucket(n, s) // s
        for j in range(s):
            rows = pts[j * per:min((j + 1) * per, n)]
            if float(counts[:, j].double().sum()) != float(rows.shape[0]):
                return False
            got = sums[:, j].double().sum(dim=(0, 1))
            want = rows.double().sum(0)
            tol = 1e-4 * rows.double().abs().sum(0) + 1e-3
            if not bool(((got - want).abs() <= tol).all()):
                return False
        return True


def overlapping_ranges(handles) -> int:
    """Jobs whose reserved rounds [round_base, round_base + max_rounds)
    begin before an earlier-starting job's have ended: rounds whose
    keystream two jobs would share."""
    spans = sorted((h.round_base, h.round_base + h.max_rounds) for h in handles)
    overlaps, end = 0, None
    for lo, hi in spans:
        if end is not None and lo < end:
            overlaps += 1
        end = hi if end is None else max(end, hi)
    return overlaps


HALT_BAND = 0.25  # a shift within this share of the threshold may halt either way


def step_check(seq, halted: bool, pts, init, max_rounds: int):
    """Follow a job step by step from its own state: each of its rounds
    against one reference round from the centres the job held before it
    (the first from the initial centres). Returns (the largest step's
    displacement, root mean square over the points, each centre weighted by
    the points the reference gives it; whether the reference's one-round
    shifts agree with where the job halted, to within HALT_BAND of the
    threshold)."""
    thr = ref_kmeans.paper_threshold(pts)
    gap, shifts = 0.0, []
    prev = init.float()
    for got in seq:
        prev = prev.to(pts.device)
        with ref_kmeans._tf32_off():
            want, shift, weight = ref_kmeans.lloyd_round(pts, prev)
        d2 = ((got.to(pts.device).double() - want.double()) ** 2).sum(-1)
        gap = max(gap, float(torch.sqrt((d2 * weight).sum() / weight.sum())))
        shifts.append(shift)
        prev = got.float()
    s = np.asarray(shifts)
    n = len(seq)
    halt_ok = (s[n - 1] < thr * (1 + HALT_BAND)) if halted else n == max_rounds
    halt_ok &= n == 1 or bool(s[:n - 1].min() >= thr * (1 - HALT_BAND))
    return gap, bool(halt_ok)
