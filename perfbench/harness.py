"""One run of one cell: set-up, the measured window, the metrics and the
comparison with the plain reference.

Set-up makes the weights on the device from the seed (``weights.py``),
builds ``repro_torch.runtime.engine.InferenceEngine`` (trace, plan,
state buffer, CUDA graph capture), serves two short warm-up requests
through admission and blocks and, for a closed loop, admits the
clients' first requests. The window then drives the engine through its
public calls only: ``submit`` and ``step_block`` (block decode,
on-device greedy sampling), with the traffic of ``traffic.py``. Between
``step_block`` calls the harness stamps each request's new tokens with
the host clock: that is when a client would receive them.

A traced run (``--trace 1``) also profiles a slice of the window
(``trace_seconds`` of the mix, in its middle) and logs every decode call
the engine makes (positions, active slots, block budgets) by wrapping
the state backend's ``decode`` and ``decode_block``; an untraced run
wraps nothing.

After the window the engine is freed and the reference (``reference.py``,
fp32) runs over a sample of the finished requests, drawn from the seed
with the longest among them: each prompt with its served tokens, teacher
forced. The number compared is the widest gap by which a served token's
reference logit lies below the reference's best at that position. With
``control`` the same comparison also judges the control: the reference
in float8 e4m3 (W8A8) put in the program's place, its greedy tokens
standing where the served ones stood.
"""

from __future__ import annotations

import bisect
import dataclasses
import gc
import os
import sys
import time

import numpy as np

from perfbench import flops, peaks, reference, spec, trace, traffic, weights


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def process_age_s() -> float | None:
    """Seconds since this process started (Linux), or None."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def arch_config(cfg_file: dict):
    """The port's ``ArchConfig`` of a configuration file's ``repro_arch``."""
    from repro_torch.configs.base import ArchConfig, LayerSpec

    a = dict(cfg_file["repro_arch"])
    a["period"] = tuple(LayerSpec(**s) for s in a["period"])
    a["remainder"] = tuple(LayerSpec(**s) for s in a.get("remainder", []))
    a.setdefault("source", cfg_file.get("source", ""))
    return ArchConfig(**a)


@dataclasses.dataclass
class Rec:
    """What the client side saw of one request."""

    offer: traffic.Offer
    due: float | None = None  # host clock (s)
    admit_call: float | None = None  # start of the step_block that admitted it
    times: list = dataclasses.field(default_factory=list)  # one per token
    done: float | None = None
    tokens: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Window:
    t0: float
    end: float
    recs: dict  # rid -> Rec
    offers: list  # open loop: every request due in the window
    decode_calls: int  # decode steps completed in the window
    steps_log: list  # (kind, pos, active, budget, length) of the window's calls
    trace: dict | None


class StepLog:
    """Wraps the state backend's ``decode`` and ``decode_block`` to log
    each call's host-side inputs and its host clock (``at``, ns; traced
    runs only)."""

    def __init__(self, state):
        self.calls: list = []
        self.at: list[int] = []
        dec, blk = state.decode, state.decode_block

        def decode(tokens, pos, active):
            self.at.append(time.monotonic_ns())
            self.calls.append(("step", np.array(pos), np.array(active), None, 1))
            return dec(tokens, pos, active)

        def decode_block(tokens, pos, active, budget, eos, *, length):
            self.at.append(time.monotonic_ns())
            self.calls.append(("block", np.array(pos), np.array(active),
                               np.array(budget), int(length)))
            return blk(tokens, pos, active, budget, eos, length=length)

        state.decode, state.decode_block = decode, decode_block


def expand(calls: list):
    """Per decode step: (positions every row reads, rows that carry a
    token). A block wave j reads position pos + min(j, budget) on an
    active row; an inactive row stays where it is."""
    for kind, pos, active, budget, length in calls:
        pos = pos.astype(np.int64)
        if kind == "step":
            yield pos, active.astype(bool)
            continue
        for j in range(length):
            live = active & (j < budget)
            yield pos + np.where(active, np.minimum(j, budget), 0), live


class Server:
    """The engine and the client-side bookkeeping around it."""

    def __init__(self, engine):
        self.engine = engine
        self.recs: dict[int, Rec] = {}
        self.inflight: set[int] = set()
        self.finished: list[Rec] = []

    def submit(self, offer: traffic.Offer, now: float, due: float | None) -> None:
        rid = self.engine.submit(offer.prompt, max_new_tokens=offer.max_new)
        self.recs[rid] = Rec(offer, due=due if due is not None else now)
        self.inflight.add(rid)

    def step(self) -> list[Rec]:
        """One ``step_block``; stamps the new tokens; returns the requests
        that finished."""
        call = time.monotonic()
        fin = self.engine.step_block()
        now = time.monotonic()
        done = []
        for r in fin + self.engine.unfinished_requests():
            rec = self.recs.get(r.request_id)
            if rec is None:
                continue
            new = len(r.tokens) - len(rec.times)
            if new > 0:
                rec.times.extend([now] * new)
            if rec.admit_call is None and r.admitted_wave >= 0:
                rec.admit_call = call
        for r in fin:
            rec = self.recs.get(r.request_id)
            if rec is None:
                continue
            rec.done, rec.tokens = now, list(r.tokens)
            self.inflight.discard(r.request_id)
            self.finished.append(rec)
            done.append(rec)
        return done


def build_engine(cell: spec.Cell, params: dict, device):
    from repro_torch.runtime.engine import InferenceEngine

    mix = cell.traffic
    return InferenceEngine(
        arch_config(cell.config), params, n_slots=int(mix["n_slots"]),
        max_len=int(mix["max_len"]), device=device, greedy=True, sample_seed=0,
        eos_id=None, block_size=int(mix["block_size"]))


def warm_up(server: Server, seed: int, vocab: int) -> None:
    """Two short requests through admission and blocks of 8 and 2 waves
    (not part of the window: the harness keeps no record of them)."""
    eng = server.engine
    for offer in traffic.warmup_offers(seed, vocab, n=2, prompt_len=3, max_new=10):
        eng.submit(offer.prompt, max_new_tokens=offer.max_new)
    while eng.unfinished_requests():
        eng.step_block()


def serve_window(server: Server, cell: spec.Cell, seed: int, seconds: float,
                 traced: bool, step_log: StepLog | None) -> Window:
    """The measured window: offer the traffic, drive ``step_block``."""
    import torch

    mix, vocab = cell.traffic, int(cell.config["repro_arch"]["vocab"])
    eng = server.engine
    open_loop = mix["loop"] == "open"
    offers: list = []
    if open_loop:
        offers = traffic.open_loop(mix, seed, seconds, vocab)
    else:
        loop = traffic.ClosedLoop(mix, seed, vocab)
        # the clients' first requests, admitted in set-up
        for _ in range(loop.clients):
            server.submit(loop.next(), time.monotonic(), None)
        server.step()
    prof, trace_at, trace_len = None, None, None
    traced = traced and eng.device.type == "cuda"  # the profiled slice
    if traced:
        trace_len = min(float(mix.get("trace_seconds", seconds)), seconds)
        trace_at = (seconds - trace_len) / 2
    tr: dict | None = None
    nxt = 0
    calls_at_end = eng.decode_calls
    log_at = len(step_log.calls) if step_log else 0
    log_end = log_at
    t0 = time.monotonic()
    end = t0 + seconds
    calls0 = eng.decode_calls
    spans: list[tuple[str, int, int]] = []
    while True:
        now = time.monotonic()
        if now >= end:
            break
        if traced and prof is None and tr is None and now >= t0 + trace_at:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
            mark_ns = time.monotonic_ns()
            with torch.profiler.record_function(trace.MARK):
                pass
            tr = {"t0": time.monotonic(), "log0": len(step_log.calls),
                  "mark_ns": mark_ns}
        elif prof is not None and now >= tr["t0"] + trace_len:
            torch.cuda.synchronize()
            tr.update(t1=time.monotonic(), log1=len(step_log.calls))
            prof.stop()
            tr["prof"], prof = prof, None
        if open_loop:
            while nxt < len(offers) and t0 + offers[nxt].due_s <= now:
                server.submit(offers[nxt], now, t0 + offers[nxt].due_s)
                nxt += 1
        if server.inflight:
            a = time.monotonic_ns()
            done = server.step()
            b = time.monotonic_ns()
            spans.append(("step_block", a, b))
            if time.monotonic() <= end:
                calls_at_end = eng.decode_calls
                log_end = len(step_log.calls) if step_log else 0
            if not open_loop:
                for rec in done:
                    server.submit(loop.next(), rec.done, rec.done)
        else:
            wake = min(t0 + offers[nxt].due_s if nxt < len(offers) else end, end)
            a = time.monotonic_ns()
            time.sleep(max(wake - time.monotonic(), 0.0))
            spans.append(("waiting for a request", a, time.monotonic_ns()))
    if prof is not None:  # the window ended inside the slice
        torch.cuda.synchronize()
        tr.update(t1=time.monotonic(), log1=len(step_log.calls))
        prof.stop()
        tr["prof"] = prof
    if tr is not None:
        tr["spans"] = spans
    return Window(t0=t0, end=end, recs=server.recs, offers=offers,
                  decode_calls=calls_at_end - calls0,
                  steps_log=step_log.calls[log_at:log_end] if step_log else [],
                  trace=tr)


# ------------------------------------------------------------ end to end


def end_to_end(win: Window, open_loop: bool) -> dict:
    """The client-side numbers of the window."""
    t0, end = win.t0, win.end
    tokens, gaps, ttft = 0, [], []
    for rec in win.recs.values():
        prev = None
        for t in rec.times:
            if t0 < t <= end:
                tokens += 1
                if prev is not None:
                    gaps.append(t - prev)
            prev = t
    # every request due in the window; one with no token by the end (or
    # not yet sent) counts the end
    by_offer = {rec.offer.index: rec for rec in win.recs.values()}
    for offer in win.offers:
        rec = by_offer.get(offer.index)
        due = t0 + offer.due_s
        first = rec.times[0] if rec and rec.times and rec.times[0] <= end else end
        ttft.append(first - due)
    out = {"tokens": tokens, "tokens_per_s": tokens / (end - t0),
           "itl_p95_ms": float(np.percentile(gaps, 95)) * 1e3 if gaps else None,
           "gaps": len(gaps)}
    if open_loop:
        out["ttft_mean_ms"] = float(np.mean(ttft)) * 1e3 if ttft else None
        out["ttfts"] = ttft
        out["due"] = len(ttft)
    return out


@dataclasses.dataclass
class RunRecord:
    """What the per-layer readers (``metrics/<name>.py``) read."""

    window_s: float
    tokens_out: int
    n_slots: int
    decode_calls: int
    planned_bytes: int
    model_flops: float | None
    peak_flops: float
    trace: dict | None  # window_s, busy_s, device_s, decode_calls, fd_s, fd_bound_s


def waves_of(call: tuple) -> int:
    """Decode steps (waves) of one logged call."""
    return 1 if call[0] == "step" else int(call[4])


def covered(spans: list, at: list, waves: list, fd_starts: list, per_wave: int
            ) -> tuple[int, int] | None:
    """The stretch of consecutive harness spans (label, start, end) with
    the most waves whose ``flash_decode`` launches the trace holds, all
    of them. A span's device work ends before the span does
    (``step_block`` returns on a host sync), so the spans from the i-th
    to the j-th, each taken from its start to the next one's, hold
    ``per_wave`` launches for each wave of the calls logged in them
    (``at``, ``waves``) when the running count of launches less the
    expected one reads the same at both ends. A launch that the two
    clocks put into the next span keeps the count; a stretch of device
    records that the profiler lost lowers it for good. Returns (start,
    end) or None where no stretch holds a wave. One clock, ns."""
    if not spans:
        return None
    bounds = [a for _, a, _ in spans] + [spans[-1][2]]
    excess, done = [0], [0]
    for lo, hi in zip(bounds, bounds[1:]):
        n = sum(w for t, w in zip(at, waves) if lo <= t < hi)
        got = bisect.bisect_left(fd_starts, hi) - bisect.bisect_left(fd_starts, lo)
        excess.append(excess[-1] + got - per_wave * n)
        done.append(done[-1] + n)
    first: dict[int, int] = {}
    best, most = None, 0
    for k, d in enumerate(excess):
        i = first.setdefault(d, k)
        if done[k] - done[i] > most:
            best, most = (bounds[i], bounds[k]), done[k] - done[i]
    return best


def slice_numbers(win: Window, cell: spec.Cell, card: peaks.Card) -> dict | None:
    """The per-layer numbers of the profiled slice, over the longest
    stretch of it whose device records the trace holds in full
    (``covered``); None where it holds none."""
    tr = win.trace
    if tr is None or "prof" not in tr:
        return None
    evs, marks = trace.events(tr["prof"])
    offset = marks.get(trace.MARK, tr["mark_ns"]) - tr["mark_ns"]
    t0 = int(tr["t0"] * 1e9) + offset
    t1 = int(tr["t1"] * 1e9) + offset
    # the harness's spans and calls of the slice, on the trace's clock
    # (monotonic_ns and monotonic agree)
    spans = [(lab, a + offset, b + offset) for lab, a, b in tr["spans"]
             if a + offset >= t0 and b + offset <= t1]
    calls = tr["calls"][tr["log0"]:tr["log1"]]
    at = [t + offset for t in tr["at"][tr["log0"]:tr["log1"]]]
    a = cell.config["repro_arch"]
    layers = flops.attention_layers(a)
    fd_starts = sorted(e.start_ns for e in evs if "flash_decode" in e.name)
    span = covered(spans, at, [waves_of(c) for c in calls], fd_starts, len(layers))
    if span is None:
        log(f"perfbench: the trace holds no span of the slice in full "
            f"({len(fd_starts)} flash_decode records)")
        return None
    lo, hi = span
    evs = [e for e in evs if e.end_ns > lo and e.start_ns < hi]
    busy = trace.busy_intervals(evs, lo, hi)
    gaps = trace.idle_gaps(busy, lo, hi)
    fd = [e for e in evs if "flash_decode" in e.name]
    calls = [c for c, t in zip(calls, at) if lo <= t <= hi]
    T = int(cell.traffic["max_len"])
    bound = 0.0
    for pos, _ in expand(calls):
        sum_len = int(np.minimum(pos + 1, T).sum())
        for KV, G, D in layers:
            bound += peaks.flash_decode_bound_s(len(pos), KV, G, D, sum_len,
                                                a["dtype"], card)
    return {
        "window_s": (hi - lo) / 1e9,
        "slice_s": (t1 - t0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "device_s": sum(e.end_ns - e.start_ns for e in evs) / 1e9,
        "device_events": len(evs),
        "decode_calls": sum(waves_of(c) for c in calls),
        "fd_s": sum(e.end_ns - e.start_ns for e in fd) / 1e9,
        "fd_launches": len(fd),
        "fd_bound_s": bound,
        "breakdown": {"device_ops": trace.top_ops(evs),
                      "idle_gaps": trace.label_gaps(gaps, spans)},
    }


def model_flops(calls: list, a: dict) -> float:
    """The model FLOPs of every token the logged decode steps carried
    (``token_flops`` is linear in the positions read)."""
    c0 = flops.token_flops(a, 0)
    c1 = flops.token_flops(a, 1) - c0
    total = 0.0
    for pos, live in expand(calls):
        total += float(live.sum()) * c0 + c1 * float((pos[live] + 1).sum())
    return total


# ------------------------------------------------------------ correctness


def sample(recs: list[Rec], seed: int, n: int = 32, max_tokens: int = 16384
           ) -> list[Rec]:
    """The longest finished request (by prompt + served tokens) and others
    drawn from the seed, up to ``n`` requests and ``max_tokens`` served
    tokens. Each request is a fresh trajectory from a random prompt, so
    the sample is as wide as the window's finished requests allow."""
    if not recs:
        return []
    order = sorted(recs, key=lambda r: (-(len(r.offer.prompt) + len(r.tokens)),
                                        r.offer.index))
    rest = order[1:]
    rng = traffic.rng_for(seed, 4)
    chosen, total = [order[0]], len(order[0].tokens)
    for i in rng.permutation(len(rest)):
        r = rest[int(i)]
        if len(chosen) >= n or total + len(r.tokens) > max_tokens:
            break
        chosen.append(r)
        total += len(r.tokens)
    return chosen


def gaps(params: dict, a: dict, recs: list[Rec], device, control: bool = False
         ) -> dict:
    """How far the served tokens lie below the reference's best: the
    widest gap (logits) and the mean gap over every served token. With
    ``control`` also ``"control"``: the same numbers for the tokens the
    fp8 reference puts first, in the served tokens' place."""
    import torch

    seqs, pos, served = [], [], []
    for r in recs:
        p, o = r.offer.prompt, np.asarray(r.tokens, np.int64)
        seqs.append(torch.as_tensor(np.concatenate([p, o[:-1]]), device=device))
        pos.append(list(range(len(p) - 1, len(p) - 1 + len(o))))
        served.append(torch.as_tensor(o, device=device))
    ref = reference.logits(params, a, seqs, pos, "fp32")

    def shortfall(picks):
        per = [lg.max(-1).values - lg.gather(1, t[:, None])[:, 0]
               for lg, t in zip(ref, picks)]
        flat = torch.cat(per)
        return {"widest": float(flat.max()), "mean": float(flat.mean()),
                "per_request": [float(g.max()) for g in per],
                "per_request_mean": [float(g.mean()) for g in per],
                "agree": float((flat == 0).float().mean())}

    def numbers(picks):
        s = shortfall(picks)
        return {"widest_gap": s["widest"], "mean_gap": s["mean"],
                "per_request": s["per_request"],
                "per_request_mean": s["per_request_mean"],
                "tokens": sum(len(t) for t in picks), "argmax_agree": s["agree"]}

    out = numbers(served)
    if control:
        ctl = reference.logits(params, a, seqs, pos, "fp8")
        out["control"] = numbers([c.argmax(-1) for c in ctl])
    return out


# the numbers compared, by their key in a cell's limits file
COMPARED = {"max_logit_gap": ("widest_gap", "per_request"),
            "mean_logit_gap": ("mean_gap", "per_request_mean")}


def judge(g: dict | None, limits: dict, finished: int) -> tuple[bool, dict, int]:
    """``correct``, each number compared beside its limit, and how many
    compared requests broke a limit, from ``gaps`` numbers (``None``
    where nothing finished)."""
    checks = {"finished_requests": {"value": finished, "limit": 1,
                                    "rule": "value >= limit"}}
    correct, bad = g is not None, set()
    for key, (number, per_request) in COMPARED.items():
        if g is None or key not in limits:
            continue
        limit = float(limits[key])
        checks[key] = {"value": g[number], "limit": limit, "rule": "value <= limit"}
        correct = correct and g[number] <= limit
        bad |= {i for i, v in enumerate(g[per_request]) if v > limit}
    return correct, checks, len(bad)


# ------------------------------------------------------------ one run


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, *,
             device=None, params: dict | None = None, control: bool = False,
             t_start: float | None = None) -> dict:
    """One run. Returns the result line's fields plus ``checks``, an
    ``extra`` dict of what is printed on standard error and, with
    ``control``, the control's ``correct``, ``failed`` and ``checks``
    (else ``None``)."""
    import torch

    device = torch.device(device or "cuda")
    cuda = device.type == "cuda"
    age0 = process_age_s()
    t_start = time.monotonic() - (age0 or 0.0) if t_start is None else t_start
    a = cell.config["repro_arch"]
    mix = cell.traffic
    open_loop = mix["loop"] == "open"

    marks = {"start": time.monotonic() - t_start}
    if params is None:
        params = weights.make(a, traffic.seed64(seed, 0), device)
    else:
        weights.fill(params, a, traffic.seed64(seed, 0))
    if cuda:
        torch.cuda.synchronize(device)
    marks["weights"] = time.monotonic() - t_start
    if cuda:
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        readings = [torch.cuda.max_memory_allocated(device)]
    engine = build_engine(cell, params, device)
    if cuda:
        readings.append(torch.cuda.max_memory_allocated(device))
        peak_built = readings[-1]
    marks["engine"] = time.monotonic() - t_start
    server = Server(engine)
    step_log = StepLog(engine.state) if traced else None
    warm_up(server, seed, int(a["vocab"]))
    marks["warm_up"] = time.monotonic() - t_start
    if traced and cuda:
        # the profiler's first start loads CUPTI: pay that in set-up
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.cuda.synchronize(device)
    if step_log is not None:
        step_log.calls.clear()
        step_log.at.clear()
    win = serve_window(server, cell, seed, seconds, traced, step_log)
    if win.trace is not None:
        win.trace["calls"], win.trace["at"] = step_log.calls, step_log.at
    setup_s = win.t0 - t_start
    e2e = end_to_end(win, open_loop)
    if cuda:
        torch.cuda.synchronize(device)
        readings.append(torch.cuda.max_memory_allocated(device))
        serve_mem = max(peak_built, readings[-1]) - base
        memory_peak = max(readings)
        card = peaks.card(torch.cuda.get_device_name(device))
    else:
        serve_mem, memory_peak, card = None, None, peaks.card("H100")
    mr = engine.memory_report
    planned = mr.activation_plan.total_size + mr.state_plan.total_size
    n_slots = engine.n_slots
    engine_report = {"trace_s": mr.trace_s, "capture_s": mr.capture_s,
                     "state_plan_s": mr.state_plan_s,
                     "activation_bytes": mr.activation_plan.total_size,
                     "state_bytes": mr.state_plan.total_size,
                     "graph_pool_bytes": mr.graph_pool_bytes}
    finished = [r for r in server.finished if r.tokens]
    # every request due in the window (open loop) or sent (closed loop)
    attempted = max(len(server.recs), len(win.offers))
    # ---- the per-layer numbers (traced runs)
    per_layer = {}
    sl = None
    if traced:
        sl = slice_numbers(win, cell, card) if cuda else None
        rr = RunRecord(
            window_s=win.end - win.t0, tokens_out=e2e["tokens"], n_slots=n_slots,
            decode_calls=win.decode_calls,
            planned_bytes=planned, model_flops=model_flops(win.steps_log, a),
            peak_flops=card.bf16_flops, trace=sl)
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(rr)
            if v is not None:
                per_layer[m["name"]] = {"value": v, "unit": m["unit"]}
    # ---- free the program's state, then the reference
    del server, engine, step_log
    win.trace = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.monotonic()
    chosen = sample(finished, seed)
    g = gaps(params, a, chosen, device, control=control) if chosen else None
    correct, checks, failed = judge(g, cell.limits, len(finished))
    ref_s = time.monotonic() - t_ref

    metrics = {}
    if not traced:
        vals = {"tokens_per_s": e2e["tokens_per_s"], "itl_p95_ms": e2e["itl_p95_ms"],
                "ttft_mean_ms": e2e.get("ttft_mean_ms"),
                "serve_mem_mib": None if serve_mem is None else serve_mem / 2**20,
                "setup_s": setup_s}
        for m in cell.end_to_end:
            if vals.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": vals[m["name"]], "unit": m["unit"]}
    else:
        metrics = per_layer
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced and sl is not None:
        dev["busy_s"] = sl["busy_s"]
        dev["window_s"] = sl["window_s"]
        result["breakdown"] = sl["breakdown"]
    result["checks"] = checks
    marks["window"] = setup_s
    ctl = None
    if g is not None and "control" in g:
        c_ok, c_checks, c_failed = judge(g["control"], cell.limits, len(finished))
        ctl = {"correct": c_ok, "failed": c_failed, "checks": c_checks}
    extra = {"setup_s": setup_s, "setup_marks_s": marks,
             "engine_report": engine_report, "reference_s": ref_s, "e2e": {
        k: v for k, v in e2e.items() if k != "ttfts"},
        "decode_calls": win.decode_calls, "finished": len(finished),
        "sampled": [(r.offer.index, len(r.offer.prompt), len(r.tokens)) for r in chosen],
        "gaps": g, "serve_mem_bytes": serve_mem, "planned_bytes": planned,
        "weights_bytes": weights.nbytes(params),
        "slice": None if sl is None else {k: v for k, v in sl.items()
                                          if k != "breakdown"}}
    return {"result": result, "extra": extra, "control": ctl}
