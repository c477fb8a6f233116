"""Serving cells: ``ContinuousBatchingEngine.submit`` / ``.step`` under a
closed loop of clients (:class:`portbench.generate.ClosedLoop`).

Set-up makes the weights from the seed on the device, builds the engine,
runs the warm-up requests (every prefill chunk size; the shared prefixes
and documents into the prefix cache), then sends every client's first
request and steps until none is queued or prefilling.  The window then
steps the engine for ``--seconds``; after each step the benchmark looks at
every request in flight, stamps the tokens that appeared with its own
clock, and sends a finished client's next request at once.  Afterwards
the program is freed and the reference judges a sample of the requests
the window finished (:mod:`portbench.check_serve`).

With ``--trace 1`` the last ``trace_seconds`` of the window run under the
profiler, and two calls into the port are wrapped from here for the whole
window, to count the work the metrics divide: each decode call (the
positions of the decoding slots) and each prefill chunk (its base and
length).
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import time
from typing import Dict, List

from torch.profiler import record_function

from portbench import check_serve, families, generate, weights
from portbench.harness import log
from portbench.trace import Tracer


@dataclasses.dataclass
class Client:
    cid: int
    req: object = None
    sent_t: float = 0.0
    seen: int = 0
    last_t: float = 0.0
    admitted: bool = False


@dataclasses.dataclass
class Obs:
    """What one serving run saw; the metric readers read it."""
    kind: str
    cfg: object
    traffic: Dict
    setup_s: float
    window_s: float
    tokens: int
    itl_s: List[float]
    ttft_s: List[float]
    finished: int
    failed: int
    stats0: object
    stats1: object
    prompt_tokens_admitted: int
    decode_calls: List[List[int]]          # trace: positions a decode call
    prefill_chunks: List[tuple]            # trace: (base, length) a chunk
    traced_decode_calls: List[List[int]]
    traced_prefill_chunks: List[tuple]
    trace: object
    memory_peak_bytes: int
    checks: List[tuple]
    block_size: int = 16


def run(spec, seed: int, seconds: float, trace: bool, device, t0: float,
        control: bool = False, fault=None) -> Obs:
    import torch
    from repro_torch.models import model as model_lib
    from repro_torch.runtime.serve_loop import ContinuousBatchingEngine, Request

    conf, traffic = spec.config, spec.traffic
    fam = families.for_config(conf)
    d = fam.dims(conf)
    cfg = fam.port_config(conf, d)
    port = conf["port"]
    dev = torch.device(device)
    params = weights.make_params(d, seed, dev, getattr(torch, d.dtype))
    engine = ContinuousBatchingEngine(
        cfg, params, slots=traffic["slots"], max_len=traffic["max_len"],
        prefix_blocks=traffic["prefix_blocks"], block_size=port["block_size"],
        kv_layout=port["kv_layout"], prefill_chunk=traffic["prefill_chunk"],
        decode_horizon=port["decode_horizon"], decode_impl=port["decode_impl"],
        prefill_kernel=port["prefill_kernel"], spec_draft=port["spec_draft"],
        page_budget=traffic["page_budget"], device=dev)
    del params
    if fault is not None:
        fault(engine)
    gen = generate.ClosedLoop(traffic, d.vocab_size, seed)
    rid = [0]

    def request(prompt, n):
        rid[0] += 1
        return Request(rid=rid[0], prompt=prompt, max_new_tokens=int(n))

    for prompt, n in gen.warmup(traffic["prefill_chunk"]):
        engine.submit(request(prompt, n))
    engine.run()
    tracer = Tracer(dev) if trace else None
    if tracer is not None:
        tracer.warm()

    clients = [Client(c) for c in range(gen.clients)]
    inflight: Dict[int, Client] = {}
    rec = dict(tokens=0, itl=[], ttft=[], finished=[], failed=0, admitted=0,
               in_window=False, open=True)

    def send(c: Client, now: float) -> None:
        prompt, n = gen.next_request(c.cid)
        c.req = request(prompt, n)
        c.sent_t, c.seen, c.last_t = now, 0, now
        c.admitted = False
        inflight[c.cid] = c
        engine.submit(c.req)

    def observe(now: float) -> None:
        win = rec["in_window"]
        for c in list(inflight.values()):
            r = c.req
            if not c.admitted and r.status != "queued":
                c.admitted = True
                if win:
                    rec["admitted"] += len(r.prompt)
            n = len(r.out)
            if n > c.seen:
                if win:
                    if c.seen == 0:
                        rec["ttft"].append(now - c.sent_t)
                    else:
                        rec["itl"].append(now - c.last_t)
                    rec["itl"].extend([0.0] * (n - c.seen - 1))
                    rec["tokens"] += n - c.seen
                c.seen, c.last_t = n, now
            if r.status in ("done", "failed"):
                del inflight[c.cid]
                if win:
                    if r.status == "done":
                        rec["finished"].append(r)
                    else:
                        rec["failed"] += 1
                if rec["open"]:
                    send(c, now)

    now = time.perf_counter()
    for c in clients:
        send(c, now)
    while engine.queue or any(s.prefilling for s in engine.slots):
        engine.step()
        observe(time.perf_counter())

    work = _Work(engine, model_lib) if trace else None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stats0 = copy.deepcopy(engine.stats)
    t_start = time.perf_counter()
    setup_s = t_start - t0
    rec["in_window"] = True
    t_end = t_start + seconds
    # the trace covers the window's last ``trace_seconds``: the profiler's
    # stop and the reading of its records come after the window closes
    t_trace = t_end - min(float(traffic["trace_seconds"]), seconds)
    while True:
        with record_function("portbench.engine_step"):
            engine.step()
        now = time.perf_counter()
        with record_function("portbench.observe"):
            observe(now)
        if tracer is not None and not work.mark and now >= t_trace:
            work.mark = True
            tracer.start()
        if now >= t_end:
            break
    t_stop = now
    rec["in_window"] = False
    rec["open"] = False
    got = None
    if tracer is not None:
        work.mark = False
        got = tracer.stop()
    stats1 = copy.deepcopy(engine.stats)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    counted = ([], [], [], [])
    if work is not None:
        work.remove()
        counted = (work.decode, work.chunks, work.traced_decode, work.traced_chunks)
        del work   # its wrappers hold the engine, and the pool with it
    sample = check_serve.draw_sample(rec["finished"], spec.cell["check"], seed)
    del engine, inflight, clients
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"window: {t_stop - t_start:.3f} s, {rec['tokens']} tokens, "
        f"{len(rec['finished'])} requests finished, setup {setup_s:.3f} s")
    t_ref = time.perf_counter()
    checks = check_serve.check(d, seed, dev, sample, spec.cell, control=control)
    log(f"reference: {time.perf_counter() - t_ref:.3f} s")
    checks.append(("failed_requests", float(rec["failed"]), 0.0))
    return Obs(kind="serve", cfg=d, traffic=traffic, setup_s=setup_s,
               window_s=t_stop - t_start, tokens=rec["tokens"], itl_s=rec["itl"],
               ttft_s=rec["ttft"], finished=len(rec["finished"]),
               failed=rec["failed"], stats0=stats0, stats1=stats1,
               prompt_tokens_admitted=rec["admitted"],
               decode_calls=counted[0], prefill_chunks=counted[1],
               traced_decode_calls=counted[2], traced_prefill_chunks=counted[3],
               trace=got, memory_peak_bytes=int(peak), checks=checks,
               block_size=int(port["block_size"]))


class _Work:
    """Counts the work of the window's decode calls and prefill chunks by
    wrapping ``engine.graphs.launch`` and the model's chunked prefill (trace
    runs only); ``mark`` flags the calls inside the traced stretch."""

    def __init__(self, engine, model_lib) -> None:
        self.engine, self.model_lib = engine, model_lib
        self.decode: List[List[int]] = []
        self.chunks: List[tuple] = []
        self.traced_decode: List[List[int]] = []
        self.traced_chunks: List[tuple] = []
        self.mark = False
        self._launch = engine.graphs.launch
        self._chunk = model_lib.prefill_chunk_paged

        def launch(impl, H, *a, **k):
            pos = [s.pos for s in engine.slots if s.req is not None and not s.prefilling]
            self.decode.append(pos)
            if self.mark:
                self.traced_decode.append(pos)
            return self._launch(impl, H, *a, **k)

        def chunk(cfg, params, pool, bt_row, tokens, base, chunk_len, *a, **k):
            self.chunks.append((int(base), int(chunk_len)))
            if self.mark:
                self.traced_chunks.append((int(base), int(chunk_len)))
            return self._chunk(cfg, params, pool, bt_row, tokens, base, chunk_len, *a, **k)

        engine.graphs.launch = launch
        model_lib.prefill_chunk_paged = chunk

    def remove(self) -> None:
        self.engine.graphs.launch = self._launch
        self.model_lib.prefill_chunk_paged = self._chunk
