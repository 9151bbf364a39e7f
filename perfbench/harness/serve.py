"""Drive the port's engine under a traffic mix on the wall clock.

Set-up builds the kernels, draws the raw weights from the seed on the
device (the configuration's architecture module), prunes and packs them
with the port's ``sodify_params``, builds an
:class:`~repro_torch.serving.engine.Engine` with the mix's ``engine``
arguments, whole, and runs once every prefill bucket the mix can send and
the batched decode step (nothing builds or compiles later).  The mix's
kind module (``traffic/<kind>.py``) then does the set-up its traffic needs
and drives ``Engine.submit`` and ``Engine.step`` through the window, which
it opens and closes by :meth:`Served.open_window` and
:meth:`Served.in_window`.

The harness stamps every token on the host clock when the engine hands it
back: a first token when its fused admission returns (it reads the
prompt's argmax, which waits for the device), the others when ``step``
returns (the decode step reads its tokens back).  To tell the two apart
and to read rows and prompt lengths it wraps five of the engine object's
methods (admission, fused admission of one request, capacity, decode, the
pool's sample); the wrappers time and count, under ``--trace 1`` mark the
profiler's timeline, and change nothing the engine computes.  No file of
the program is changed.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from types import ModuleType
from typing import Any

import numpy as np
import torch

from perfbench.harness import traffic as traffic_mod

FAULTS = ("state", "half", "token")
_ACTIVITIES = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Track:
    """One request as its client sees it."""

    req: traffic_mod.Req
    prompt: np.ndarray
    sent: float
    times: list = dataclasses.field(default_factory=list)
    toks: list = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.toks) >= self.req.max_new


class Served:
    """Set-up and window of one run: the port's engine on the cell's model,
    driven by the mix's kind module."""

    def __init__(self, cfg: dict, mix: dict, seed: int, seconds: float,
                 device: torch.device, t_proc0: float, *, arch: ModuleType,
                 kind: ModuleType, faults: tuple = ()):
        from repro_torch.core.sod import sodify_params
        from repro_torch.kernels import build
        from repro_torch.models.model import LM
        from repro_torch.serving.engine import Engine

        self.split: dict[str, float] = {"import_s": time.perf_counter() - t_proc0}
        self.cfg, self.mix, self.seed, self.seconds = cfg, mix, int(seed), float(seconds)
        self.device, self.t_proc0, self.faults = device, t_proc0, tuple(faults)
        self.kind = kind
        self.vocab = int(cfg["vocab_size"])
        t = time.perf_counter()
        if device.type == "cuda":
            build.build_all()
        t = self._lap("build_s", t)
        raw = arch.draw_params(cfg, self.seed, device)
        t = self._lap("weights_s", t)
        self.model = LM(arch.port_config(cfg))
        self.params = sodify_params(raw, self.model.cfg.sod)
        del raw
        gc.collect()
        t = self._lap("pack_s", t)
        self.engine = Engine(self.model, self.params, **mix["engine"])
        self.plan = kind.Plan(mix, self.seed, self.seconds, self.vocab)
        self._wrap()
        t = self._lap("engine_s", t)
        self._warm()
        self._lap("warm_s", t)
        self.tracks: dict[int, Track] = {}
        self.steps: list[dict] = []
        self.prof = None
        self._step_rec: dict | None = None
        self._profiling = False
        self._trace = False

    def _lap(self, key: str, t: float) -> float:
        sync(self.device)
        now = time.perf_counter()
        self.split[key] = now - t
        return now

    # -- the engine's wrapped methods ---------------------------------------
    def mark(self, name: str):
        """A profiler range ``name`` while the traced sub-window runs."""
        if self._profiling:
            return torch.profiler.record_function(name)
        return _NULL

    def _wrap(self) -> None:
        eng = self.engine
        admission, admit, capacity = eng._phase_admission, eng._admit_paged, eng._phase_capacity
        decode_phase, sample_pool, decode = eng._phase_decode, eng._sample_pool, eng._decode

        def phase_admission(now):
            t0 = time.perf_counter()
            with self.mark("pb:admission"):
                events = admission(now)
            rec = self._step_rec
            rec["adm_s"] = time.perf_counter() - t0
            rec["adm_events"] = len(events)
            return events

        def admit_paged(req):
            with self.mark(f"pb:prefill:{len(req.tokens)}"):
                out = admit(req)
            rec = self._step_rec
            rec["prompts"].append(len(req.tokens))
            rec["first_t"][req.rid] = time.perf_counter()
            return out

        def phase_capacity():
            with self.mark("pb:capacity"):
                return capacity()

        def phase_decode(decoding):
            self._step_rec["rows"] = len(decoding)
            with self.mark(f"pb:decode:{len(decoding)}"):
                return decode_phase(decoding)

        def pool_sample():
            with self.mark("pb:pool"):
                return sample_pool()

        eng._phase_admission, eng._admit_paged = phase_admission, admit_paged
        eng._phase_capacity, eng._phase_decode = phase_capacity, phase_decode
        eng._sample_pool = pool_sample
        if self.faults:
            eng._decode = _faulty(decode, eng, self.faults, self.vocab)

    # -- set-up ---------------------------------------------------------------
    def _warm(self) -> None:
        """Run every prefill bucket the mix can send (with its page write
        to the trash page) and the batched decode step once; an engine
        with chunked prefill runs its own warm-up, whose one chunk shape
        serves every prompt."""
        from repro_torch.serving import engine as engine_mod
        from repro_torch.serving.pool import PagePool

        eng = self.engine
        if eng.prefill_chunk:
            eng.warmup()
            self.split["warm_buckets"] = 1
            return
        buckets = sorted({eng._bucket(n) for n in self.plan.prompt_lengths()})
        for b in buckets:
            logits, cache = eng._prefill(eng.params, eng._up(np.zeros((1, b))))
            int(logits[0, b - 1].argmax())
            trash = np.full(b // eng.page_size, PagePool.TRASH_PAGE)
            engine_mod._pool_write_pages(eng.pool, cache, eng._up(trash))
            del logits, cache
        inputs = eng._decode_inputs(np.zeros(eng.max_slots, np.int64))
        nxt, _, _ = eng._decode(eng.params, eng.pool, *inputs)
        nxt.cpu()
        self.split["warm_buckets"] = len(buckets)

    # -- what a kind module drives ----------------------------------------------
    def send(self, req: traffic_mod.Req) -> None:
        """Submit ``req`` to the engine now."""
        from repro_torch.serving.scheduler import Request

        prompt = self.plan.tokens(req)
        self.tracks[req.idx] = Track(req, prompt, time.perf_counter())
        self.engine.submit(Request(req.idx, prompt, req.max_new,
                                   arrival=self.engine._step_idx))

    def step(self) -> list[int]:
        """One engine step; stamps its tokens; returns requests it completed."""
        rec = {"t0": time.perf_counter(), "rows": 0, "prompts": [], "adm_s": 0.0,
               "adm_events": 0, "first_t": {}, "profiled": self._profiling}
        self._step_rec = rec
        with self.mark("pb:step"):
            events = self.engine.step()
        rec["t1"] = t1 = time.perf_counter()
        self.steps.append(rec)
        done = []
        for i, (rid, tok) in enumerate(events):
            tr = self.tracks[rid]
            # a fused admission's first token when it returned; any other
            # token (a chunked prefill's first too) when the step did
            tr.times.append(rec["first_t"].get(rid, t1) if i < rec["adm_events"] else t1)
            tr.toks.append(int(tok))
            if tr.done:
                done.append(rid)
        return done

    def open_window(self) -> None:
        """The window starts now: set-up ends, and the memory peak counts
        from here."""
        self.t_start = time.perf_counter()
        self.split["setup_s"] = self.t_start - self.t_proc0
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.t_end = self.t_start + self.seconds
        prof = self.mix["profile"]
        self._prof_at = self.t_start + prof["start"] * self.seconds
        self._prof_seconds = prof["seconds"]

    def in_window(self) -> bool:
        """Whether the window is still open; starts and stops the traced
        sub-window on the way."""
        now = time.perf_counter()
        if self._profiling and now >= self._prof_until:
            self._stop_profile()
        if now >= self.t_end:
            return False
        if self._trace and self.prof is None and now >= self._prof_at:
            self.prof = torch.profiler.profile(activities=_ACTIVITIES)
            self.prof.start()
            self._profiling = True
            self._window_rf = torch.profiler.record_function("pb:window")
            self._window_rf.__enter__()
            self._prof_until = time.perf_counter() + self._prof_seconds
        return True

    def _stop_profile(self) -> None:
        sync(self.device)
        self._window_rf.__exit__(None, None, None)
        self.prof.stop()
        self._profiling = False

    # -- the run ------------------------------------------------------------------
    def run(self, trace: bool = False) -> dict:
        """The kind module's set-up and window.  Returns the window's times
        and the device's memory peak in it."""
        self._trace = trace
        if trace:       # the profiler's own start-up, before the window
            with torch.profiler.profile(activities=_ACTIVITIES):
                torch.zeros(1, device=self.device).add_(1)
        self.kind.drive(self)
        t_last = time.perf_counter()
        if self._profiling:                       # the window ended first
            self._stop_profile()
        mem = (torch.cuda.max_memory_allocated(self.device)
               if self.device.type == "cuda" else 0)
        return {"t_start": self.t_start, "t_end": t_last, "window_s": t_last - self.t_start,
                "memory_peak_bytes": int(mem)}

    def free(self) -> None:
        """Drop the program's state (engine, packed weights, pool)."""
        self.engine = self.params = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _faulty(decode, eng, faults: tuple, vocab: int):
    """The engine's decode step with planted faults, for the check's own
    tests: ``state`` loses the step's cache writes (the step returns its
    state unchanged), ``half`` gives the second half of the slots the first
    half's tokens (half the batch left out), ``token`` alters every row's
    token on every seventh step."""
    unknown = set(faults) - set(FAULTS)
    if unknown:
        raise ValueError(f"unknown faults {sorted(unknown)}")
    calls = [0]

    def run(params, pool, *args):
        saved = {n: pool[n].clone() for n in ("k", "v")} if "state" in faults else None
        nxt, logits, pool = decode(params, pool, *args)
        if saved is not None:
            for n in ("k", "v"):
                pool[n].copy_(saved[n])
        if "half" in faults:
            b = nxt.shape[0] // 2
            nxt = torch.cat([nxt[:b], nxt[:nxt.shape[0] - b]])
        calls[0] += 1
        if "token" in faults and calls[0] % 7 == 0:
            nxt = (nxt + 1) % vocab
        return nxt, logits, pool

    return run


def window_view(served: Served, win: dict) -> dict[str, Any]:
    """What the metrics read of a run: its steps, and every token stamped
    in the window, with the request it belongs to."""
    t0, t1 = win["t_start"], win["t_end"]
    return {"t_start": t0, "t_end": t1, "window_s": t1 - t0,
            "steps": [s for s in served.steps if t0 <= s["t0"] < t1],
            "tracks": list(served.tracks.values())}
