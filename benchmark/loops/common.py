"""What the loops share: the measured window, the log of each frame's
path lengths on the device, the reference's frame from a configuration,
and the faults the tests plant in the timed path."""

from __future__ import annotations

import importlib
import time

import torch

from benchmark import tracing
from benchmark.reference import pathtrace as pt

R_TILE = 128      # the program's default slot geometry: one pixel a slot
PIX_MUX = 1
TRACE_SECONDS = 4.0   # a traced run profiles this much of its window
CONTROL_DTYPE = torch.bfloat16   # the control: the reference one step
#                                # below the configurations' float32


def scene_module(config: dict):
    return importlib.import_module(
        f"benchmark.scenes.{config['scene']['kind']}")


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def frame(config: dict, spp: int) -> pt.Frame:
    if config["russian_roulette"]:
        raise ValueError("the reference traces no Russian roulette")
    return pt.Frame(width=config["width"], height=config["height"], spp=spp,
                    max_bounces=config["max_ray_bounces"],
                    env=config["environment_light"], eps=config["eps"])


def n_slots(config: dict) -> int:
    return pt.n_slots_for(config["width"] * config["height"], R_TILE,
                          PIX_MUX)


def camera(config: dict) -> tuple:
    """The camera row at yaw 0: position in float32, then cos and sin of
    both yaws."""
    return tuple(pt.f32(v) for v in config["camera"]) + (1.0, 0.0, 1.0, 0.0)


def draw_slots(rng, n: int, count: int, device) -> torch.Tensor:
    """``count`` distinct slots of the first ``n`` drawn from ``rng``, in
    order (all ``n`` for 0)."""
    if count <= 0 or count >= n:
        return torch.arange(n, device=device)
    return torch.tensor(sorted(rng.sample(range(n), count)),
                        dtype=torch.int64, device=device)


def check_pixels(pairs: int, n_tris: int, fr: pt.Frame) -> int:
    """Pixels the reference traces: as many as keep pixels x spp x
    triangles (its ray-triangle tests over a path's mean length) near
    ``pairs``; 0 (every pixel) where that covers the frame."""
    n = pairs // max(1, n_tris * fr.spp)
    return 0 if n >= fr.n_pix else max(1, n)


class SegmentLog:
    """Each frame's mean path length, kept on the device without a wait:
    one copy into a preallocated buffer a frame."""

    def __init__(self, device, capacity: int = 1 << 18):
        # 2^18 frames: a 51-second window at 0.2 ms a frame
        self.buf = torch.zeros((capacity,), dtype=torch.float64,
                               device=device)
        self.n = 0

    def add(self, value: torch.Tensor) -> None:
        self.buf[self.n].copy_(value)
        self.n += 1

    def values(self) -> list:
        return self.buf[:self.n].tolist()


class Window:
    """The measured window: ``open()`` before each answer says whether
    another may start (the first call starts the clock), ``answer(dt)``
    records one.  It lasts from the first answer's start to the last one's
    end.  A traced run profiles its first ``TRACE_SECONDS`` (or the whole
    window, if shorter) and marks the benchmark's spans in the trace."""

    def __init__(self, run):
        self.run = run
        self.start = self.end = None
        self.prof = self.mark = None

    def __enter__(self):
        return self

    def open(self) -> bool:
        now = time.perf_counter()
        run = self.run
        if self.start is None:
            if run.trace:
                self._trace_on()
            self.start = self.end = time.perf_counter()
            return True
        if self.prof is not None and (
                now >= self.start + TRACE_SECONDS
                or now >= self.start + run.seconds):
            self._trace_off()
        return now < self.start + run.seconds

    def answer(self, seconds: float) -> None:
        self.run.answer_s.append(seconds)
        self.end = time.perf_counter()

    def __exit__(self, *exc):
        if self.prof is not None:
            self._trace_off()
        self.run.window_s = self.end - self.start
        return False

    def _trace_on(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.device(self.run.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.mark = torch.profiler.record_function(tracing.WINDOW)
        self.mark.__enter__()
        self.run.spans.active = True

    def _trace_off(self):
        run = self.run
        run.spans.active = False
        run.traced_answers = run.answers
        synchronize(run.device)
        self.mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        path = run.workdir / "trace.json"
        self.prof.export_chrome_trace(str(path))
        self.prof = None
        run.trace_summary = tracing.read_trace(str(path))
        path.unlink()


class Sample:
    """``k`` answers drawn evenly from the whole window as it runs
    (reservoir sampling with the run's generator), and the last answer,
    which the check always takes too."""

    def __init__(self, rng, k: int):
        self.rng, self.k = rng, k
        self.drawn: list = []
        self.last = None
        self.n = 0

    def offer(self, answer) -> None:
        if self.n < self.k:
            self.drawn.append(answer)
        else:
            j = self.rng.randrange(self.n + 1)
            if j < self.k:
                self.drawn[j] = answer
        self.n += 1
        self.last = answer

    def kept(self) -> list:
        """The drawn answers, then the last if it was not drawn."""
        out = list(self.drawn)
        if self.last is not None and all(a is not self.last for a in out):
            out.append(self.last)
        return out


def judge(run, numbers: dict) -> list:
    """(name, value, limit) of each number compared, in order."""
    lim = run.traffic["limits"]
    return [(name, value, lim[name]) for name, value in numbers.items()]


# ---- planted faults (the tests) ---------------------------------------------

def faulty(fn, kind: str, run):
    """``fn`` as the run's faults break it (unchanged with none): see
    tests/test_bench_correctness.py.  ``late:<calls>:<fault>`` leaves the
    first ``calls`` calls sound (a fault that first shows late in the
    window)."""
    fault = run.extra.get("faults", {}).get(kind)
    if fault is None:
        return fn
    sound_calls = 0
    if fault.startswith("late:"):
        _, calls, fault = fault.split(":")
        sound_calls = int(calls)
    first = {"calls": 0}

    def render(*args, **kwargs):
        out = fn(*args, **kwargs)
        first["calls"] += 1
        if first["calls"] <= sound_calls:
            return out
        if kind == "learn":
            img, q, visits, aux = out
            q_in, v_in = args[4], args[5]
            if fault == "state_unchanged":
                return img, q_in.clone(), v_in.clone(), aux
            if fault == "half_batch":
                q, visits = q.clone(), visits.clone()
                q[:, ::2], visits[:, ::2] = q_in[:, ::2], v_in[:, ::2]
                return img, q, visits, aux
            if fault == "answer_altered":
                return img, q * (1.0 + 1e-2), visits, aux
            raise ValueError(fault)
        img, aux = out
        if fault == "state_unchanged":
            first.setdefault("out", (img, aux))
            return first["out"]
        if fault == "half_batch":
            img = img.clone()
            img[0::2] *= 2.0
            img[1::2] = 0.0
            return img, aux
        if fault == "answer_altered":
            return img * (1.0 + 1e-2), aux
        raise ValueError(fault)
    return render
